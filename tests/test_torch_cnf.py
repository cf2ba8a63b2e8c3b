r"""Parity of the port's continuous normalizing flow (``zuko_tpu_torch.flows.CNF``
and what it is built from: ``utils.odeint``, ``FreeFormJacobianTransform``,
the fused CNF tier ``ops/cnf_fused.py``) with ``zuko_tpu`` on the CPU.

Both packages build the same model: ``zuko_tpu`` from a PRNG key, the port
from its ``zuko_tpu.serial.save_params`` checkpoint through ``load_params``.
Inputs, base draws and Hutchinson probes are made with numpy (or from
``zuko_tpu``'s key) and handed to both. Everything runs in float64 on the
CPU, where the port's kernel wrappers take their plain versions and
``zuko_tpu``'s fused entry points their jnp math (the global-step
integration).

The fused density and sampling control their steps per tile of ``TILE``
rows, as the kernels do; at 256 rows or fewer one tile holds the batch and
they equal the global-step integration to roundoff. Several tiles are held
against ``zuko_tpu``'s own tile math, one tile at a time.
"""

import functools
import io

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zuko_tpu
import zuko_tpu_torch as zt

from zuko_tpu import utils as jax_utils
from zuko_tpu.core import combine, named_parameters, partition
from zuko_tpu.ops import cnf_fused as jax_cnf
from zuko_tpu.parallel import train as jax_train
from zuko_tpu.serial import save_params
from zuko_tpu_torch.distributions import NormalizingFlow
from zuko_tpu_torch.ops import cnf_fused as torch_cnf
from zuko_tpu_torch.ops.dispatch import FusedContinuousFlow
from zuko_tpu_torch.ops.nsf_fused import FusedStructureError
from zuko_tpu_torch.parallel import make_mle_step, make_reverse_kl_step
from zuko_tpu_torch.serial import load_params, to_torch_name

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ASSETS = ROOT / "zuko_tpu_torch" / "assets"


@pytest.fixture(autouse=True)
def _leave_torch_globals_as_found():
    """Other tests of the suite draw from torch's global generator unseeded
    and set its default dtype: run on float32 defaults, and hand both back
    as they were."""
    dtype = torch.get_default_dtype()
    torch.set_default_dtype(torch.float32)
    with torch.random.fork_rng(devices=[]):
        yield
    torch.set_default_dtype(dtype)


def _dispatch(monkeypatch, fused):
    monkeypatch.setenv("ZUKO_TPU_FUSED_DISPATCH", "1" if fused else "0")
    monkeypatch.setenv("ZUKO_TPU_TORCH_FUSED_DISPATCH", "1" if fused else "0")


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def _carry(jmodule, tmodule):
    """``jmodule``'s arrays into ``tmodule`` through the checkpoint format."""
    buffer = io.BytesIO()
    save_params(buffer, jmodule)
    buffer.seek(0)
    with np.load(buffer) as data:
        return load_params(tmodule.double(), {k: data[k] for k in data.files})


# name -> (features, context, keyword arguments of both constructors)
CASES = {
    "cnf": (3, 0, {}),
    "cnf_context": (3, 2, {"hidden_features": (16, 16)}),
    "cnf_hutchinson": (3, 2, {"hidden_features": (16, 16), "exact": False}),
    "cnf_hutchinson_plain": (3, 0, {"hidden_features": (16, 16), "exact": False}),
    # a context's gradient differs between the two adjoints at solver
    # tolerance: held at tolerances tight enough for 1e-5
    "cnf_context_tight": (3, 2, {"hidden_features": (8, 8), "atol": 1e-8, "rtol": 1e-8,
                                 "max_steps": 16384}),
}
_PAIRS = {}


def _build(name, key=0):
    """The same CNF in both packages, the port's in float64 on the CPU."""
    F, C, kwargs = CASES[name]
    jflow = _f64(zuko_tpu.flows.CNF(F, C, key=jax.random.PRNGKey(key), **kwargs))
    tflow = _carry(jflow, zt.CNF(F, C, device="cpu", **kwargs))
    return jflow, tflow


def _pair(name):
    """:func:`_build`, once per name: tests that train use their own."""
    if name not in _PAIRS:
        _PAIRS[name] = _build(name)
    return (*_PAIRS[name], *CASES[name][:2])


def _context(name, batched, seed=3, rows=6):
    """``(jax context, torch context)``: ``None``, one vector, or ``rows``
    of them."""
    C = CASES[name][1]
    if not C:
        return None, None
    c = np.random.default_rng(seed).standard_normal((rows, C) if batched else (C,))
    return jnp.asarray(c), torch.as_tensor(c)


def _tile_fn(name, cfg, *statics):
    """``zuko_tpu``'s tile function ``jax_cnf.<name>`` under ``jax.jit``,
    ``cfg`` and the trailing arguments ``statics`` fixed: traced once per
    configuration and shape, and shared by the tiles and the cases."""
    return _jit_tile_fn(name, tuple(sorted(cfg.items())), statics)


@functools.lru_cache(maxsize=None)
def _jit_tile_fn(name, cfg_items, statics):
    fn, cfg = getattr(jax_cnf, name), dict(cfg_items)
    return jax.jit(lambda *arrays: fn(*arrays, cfg, *statics))


def _grads_by_name(jgrads, tflow):
    want = {to_torch_name(k): np.asarray(g) for k, g in named_parameters(jgrads)}
    got = {k: p.grad.numpy() for k, p in tflow.named_parameters()}
    assert sorted(got) == sorted(want)
    return got, want


def _close(got, want, tol):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


# ------------------------------------------------------------------- odeint


def _jdyn(t, x, phi):
    return jnp.tanh(x @ phi[0].T + phi[1] * jnp.sin(3 * t))


def _tdyn(t, x, phi):
    return torch.tanh(x @ phi[0].T + phi[1] * torch.sin(3 * t))


@pytest.mark.parametrize("case", ["forward", "reverse", "tuple"])
def test_odeint_matches_zuko_tpu(case):
    """Dormand-Prince with the same step control on both sides: the value
    and the gradients to ``x0`` and to every tensor of ``phi`` (the discrete
    adjoint over the accepted steps), from ``t0`` to ``t1``, backwards
    (``t1 < t0``), and for a tuple state: 1e-10."""
    rng = np.random.default_rng(0)
    x0, W, b = rng.standard_normal((4, 3)), rng.standard_normal((3, 3)), rng.standard_normal(3)
    g = rng.standard_normal((4, 3))
    t0, t1 = (1.0, -0.5) if case == "reverse" else (0.0, 1.5)
    if case == "tuple":
        def jf(t, s, phi):
            return _jdyn(t, s[0], phi), jnp.sum(s[0] ** 2, axis=-1) * phi[1][0]

        def tf(t, s, phi):
            return _tdyn(t, s[0], phi), (s[0] ** 2).sum(dim=-1) * phi[1][0]

        def jloss(x, phi):
            y, z = jax_utils.odeint(jf, (x, jnp.zeros(4)), t0, t1, phi)
            return jnp.sum(y * g) + jnp.sum(z)
    else:
        jf, tf = _jdyn, _tdyn

        def jloss(x, phi):
            return jnp.sum(jax_utils.odeint(jf, x, t0, t1, phi) * g)

    jphi = (jnp.asarray(W), jnp.asarray(b))
    value = jloss(jnp.asarray(x0), jphi)
    jgx, jgphi = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x0), jphi)
    tx, tW, tb = (torch.tensor(v, requires_grad=True) for v in (x0, W, b))
    if case == "tuple":
        y, z = zt.utils.odeint(tf, (tx, torch.zeros(4, dtype=torch.float64)), t0, t1, (tW, tb))
        loss = (y * torch.as_tensor(g)).sum() + z.sum()
    else:
        loss = (zt.utils.odeint(tf, tx, t0, t1, (tW, tb)) * torch.as_tensor(g)).sum()
    loss.backward()
    _close(loss, value, 1e-10)
    for got, want in ((tx.grad, jgx), (tW.grad, jgphi[0]), (tb.grad, jgphi[1])):
        _close(got, want, 1e-10)


def test_odeint_budget_exhaustion_is_nan():
    """Too few accepted steps for the interval: NaN on both sides, not a
    state cut short."""
    x0 = np.random.default_rng(1).standard_normal(3)
    want = jax_utils.odeint(lambda t, x: -8 * x, jnp.asarray(x0), 0.0, 4.0, max_steps=3)
    got = zt.utils.odeint(lambda t, x: -8 * x, torch.as_tensor(x0), 0.0, 4.0, max_steps=3)
    assert np.isnan(np.asarray(want)).all() and torch.isnan(got).all()
    ok = zt.utils.odeint(lambda t, x: -8 * x, torch.as_tensor(x0), 0.0, 4.0, max_steps=256)
    np.testing.assert_allclose(ok.numpy(), x0 * np.exp(-32), rtol=0, atol=1e-5)


# --------------------------------------------------------------- transform


@pytest.mark.parametrize("name", ["cnf_context", "cnf_hutchinson"])
def test_free_form_jacobian_transform_matches_zuko_tpu(name):
    """A built ``FreeFormJacobianTransform``: ``call_and_ladj`` (exact, or
    Hutchinson with ``zuko_tpu``'s probe from its key fed to the port),
    ``inverse`` and ``inverse_and_ladj`` through ``inv``: 1e-10."""
    jflow, tflow, F, C = _pair(name)
    jc, tc = _context(name, False)
    x = np.random.default_rng(5).standard_normal((7, F))
    key = jax.random.PRNGKey(3)
    jt = jflow.transform(jc, key=key)
    tt = tflow.transform(tc, generator=torch.Generator().manual_seed(0))
    eps = np.array(jax.random.normal(key, x.shape, jnp.float64))
    jy, jl = jt.call_and_ladj(jnp.asarray(x))
    with torch.no_grad():
        ty, tl = tt.augmented(torch.as_tensor(x), torch.as_tensor(eps))
        _close(ty, jy, 1e-10)
        _close(tl, jl, 1e-10)
        _close(tt.inverse(torch.as_tensor(x)), jt.inverse(jnp.asarray(x)), 1e-10)
        jxi, jli = jt.inv.call_and_ladj(jnp.asarray(x))
        txi, tli = tt.inv.augmented(torch.as_tensor(x), torch.as_tensor(eps))
        _close(txi, jxi, 1e-10)
        _close(tli, jli, 1e-10)


# -------------------------------------------------------------- unfused flow


@pytest.mark.parametrize("fused_rsample", [False, True], ids=["unfused", "fused_flow"])
def test_unfused_flow_matches_zuko_tpu(fused_rsample, monkeypatch):
    """The unfused CNF, dispatch off on both sides: ``log_prob`` and the
    sample of a fixed ``z`` to 1e-8, and the gradients of ``rsample`` (the
    discrete adjoint of ``odeint``) to every parameter and to the context,
    1e-8. With ``fused_flow`` dispatch is on on both sides: the port's
    ``FusedContinuousFlow.rsample`` and ``zuko_tpu``'s ``fused_cnf_rsample``
    (the base draws ``zuko_tpu`` makes from its key, handed to the port), both
    the continuous adjoint, for the CNF without a context: the same
    tolerances. (With a context the two adjoints' step controllers watch
    different leaves, the context's gradient in ``zuko_tpu``'s CPU backend and
    the folded first bias's in the tile adjoint, so they agree to solver
    tolerance only: ``test_rsample_gradients_match_zuko_tpu``.)"""
    name = "cnf" if fused_rsample else "cnf_context"
    jflow, tflow, F, C = _pair(name)
    jc, tc = _context(name, True)
    rng = np.random.default_rng(9)
    x, w = rng.standard_normal((6, F)), rng.standard_normal((6, F))
    generator = torch.Generator().manual_seed(4)
    key = jax.random.PRNGKey(4)
    params, static = partition(jflow)
    _dispatch(monkeypatch, fused_rsample)
    if fused_rsample:
        jdist = jflow(jc)
        z = np.asarray(jax_cnf._prep_cnf_sample(jflow, jdist.transform, key, (6,), jc, False)[1])
        monkeypatch.setattr(torch, "randn", lambda shape, **kw: torch.tensor(z).reshape(shape))

        def jloss(p, c_):
            return jnp.sum(combine(p, static)(c_).rsample(key, (6,)) * w)
    else:
        z = torch.randn((6, F), generator=torch.Generator().manual_seed(4),
                        dtype=torch.float64).numpy()

        def jloss(p, c_):
            return jnp.sum(combine(p, static)(c_).transform.inv(jnp.asarray(z)) * w)

    jgrads = jax.jit(jax.grad(jloss, argnums=(0, 1) if C else 0))(params, jc)
    jgrads = jgrads if C else (jgrads,)
    _dispatch(monkeypatch, False)
    jdist = jflow(jc)
    _dispatch(monkeypatch, fused_rsample)
    tflow.zero_grad()
    tcg = None if tc is None else tc.clone().requires_grad_(True)
    tdist = tflow(tcg)
    assert type(tdist) is (FusedContinuousFlow if fused_rsample else NormalizingFlow)
    sample = tdist.rsample((6,) if tc is None else (), generator=generator)
    (sample * torch.as_tensor(w)).sum().backward()
    jsample, jlp = jax.jit(lambda z_, x_: (jdist.transform.inv(z_), jdist.log_prob(x_)))(
        jnp.asarray(z), jnp.asarray(x))
    _close(sample, jsample, 1e-8)
    _dispatch(monkeypatch, False)
    with torch.no_grad():
        _close(tflow(tc).log_prob(torch.as_tensor(x)), jlp, 1e-8)
    if C:
        _close(tcg.grad, jgrads[1], 1e-8)
    got, want = _grads_by_name(jgrads[0], tflow)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-8, atol=1e-8, err_msg=k)


# ---------------------------------------------------------- the fused tier


DENSITY_CASES = {
    "plain": ("cnf", False, (12, 3)),
    "one_context": ("cnf_context", False, (12, 3)),
    "batched_context": ("cnf_context", True, (6, 3)),
}


@pytest.mark.parametrize("case", list(DENSITY_CASES))
def test_fused_density_and_gradients_match_zuko_tpu(case, monkeypatch):
    """``flow(c).log_prob(x)`` through ``FusedContinuousFlow`` (one tile:
    the plain version of ``cnf_density``) against ``zuko_tpu``'s fused CPU
    path (``_ref_log_prob``): 1e-10; the gradients of a weighted sum to
    ``x``, the context and every parameter (autograd over the global-step
    integration against ``_cnf_bwd``): 1e-8."""
    name, batched, shape = DENSITY_CASES[case]
    jflow, tflow, F, C = _pair(name)
    jc, tc = _context(name, batched)
    x = np.random.default_rng(6).standard_normal(shape)
    w = np.random.default_rng(8).standard_normal(shape[:-1])
    params, static = partition(jflow)

    def jloss(p, x_, c_):
        return jnp.sum(combine(p, static)(c_).log_prob(x_) * w)

    _dispatch(monkeypatch, True)
    jdist = jflow(jc)
    assert type(jdist).__name__ == "FusedContinuousFlow"
    argnums = (0, 1, 2) if C else (0, 1)
    # zuko_tpu's density and its gradients, traced once under jax.jit
    expected, jgrads = jax.jit(lambda p, x_, c_: (
        combine(p, static)(c_).log_prob(x_), jax.grad(jloss, argnums=argnums)(p, x_, c_)))(
            params, jnp.asarray(x), jc)
    tflow.zero_grad()
    tx = torch.tensor(x, requires_grad=True)
    tcg = None if tc is None else tc.clone().requires_grad_(True)
    tdist = tflow(tcg)
    assert type(tdist) is FusedContinuousFlow
    lp = tdist.log_prob(tx)
    _close(lp, expected, 1e-10)
    (lp * torch.as_tensor(w)).sum().backward()
    _close(tx.grad, jgrads[1], 1e-8)
    if C:
        _close(tcg.grad, jgrads[2], 1e-8)
    got, want = _grads_by_name(jgrads[0], tflow)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-8, atol=1e-8, err_msg=k)
    assert any(np.abs(g).max() > 0 for g in got.values())


@pytest.mark.parametrize("case", ["plain", "batched_context"])
def test_fused_sampling_matches_zuko_tpu(case, monkeypatch):
    """``sample`` and ``sample_and_log_prob`` through ``FusedContinuousFlow``
    from the base draws ``zuko_tpu`` makes from its key, against its fused
    CPU path (``_ref_sample``): samples and log q to 1e-10."""
    name = "cnf" if case == "plain" else "cnf_context"
    jflow, tflow, F, C = _pair(name)
    jc, tc = _context(name, case == "batched_context", rows=3)
    key, shape = jax.random.PRNGKey(4), (4,)
    _dispatch(monkeypatch, True)
    jdist = jflow(jc)
    jx = jdist.sample(key, shape)
    jxl, jlq = jdist.sample_and_log_prob(key, shape)
    z = np.asarray(jax_cnf._prep_cnf_sample(jflow, jdist.transform, key, shape, jc, False)[1])
    monkeypatch.setattr(torch, "randn", lambda shape, **kw: torch.tensor(z).reshape(shape))
    tdist = tflow(tc)
    tx = tdist.sample(shape)
    txl, tlq = tdist.sample_and_log_prob(shape)
    assert tx.shape == tuple(jx.shape) and tlq.shape == tuple(jlq.shape)
    for got, want in ((tx, jx), (txl, jxl), (tlq, jlq)):
        _close(got, want, 1e-10)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "hutchinson"])
def test_ops_take_the_probe_and_match_zuko_tpu(exact):
    """``cnf_density`` and ``cnf_sample`` with an explicit Hutchinson probe
    (or none) and a context of rows, against ``zuko_tpu``'s ``_cnf_op`` and
    ``_cnf_sample_impl`` on the CPU with the same probe: 1e-10."""
    jflow, tflow, F, C = _pair("cnf_context" if exact else "cnf_hutchinson")
    rng = np.random.default_rng(11)
    x, eps, c = rng.standard_normal((9, F)), rng.standard_normal((9, F)), \
        rng.standard_normal((9, C))
    key = jax.random.PRNGKey(0)
    jt = jflow.transform(jnp.asarray(c), key=key)
    ws, bs, jc, _, cfg = jax_cnf.extract_cnf_params(jflow, jt, jnp.asarray(c))
    flat = [p for pair in zip(ws, bs) for p in pair]
    je = jnp.asarray(eps)
    jlp = jax_cnf._cnf_op(jax_cnf._StaticCfg(cfg), jnp.asarray(x), je, jc, *flat)
    tt = tflow.transform(torch.as_tensor(c), generator=torch.Generator().manual_seed(0))
    params, _, tcfg = torch_cnf._flatten_cnf(tflow, tt, torch.as_tensor(c))
    te = torch.as_tensor(eps)
    with torch.no_grad():
        _close(torch_cnf.cnf_density(torch.as_tensor(x), te, params, torch.as_tensor(c), tcfg),
               jlp, 1e-10)
        for want_lq in (False, True):
            static = jax_cnf._StaticCfg({**cfg, "want_lp": want_lq})
            want = jax_cnf._cnf_sample_impl(static, jnp.asarray(x), je, jc, *flat)
            got = torch_cnf.cnf_sample(torch.as_tensor(x), te, params, torch.as_tensor(c), tcfg,
                                       want_lq)
            for a, b in zip(*((got, want) if want_lq else ((got,), (want,)))):
                _close(a, b, 1e-10)


@pytest.mark.parametrize("rows", [24, 21], ids=["whole_tiles", "ragged_tile"])
@pytest.mark.parametrize("name", ["cnf_context", "cnf_hutchinson"])
def test_tiles_match_zuko_tpus_tile_math(name, rows):
    """The plain versions at ``tile=8`` over several tiles, each tile with
    its own steps, against ``zuko_tpu``'s ``_cnf_tile_math`` and
    ``_cnf_tile_sample_math`` (the TPU kernel's math) on each 8-row slice,
    a context of rows folded into per-row first biases; the ragged last tile
    (5 rows) against the same functions on its 5 rows, which is what the
    port's tile of 8 with 3 rows past the end computes: 1e-10."""
    jflow, tflow, F, C = _pair(name)
    rng = np.random.default_rng(12)
    x, eps, c = (rng.standard_normal((rows, k)) for k in (F, F, C))
    jt = jflow.transform(jnp.asarray(c), key=jax.random.PRNGKey(0))
    ws, bs, jc, _, cfg = jax_cnf.extract_cnf_params(jflow, jt, jnp.asarray(c))
    kp = jax_cnf._kernel_params(ws, bs, jc, cfg)
    tt = tflow.transform(torch.as_tensor(c), generator=torch.Generator().manual_seed(0))
    params, _, tcfg = torch_cnf._flatten_cnf(tflow, tt, torch.as_tensor(c))
    tkp = torch_cnf._kernel_params(params[0::2], params[1::2], torch.as_tensor(c), tcfg)
    tx, te = torch.as_tensor(x), torch.as_tensor(eps)
    with torch.no_grad():
        lp, attempts = torch_cnf._cnf_tile_math(tx, te, tkp, tcfg, tile=8, counts=True)
        xs = torch_cnf._cnf_tile_sample_math(tx, te, tkp, tcfg, False, tile=8)
        xl, lq = torch_cnf._cnf_tile_sample_math(tx, te, tkp, tcfg, True, tile=8)
    assert attempts.shape == (3,) and bool((attempts > 0).all())
    for lo in range(0, rows, 8):
        rs = slice(lo, min(lo + 8, rows))
        tile = [kp[0], kp[1], kp[2][rs].T, *kp[3:]]
        xT, eT = jnp.asarray(x[rs].T), jnp.asarray(eps[rs].T)
        _close(lp[rs], _tile_fn("_cnf_tile_math", cfg)(xT, eT, tile)[0], 1e-10)
        _close(xs[rs], _tile_fn("_cnf_tile_sample_math", cfg, False)(xT, eT, tile).T, 1e-10)
        jxl, jlq = _tile_fn("_cnf_tile_sample_math", cfg, True)(xT, eT, tile)
        _close(xl[rs], jxl.T, 1e-10)
        _close(lq[rs], jlq[0], 1e-10)


# ---------------------------------------------------------------- training


def _assert_same_parameters(tflow, jparams, atol):
    expected = {to_torch_name(k): np.asarray(v) for k, v in named_parameters(jparams)}
    got = dict(tflow.named_parameters())
    assert sorted(got) == sorted(expected)
    for k, p in got.items():
        np.testing.assert_allclose(p.detach().numpy(), expected[k], rtol=0, atol=atol, err_msg=k)


def test_mle_steps_match_zuko_tpu(monkeypatch):
    """One Adam step of maximum likelihood, then a second on the same batch,
    fused on both sides (the density kernel's plain version forward, the
    global-step integration's gradients backward): the loss to 1e-10 and
    every updated parameter to 1e-8 after each step."""
    jflow, tflow = _build("cnf_context")
    jc, tc = _context("cnf_context", True, rows=16)
    x = np.random.default_rng(10).standard_normal((16, 3))
    params, static = partition(jflow)
    _dispatch(monkeypatch, True)
    jinit, jstep = jax_train.make_mle_step(static, lr=1e-3)
    jstate = jinit(params)
    tinit, tstep = make_mle_step(tflow, lr=1e-3)
    tstate = tinit()
    assert isinstance(tflow(tc), FusedContinuousFlow)
    for step in range(2):
        jstate, jloss = jstep(jstate, jnp.asarray(x), jc)
        tstate, tloss = tstep(tstate, torch.as_tensor(x), tc)
        assert tstate.step == step + 1
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-10, atol=1e-10)
        _assert_same_parameters(tflow, jstate.params, atol=1e-8)


# ------------------------------------------------------------ the adjoint


ADJOINT_CASES = {
    "exact": ("cnf", False),
    "one_context": ("cnf_context", False),
    "batched_context": ("cnf_context", True),
    "hutchinson": ("cnf_hutchinson", True),
}


@pytest.mark.parametrize("case", list(ADJOINT_CASES))
def test_plain_adjoint_matches_zuko_tpus_tile_adjoint(case):
    """The plain version of the adjoint kernel at ``tile=8`` over 21 rows
    (tiles of 8, 8 and a ragged 5, each with its own steps) against
    ``zuko_tpu``'s ``_cnf_tile_adjoint`` (the TPU kernel's math) on each
    slice, with the log-q cotangent: ``u1``, ``a1`` and every parameter
    cotangent (per tile; a context of rows as per-row first biases) to
    1e-10."""
    name, batched = ADJOINT_CASES[case]
    jflow, tflow, F, C = _pair(name)
    rows = 21
    rng = np.random.default_rng(13)
    x, a, eps = (rng.standard_normal((rows, F)) for _ in range(3))
    a, glq = a / rows, rng.standard_normal(rows) / rows
    c = None if not C else rng.standard_normal((rows, C) if batched else (C,))
    jc = None if c is None else jnp.asarray(c)
    tcv = None if c is None else torch.as_tensor(c)
    jt = jflow.transform(jc, key=jax.random.PRNGKey(0))
    ws, bs, jcp, _, cfg = jax_cnf.extract_cnf_params(jflow, jt, jc)
    kp = jax_cnf._kernel_params(ws, bs, jcp, cfg)
    tt = tflow.transform(tcv, generator=torch.Generator().manual_seed(0))
    params, _, tcfg = torch_cnf._flatten_cnf(tflow, tt, tcv)
    tkp = [p.detach() for p in torch_cnf._kernel_params(params[0::2], params[1::2], tcv, tcfg)]
    eps_t = None if tcfg["exact"] else torch.as_tensor(eps)
    u1, a1, gth, attempts = torch_cnf._cnf_tile_adjoint_math(
        torch.as_tensor(x), torch.as_tensor(a), torch.as_tensor(glq), eps_t, tkp, tcfg, tile=8,
        counts=True)
    assert attempts.shape == (3,) and bool((attempts > 0).all())
    for i, lo in enumerate(range(0, rows, 8)):
        rs = slice(lo, min(lo + 8, rows))
        tile = [kp[0], kp[1], kp[2][rs].T if batched else kp[2], *kp[3:]]
        ju, ja, jg = _tile_fn("_cnf_tile_adjoint", cfg, True)(
            jnp.asarray(x[rs].T), jnp.asarray(a[rs].T), jnp.asarray(glq[rs])[None, :],
            None if tcfg["exact"] else jnp.asarray(eps[rs].T), tile)
        _close(u1[rs], np.asarray(ju).T, 1e-10)
        _close(a1[rs], np.asarray(ja).T, 1e-10)
        for j, (got, want) in enumerate(zip(gth, jg)):
            if j == 2 and batched:
                _close(got[rs], np.asarray(want).T, 1e-10)
            else:
                _close(got[i], np.asarray(want).reshape(got[i].shape), 1e-10)


@pytest.mark.parametrize("F", [1, 3])
@pytest.mark.parametrize("row_bias", [False, True], ids=["shared_bias", "row_bias"])
@pytest.mark.parametrize("depth", [0, 1, 2, 3])
@pytest.mark.parametrize("trace", [None, True, False], ids=["no_trace", "exact", "hutchinson"])
def test_tile_vjp_matches_autograd(trace, depth, row_bias, F):
    """``_tile_f_vjp``, the plain adjoint's slopes: its ``f`` is
    ``_tile_f_and_tr``'s bit for bit, and its hand-written vector-Jacobian
    product of ``sum(fbar f) + sum(trbar tr)`` equals autograd over
    ``_tile_f_and_tr`` tile by tile (each parameter's cotangent summed over
    that tile's rows, a per-row first bias's per row) to 1e-12, for every
    trace, 0-3 hidden ELU layers (none: ``f`` linear in ``u``, the exact
    trace that of ``W1_x``), a shared or per-row first bias, 1 and 3
    features."""
    rng = np.random.default_rng(100 * depth + 10 * F + row_bias)
    k, T, H, nf = 2, 5, 4, 3
    outs = [H] * depth + [F]
    t64 = lambda *shape: torch.as_tensor(rng.standard_normal(shape))  # noqa: E731
    theta = [t64(outs[0], F), t64(outs[0], 2 * nf),
             t64(k, T, outs[0]) if row_bias else t64(outs[0])]
    for i in range(1, depth + 1):
        theta += [t64(outs[i], outs[i - 1]) / 2, t64(outs[i])]
    cfg = {"freqs": tuple(float(f) for f in rng.uniform(0.5, 3.0, nf))}
    s, u, fbar = torch.as_tensor(rng.uniform(0, 1, k)), t64(k, T, F), t64(k, T, F)
    eps = t64(k, T, F) if trace is False else None
    trbar = None if trace is None else t64(k, T)
    f, du, dth = torch_cnf._tile_f_vjp(s, u, theta, eps, fbar, trbar, cfg, trace)
    assert torch.equal(f, torch_cnf._tile_f_and_tr(s, u, theta, eps, cfg, trace)[0])
    assert len(dth) == len(theta)
    for j in range(k):
        leaves = [u[j : j + 1].clone().requires_grad_()] + [
            (p[j : j + 1] if row_bias and i == 2 else p).clone().requires_grad_()
            for i, p in enumerate(theta)]
        fj, trj = torch_cnf._tile_f_and_tr(s[j : j + 1], leaves[0], leaves[1:],
                                            None if eps is None else eps[j : j + 1], cfg, trace)
        phi = (fbar[j : j + 1] * fj).sum()
        if trace is not None:
            phi = phi + (trbar[j : j + 1] * trj).sum()
        want = torch.autograd.grad(phi, leaves, allow_unused=True)
        got = [du[j : j + 1]] + [g[j : j + 1] if row_bias and i == 2 else g[j]
                                 for i, g in enumerate(dth)]
        for i, (g, w) in enumerate(zip(got, want)):
            w = torch.zeros_like(g) if w is None else w
            torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12, msg=f"tile {j}, leaf {i}")


RSAMPLE_CASES = {
    "exact": ("cnf", False, 1e-10),
    "hutchinson": ("cnf_hutchinson_plain", False, 1e-10),
    "one_context": ("cnf_context_tight", False, 1e-5),
    "batched_context": ("cnf_context_tight", True, 1e-5),
}


@pytest.mark.parametrize("case", list(RSAMPLE_CASES))
def test_rsample_gradients_match_zuko_tpu(case, monkeypatch):
    """``rsample_and_log_prob`` of ``FusedContinuousFlow`` (one tile holds
    the batch: the plain adjoint) against ``zuko_tpu``'s
    ``fused_cnf_rsample`` (dispatch on: its CPU backend, the same continuous
    adjoint through ``odeint``) from the same base draws and probe: the loss
    ``mean(lq) + mean(|x|^2)`` to 1e-10, and the gradients of every parameter
    and of the context to 1e-10 without a context (exact and Hutchinson) and
    1e-5 with one, where the two controllers watch different leaves (the
    gap ``zuko_tpu``'s own ``test_cnf_tile_adjoint_matches_xla_backward``
    allows, at tolerances of 1e-8)."""
    name, batched, tol = RSAMPLE_CASES[case]
    jflow, tflow, F, C = _pair(name)
    jc, tcv = _context(name, batched, rows=4)
    exact = CASES[name][2].get("exact", True)
    key, hkey = jax.random.PRNGKey(4), jax.random.PRNGKey(5)
    shape = (2,) if batched else (8,)
    params, static = partition(jflow)

    def build(p, c_):
        flow = combine(p, static)
        return flow(c_) if exact else flow(c_, key=hkey)

    def jloss(p, c_):
        x, lq = build(p, c_).rsample_and_log_prob(key, shape)
        return jnp.mean(lq) + jnp.mean(jnp.sum(x**2, axis=-1))

    _dispatch(monkeypatch, True)
    jdist = build(params, jc)
    assert type(jdist).__name__ == "FusedContinuousFlow"
    _, z, eps, _, _ = jax_cnf._prep_cnf_sample(jflow, jdist.transform, key, shape, jc, True)
    value, jgrads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1) if C else 0))(params, jc)
    jgrads = jgrads if C else (jgrads,)
    z, eps = np.asarray(z), np.asarray(eps)
    monkeypatch.setattr(torch, "randn", lambda size, **kw: torch.tensor(z).reshape(size))
    tflow.zero_grad()
    tcg = None if tcv is None else tcv.clone().requires_grad_(True)
    tdist = tflow(tcg) if exact else tflow(tcg, generator=torch.Generator().manual_seed(0))
    assert type(tdist) is FusedContinuousFlow
    if not exact:  # zuko_tpu's probe from its key
        tparams, _, tcfg = tdist._flat
        tdist._flat = (tparams, lambda like: torch.tensor(eps).reshape(like.shape), tcfg)
    x, lq = tdist.rsample_and_log_prob(shape)
    loss = lq.mean() + (x**2).sum(dim=-1).mean()
    loss.backward()
    _close(loss, value, 1e-10)
    if C:
        _close(tcg.grad, jgrads[1], tol)
    got, want = _grads_by_name(jgrads[0], tflow)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol, err_msg=k)


def test_rsample_gate_and_budget_poison_the_gradients(monkeypatch):
    """The solve-consistency gate and the step budget, as in ``zuko_tpu``
    (``test_cnf_rsample_reint_gate_poisons``, ``..._budget_exhaustion_...``):
    a healthy flow's gradients are finite; with ``_REINT_ATOL = -1`` every
    row misses its base draw and every parameter's gradient is NaN; with
    ``max_steps=2`` at tolerances of 1e-12 the sample is NaN and so is every
    parameter's gradient."""
    torch.manual_seed(0)

    def grads(flow):
        flow.zero_grad()
        x, lq = flow(None).rsample_and_log_prob((8,))
        (lq.mean() + (x**2).sum(dim=-1).mean()).backward()
        return [p.grad for p in flow.parameters() if p.requires_grad]

    _dispatch(monkeypatch, True)
    flow = zt.CNF(3, hidden_features=(8, 8), device="cpu").double()
    assert all(bool(torch.isfinite(g).all()) for g in grads(flow))
    monkeypatch.setattr(torch_cnf, "_REINT_ATOL", -1.0)
    assert all(bool(torch.isnan(g).all()) for g in grads(flow))
    monkeypatch.undo()
    _dispatch(monkeypatch, True)
    starved = zt.CNF(3, hidden_features=(8, 8), max_steps=2, atol=1e-12, rtol=1e-12,
                     device="cpu").double()
    with torch.no_grad():
        assert bool(torch.isnan(starved(None).rsample((4,))).all())
    assert all(bool(torch.isnan(g).all()) for g in grads(starved))


def test_reverse_kl_step_matches_zuko_tpu(monkeypatch):
    """One Adam step of reverse KL (``make_reverse_kl_step``) of a CNF with
    the exact trace, fused on both sides: the forward samples with log q,
    the backward the continuous adjoint (one tile holds the batch), from the
    base draws ``zuko_tpu`` makes from its key: the loss to 1e-9 and every
    updated parameter to 1e-8."""
    jflow, tflow = _build("cnf", key=2)
    params, static = partition(jflow)
    key, n = jax.random.PRNGKey(6), 16
    _dispatch(monkeypatch, True)
    jdist = combine(params, static)(None)
    z = np.asarray(jax_cnf._prep_cnf_sample(jflow, jdist.transform, key, (n,), None, True)[1])
    monkeypatch.setattr(torch, "randn", lambda *a, **k: torch.tensor(z))
    jinit, jstep = jax_train.make_reverse_kl_step(
        static, zuko_tpu.data.ring_energy, n_samples=n, lr=1e-3)
    jstate, jloss = jstep(jinit(params), key)
    tinit, tstep = make_reverse_kl_step(tflow, zt.data.ring_energy, n_samples=n, lr=1e-3)
    assert isinstance(tflow(None), FusedContinuousFlow)
    tstate, tloss = tstep(tinit())
    assert tstate.step == 1
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-9, atol=1e-9)
    _assert_same_parameters(tflow, jstate.params, atol=1e-8)


# ------------------------------------------------------ dispatch, structure


@pytest.mark.parametrize("kwargs, why", [
    ({"normalize": True}, "Linear MLP"),
    ({"activation": torch.relu}, "ELU activations only"),
    ({}, "trainable"),
], ids=["layernorm", "relu", "trainable_base"])
def test_other_structures_stay_unfused(kwargs, why, monkeypatch):
    """A LayerNorm between the linears, another activation, or a trainable
    base: the extractor raises and ``flow(c)`` keeps the unfused path, which
    still serves."""
    torch.manual_seed(0)
    flow = zt.CNF(3, hidden_features=(8, 8), device="cpu", **kwargs)
    if not kwargs:
        flow.base._0.requires_grad_(True)
    _dispatch(monkeypatch, True)
    with pytest.raises(FusedStructureError, match=why):
        torch_cnf.extract_cnf_params(flow, flow.transform(None))
    dist = flow(None)
    assert type(dist) is NormalizingFlow
    assert dist.log_prob(torch.zeros(2, 3)).shape == (2,)


def test_cnf_dispatch(monkeypatch):
    """Under ``=1`` a CNF dispatches to ``FusedContinuousFlow``; ``auto``
    keeps CPU parameters unfused; an inverted CNF and bounds other than
    t = 0..1 keep the unfused path."""
    _, tflow, F, _ = _pair("cnf")
    monkeypatch.setenv("ZUKO_TPU_TORCH_FUSED_DISPATCH", "auto")
    assert type(tflow(None)) is NormalizingFlow
    monkeypatch.setenv("ZUKO_TPU_TORCH_FUSED_DISPATCH", "1")
    assert type(tflow(None)) is FusedContinuousFlow
    inverted = zt.Flow(tflow.transform.inv, tflow.base)
    assert type(inverted(None)) is NormalizingFlow
    with pytest.raises(FusedStructureError, match="t=0..1"):
        torch_cnf.extract_cnf_params(tflow, tflow.transform(None).inv)


@pytest.mark.parametrize("make, rows, wide", [
    (lambda: zt.CNF(6, device="cpu"), 1 << 18, False),
    (lambda: zt.CNF(6, 4, device="cpu"), 1 << 18, False),
    (lambda: zt.CNF(64, 10, exact=True, device="cpu"), 1024, True),
    (lambda: zt.CNF(3, hidden_features=(512, 512), device="cpu"), 1 << 14, True),
], ids=["flagship", "conditional", "features_64", "width_512"])
def test_plan_cnf_picks_the_tier_from_the_shapes(make, rows, wide):
    """The flagship (and its conditional form) plans the narrow tier, a
    cluster of blocks a tile of ``TILE`` rows, in one launch; 64 features
    (the shape ``zuko_tpu`` refuses at its VMEM gate) and hidden widths of
    512 plan the wide tier: a workspace of ``3 F + 7 (F + 1) + sum(hidden)
    + 4 max(hidden)`` floats a row, launches of whole tiles, at most 1
    GiB."""
    torch.manual_seed(0)
    transform = make().transform
    linears = transform.ode.layers[0::2]
    F = linears[-1].out_features
    widths = [F] + [layer.out_features for layer in linears]
    plan = torch_cnf.plan_cnf(widths, transform.freqs.numel(), rows)
    assert plan.wide == wide
    if wide:
        hidden = widths[1:-1]
        assert plan.slots == 3 * F + 7 * (F + 1) + sum(hidden) + 4 * max(hidden)
        assert plan.chunk_rows % torch_cnf.TILE == 0 and plan.chunk_rows >= rows
        assert plan.workspace_bytes == 4 * plan.slots * plan.chunk_rows <= 1 << 30
    else:
        assert plan[:5] == (False, 0, rows, 0, 0)
        assert plan.cluster * plan.block_rows == torch_cnf.TILE


def test_hutchinson_needs_a_generator_and_its_probe_is_fixed(monkeypatch):
    """``exact=False`` without a generator raises, naming Hutchinson, as
    ``zuko_tpu`` does without a key; with one, the built transform's probe is
    the same on every call at the same shape (a function of the transform, as
    a PRNG key is), and a second build draws another."""
    _, tflow, F, C = _pair("cnf_hutchinson")
    c = torch.zeros(C, dtype=torch.float64)
    with pytest.raises(ValueError, match="Hutchinson"):
        tflow(c)
    generator = torch.Generator().manual_seed(1)
    t = tflow.transform(c, generator=generator)
    x = torch.randn(5, F, dtype=torch.float64)
    torch.testing.assert_close(t.probe(x), t.probe(x), rtol=0, atol=0)
    assert not torch.equal(t.probe(x), tflow.transform(c, generator=generator).probe(x))
    _dispatch(monkeypatch, True)
    dist = tflow(c, generator=torch.Generator().manual_seed(2))
    assert type(dist) is FusedContinuousFlow
    with torch.no_grad():
        torch.testing.assert_close(dist.log_prob(x), dist.log_prob(x), rtol=0, atol=0)
        _dispatch(monkeypatch, False)
        unfused = tflow(c, generator=torch.Generator().manual_seed(2))
        torch.testing.assert_close(dist.log_prob(x), unfused.log_prob(x), rtol=1e-10, atol=1e-10)


# ------------------------------------------------------------------ assets


def _flagship(**kwargs):
    return zuko_tpu.flows.CNF(6, 0, key=jax.random.PRNGKey(0), **kwargs)


def test_flagship_weights_regenerate_from_zuko_tpu():
    """``cnf_flagship.npz`` is ``zuko_tpu``'s ``CNF(6, 0, key=PRNGKey(0))``:
    every array, bit for bit, and the port loads it one to one (9 arrays of
    5,397 floats: the network 12-64-64-6, the frequencies, the base)."""
    buffer = io.BytesIO()
    save_params(buffer, _flagship())
    buffer.seek(0)
    with np.load(buffer) as fresh, np.load(ASSETS / "cnf_flagship.npz") as committed:
        assert sorted(fresh.files) == sorted(committed.files)
        for k in fresh.files:
            np.testing.assert_array_equal(fresh[k], committed[k], err_msg=k)
        weights = {k: committed[k] for k in committed.files}
    flow = load_params(zt.CNF(6, device="cpu"), weights)
    assert sum(v.numel() for v in flow.state_dict().values()) == 5397
    assert len(flow.state_dict()) == len(weights) == 9


def test_flagship_truth_regenerates_from_zuko_tpu(monkeypatch):
    """``cnf_truth_f64.npz`` holds 4,096 standard-normal rows ``x`` (numpy
    seed 0) with their log-density ``lp``, and 1,024 base draws ``z`` (seed
    1) with their samples ``x_sample`` and ``lq``, all ``zuko_tpu``'s
    unfused float64 flagship at ``atol = rtol = 1e-10`` and ``max_steps =
    4096`` (the 4,096 rows take about 150 accepted steps): converged truth,
    not a run at the flow's tolerances. Regenerated here on the first 32
    rows (a step sequence of their own), by ``zuko_tpu`` and by the port's
    unfused flow at the same tolerances, each within 1e-6 of the file: what
    the tight integration itself leaves (measured: 5.3e-7 and 6.6e-7). At
    1e-10 the two packages' step sequences part at one accept decision on
    these rows (5e-7 apart); at 1e-8 they agree to 2e-12."""
    with np.load(ASSETS / "cnf_truth_f64.npz") as data:
        x, lp, z, xs, lq = (data[k] for k in ("x", "lp", "z", "x_sample", "lq"))
    assert x.shape == (4096, 6) and lp.shape == (4096,)
    assert z.shape == xs.shape == (1024, 6) and lq.shape == (1024,)
    np.testing.assert_array_equal(x, np.random.default_rng(0).standard_normal((4096, 6)))
    np.testing.assert_array_equal(z, np.random.default_rng(1).standard_normal((1024, 6)))
    _dispatch(monkeypatch, False)
    tight = dict(atol=1e-10, rtol=1e-10, max_steps=4096)
    jdist = _f64(_flagship(**tight))(None)
    rows = slice(0, 32)

    def truth(x_, z_):
        jxs, jladj = jdist.transform.inverse_and_ladj(z_)
        return jdist.log_prob(x_), jxs, jdist.base.log_prob(z_) - jladj

    jlp, jxs, jlq = jax.jit(truth)(jnp.asarray(x[rows]), jnp.asarray(z[rows]))
    for got, want in ((jlp, lp), (jxs, xs), (jlq, lq)):
        np.testing.assert_allclose(np.asarray(got), want[rows], rtol=0, atol=1e-6)
    flow = load_params(zt.CNF(6, device="cpu", **tight).double(), ASSETS / "cnf_flagship.npz")
    with torch.no_grad():
        tdist = flow(None)
        txs, tladj = tdist.transform.inverse_and_ladj(torch.as_tensor(z[rows]))
        tlq = tdist.base.log_prob(torch.as_tensor(z[rows])) - tladj
        for got, want in ((tdist.log_prob(torch.as_tensor(x[rows])), lp), (txs, xs), (tlq, lq)):
            np.testing.assert_allclose(got.numpy(), want[rows], rtol=0, atol=1e-6)
