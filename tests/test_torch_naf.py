r"""Parity of the port's neural autoregressive flow (``zuko_tpu_torch.flows.NAF``
and what it is built from) with ``zuko_tpu`` on the CPU.

Both packages build the same model: ``zuko_tpu`` from a PRNG key, the port
from its ``zuko_tpu.serial.save_params`` checkpoint through ``load_params``.
Inputs and base draws are made with numpy from a seed and handed to both.
Everything runs in float64 on the CPU, where the port's kernel wrappers take
their plain versions and ``zuko_tpu``'s fused entry points their jnp math
(warm-started sweeps on, its default).

The monotone networks' weights are doubled before the flows are carried
across: at random initialisation the small networks here cover too narrow a
range, and most standard-normal draws would peg at the solver's bracket,
where the implicit-function gradients are gated to zero on both sides.

Tolerances, each with its reason, stand beside the tests. Closed forms agree
to roundoff (1e-10 and closer); the solves run the same fixed-count
bisection and Newton steps on both sides, so samples agree to far below the
solve's 1e-6 contract, which is what they are held to.
"""

import io

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zuko_tpu
import zuko_tpu_torch as zt

from zuko_tpu import nn as jax_nn
from zuko_tpu import transforms as jax_transforms
from zuko_tpu.core import combine, named_parameters, partition
from zuko_tpu.ops import naf_fused as jax_naf
from zuko_tpu.parallel import train as jax_train
from zuko_tpu.serial import save_params
from zuko_tpu_torch import ops
from zuko_tpu_torch.distributions import NormalizingFlow
from zuko_tpu_torch.lazy import Flow
from zuko_tpu_torch.ops import naf_fused as torch_naf
from zuko_tpu_torch.ops.dispatch import FusedNeuralSamplingFlow
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


# name -> (features, context, transforms, signal)
CASES = {"naf": (3, 0, 2, 4), "naf_context": (3, 2, 2, 4)}
KWARGS = dict(network={"hidden_features": (8, 8)}, hidden_features=(16, 16))
_PAIRS = {}


def _build(name, key=0):
    """The same NAF in both packages, monotone weights doubled; the port's in
    float64 on the CPU."""
    F, C, T, S = CASES[name]
    jflow = zuko_tpu.flows.NAF(F, C, transforms=T, signal=S, key=jax.random.PRNGKey(key),
                               **KWARGS)
    params, static = partition(jflow)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: 2 * a if "univariate" in jax.tree_util.keystr(path)
        and "weight" in jax.tree_util.keystr(path) else a, _f64(params))
    jflow = combine(params, static)
    tflow = _carry(jflow, zt.NAF(F, C, transforms=T, signal=S, device="cpu", **KWARGS))
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


def _grads_by_name(jgrads, tflow):
    want = {to_torch_name(k): np.asarray(g) for k, g in named_parameters(jgrads)}
    got = {k: p.grad.numpy() for k, p in tflow.named_parameters()}
    assert sorted(got) == sorted(want)
    return got, want


# --------------------------------------------------------- building blocks


def _module_pair(kind):
    key = jax.random.PRNGKey(1)
    if kind == "linear_stack":
        return jax_nn.Linear(5, 7, stack=3, key=key), zt.nn.Linear(5, 7, stack=3, device="cpu")
    if kind == "monotonic_linear":
        return (jax_nn.MonotonicLinear(5, 7, stack=3, key=key),
                zt.nn.MonotonicLinear(5, 7, stack=3, device="cpu"))
    if kind == "monotonic_mlp":
        return (jax_nn.MonotonicMLP(5, 1, (8, 6), stack=3, key=key),
                zt.nn.MonotonicMLP(5, 1, (8, 6), stack=3, device="cpu"))
    return jax_nn.TwoWayELU(alpha=0.7), zt.nn.TwoWayELU(alpha=0.7)


@pytest.mark.parametrize(
    "kind", ["linear_stack", "monotonic_linear", "two_way_elu", "monotonic_mlp"])
def test_nn_modules_match_zuko_tpu(kind):
    """Stacked operators on ``(..., stack, in)`` inputs: 1e-12."""
    jm, tm = _module_pair(kind)
    if kind != "two_way_elu":
        tm = _carry(jm, tm)
        jm = _f64(jm)
        names = [k for k, _ in tm.named_parameters()]
        assert all(p.shape[0] == 3 for p in tm.parameters()), names
    x = np.random.default_rng(0).standard_normal((4, 3, 5) if kind != "two_way_elu" else (4, 6))
    got = tm(torch.as_tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(jm(jnp.asarray(x))), rtol=1e-12, atol=1e-12)
    if kind == "monotonic_mlp":
        # positive weights and activation slopes: increasing in every input
        J = torch.autograd.functional.jacobian(tm, torch.as_tensor(x[0]))
        assert bool((torch.diagonal(J, dim1=0, dim2=2) > 0).all())


def test_softclip_transform_matches_zuko_tpu():
    x = 30 * np.random.default_rng(1).standard_normal((6, 3))
    jt, tt = jax_transforms.SoftclipTransform(11.0), zt.transforms.SoftclipTransform(11.0)
    jy, jl = jt.call_and_ladj(jnp.asarray(x))
    ty, tl = tt.call_and_ladj(torch.as_tensor(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-12, atol=1e-12)
    tx, tli = tt.inverse_and_ladj(ty)
    np.testing.assert_allclose(tx.numpy(), x, rtol=1e-10)
    np.testing.assert_allclose(tli.numpy(), -tl.numpy(), rtol=1e-10)


# ------------------------------------------------------------- the density


DENSITY_CASES = {
    "plain": ("naf", False, (12, 3)),
    "one_context": ("naf_context", False, (12, 3)),
    "batched_context": ("naf_context", True, (5, 6, 3)),  # x over the context batch
}


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("case", list(DENSITY_CASES))
def test_log_prob_matches_zuko_tpu(case, fused, monkeypatch):
    """The port, unfused and fused (plain version of the kernel), against
    ``zuko_tpu`` the same way: 1e-10, closed forms on both sides (the
    derivative by autograd unfused, analytic fused)."""
    name, batched, shape = DENSITY_CASES[case]
    jflow, tflow, F, C = _pair(name)
    jc, tc = _context(name, batched)
    x = 1.5 * np.random.default_rng(6).standard_normal(shape)

    _dispatch(monkeypatch, fused)
    jdist = jflow(jc)
    assert (type(jdist).__name__ == "FusedNeuralSamplingFlow") == fused
    # traced once, as a whole: the same arithmetic as op by op, a fraction
    # of the time
    expected = np.asarray(jax.jit(lambda x_, c_: jflow(c_).log_prob(x_))(jnp.asarray(x), jc))
    tdist = tflow(tc)
    assert type(tdist) is (FusedNeuralSamplingFlow if fused else NormalizingFlow)
    with torch.no_grad():
        got = tdist.log_prob(torch.as_tensor(x)).numpy()
    assert got.shape == shape[:-1] == expected.shape
    np.testing.assert_allclose(got, expected, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("case", ["plain", "batched_context"])
def test_naf_density_gradients_match_zuko_tpu(case, monkeypatch):
    """Through ``naf_density`` (its ``autograd.Function`` on the card, the
    plain version here): the gradients of a weighted sum of log-densities to
    ``x``, the context and every parameter, against ``jax.grad`` of
    ``zuko_tpu``'s ``fused_naf_log_prob``: 1e-8."""
    name, batched, shape = DENSITY_CASES[case]
    jflow, tflow, F, C = _pair(name)
    jc, tc = _context(name, batched)
    x = 1.5 * np.random.default_rng(7).standard_normal(shape)
    w = np.random.default_rng(8).standard_normal(shape[:-1])
    params, static = partition(jflow)

    def jloss(p, x_, c_):
        return jnp.sum(jax_naf.fused_naf_log_prob(combine(p, static), x_, c_) * w)

    argnums = (0, 1, 2) if C else (0, 1)
    jgrads = jax.jit(jax.grad(jloss, argnums=argnums))(params, jnp.asarray(x), jc)
    _dispatch(monkeypatch, True)
    tflow.zero_grad()
    tx = torch.tensor(x, requires_grad=True)
    tcg = None if tc is None else tc.clone().requires_grad_(True)
    (tflow(tcg).log_prob(tx) * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrads[1]), rtol=1e-8, atol=1e-8)
    if C:
        np.testing.assert_allclose(tcg.grad.numpy(), np.asarray(jgrads[2]), rtol=1e-8, atol=1e-8)
    got, want = _grads_by_name(jgrads[0], tflow)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-8, atol=1e-8, err_msg=k)
    assert any(np.abs(g).max() > 0 for g in got.values())


def test_the_density_functions_chunked_backward(monkeypatch):
    """On the card ``naf_density``'s backward runs the plain version on
    chunks of rows and sums the parameters' gradients in float64
    (``RowChunkedBackward``). Driven here with the plain version standing in
    for the kernel and chunks of 5 rows, against one autograd pass over all
    rows: 1e-12, for ``x``, the context and every parameter."""
    from zuko_tpu_torch.ops._common import RowChunkedBackward

    _, tflow, F, C = _pair("naf_context")
    params, layout, _, S = torch_naf._flatten_naf(tflow)
    xc = torch.as_tensor(np.random.default_rng(12).standard_normal((23, F + C)))
    w = torch.as_tensor(np.random.default_rng(13).standard_normal(23))
    ps = [p.detach().requires_grad_(True) for p in params]
    x1 = xc.clone().requires_grad_(True)
    (torch_naf._naf_density_math(x1, ps, layout, F, S) * w).sum().backward()
    want = [x1.grad] + [p.grad for p in ps]

    monkeypatch.setattr(RowChunkedBackward, "CHUNK", 5)
    ps = [p.detach().requires_grad_(True) for p in params]
    x2 = xc.clone().requires_grad_(True)
    kernel = lambda x, p, *statics: torch_naf._naf_density_math(x, p, *statics)  # noqa: E731
    out = RowChunkedBackward.apply(x2, kernel, torch_naf._naf_density_math, (layout, F, S), *ps)
    (out * w).sum().backward()
    for got, expected in zip([x2.grad] + [p.grad for p in ps], want):
        np.testing.assert_allclose(got.numpy(), expected.numpy(), rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------- sampling


@pytest.mark.parametrize("name", list(CASES))
def test_naf_sample_matches_zuko_tpu(name, monkeypatch):
    """``naf_sample`` with and without log q from the same ``z``, against
    ``zuko_tpu``'s ``_naf_sample_core`` (its jnp math, warm sweeps): to the
    solve's contract, 1e-6 (the two run the same steps; they agree to
    roundoff). Every layer takes more than one sweep, so the cold first sweep
    and the warm later ones both run. Then the round trip: the unfused
    forward brings ``x`` back to ``z``, and the density at ``x`` is log q."""
    jflow, tflow, F, C = _pair(name)
    jc, tc = _context(name, True, rows=40)
    n = 40
    z = np.random.default_rng(9).standard_normal((n, F))
    zc = z if C == 0 else np.concatenate([z, np.asarray(jc)], axis=1)

    params, layout, F_, S = torch_naf._flatten_naf(tflow)
    assert F_ == F and all(e[3] > 1 for e in layout if e[0] == "ar")
    zt_ = torch.as_tensor(zc)
    x = torch_naf.naf_sample(zt_, params, layout, F, S)
    x2, lq = torch_naf.naf_sample(zt_, params, layout, F, S, True)
    assert x.shape == (n, F) and lq.shape == (n,) and not x.requires_grad
    assert torch.equal(x, x2)

    stages, cfg = jax_naf.extract_naf_params(jflow)
    jflat, jlayout = jax_naf._stage_layout(stages, F, S)
    (jx, jlq), jx_only = jax.jit(lambda zc_: [
        jax_naf._naf_sample_core(jlayout, F, C, S, mode, zc_, list(jflat))
        for mode in (True, False)])(jnp.asarray(zc))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=1e-6)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx_only), rtol=0, atol=1e-6)
    np.testing.assert_allclose(lq.numpy(), np.asarray(jlq), rtol=0, atol=1e-6)

    _dispatch(monkeypatch, False)
    with torch.no_grad():
        back = tflow(tc).transform(x)
        lp = torch_naf.fused_naf_log_prob((params, layout, F, S), x, tc)
    solved = (back - torch.as_tensor(z)).abs().amax(dim=1) <= 1e-6
    assert float(solved.double().mean()) >= 0.9
    np.testing.assert_allclose(lq.numpy()[solved], lp.numpy()[solved], rtol=0, atol=1e-6)


@pytest.mark.parametrize("batched", [False, True], ids=["plain", "batched_context"])
def test_sampling_through_the_public_api(batched, monkeypatch):
    """Shapes are ``sample_shape + context batch + (F,)``; the same generator
    state gives ``sample``, ``sample_and_log_prob`` and ``rsample`` the same
    ``x`` exactly."""
    _dispatch(monkeypatch, True)
    name = "naf_context" if batched else "naf"
    _, tflow, F, C = _pair(name)
    _, tc = _context(name, batched)
    dist = tflow(tc)
    assert isinstance(dist, FusedNeuralSamplingFlow)
    batch = (6,) if batched else ()

    def gen():
        return torch.Generator().manual_seed(5)

    x = dist.sample((7,), gen())
    x2, lq = dist.sample_and_log_prob((7,), gen())
    xr = dist.rsample((7,), gen())
    xr2, lqr = dist.rsample_and_log_prob((7,), gen())
    assert x.shape == (7, *batch, F) and lq.shape == (7, *batch)
    assert not x.requires_grad and xr.requires_grad and lqr.requires_grad
    for other in (x2, xr.detach(), xr2.detach()):
        assert torch.equal(x, other)
    assert torch.equal(lq, lqr.detach())
    assert dist.sample(generator=gen()).shape == (*batch, F)


# ----------------------------------------------------------- IFT gradients


IFT_CASES = {"plain": ("naf", False, True), "one_context": ("naf_context", False, True),
             "batched_context": ("naf_context", True, True),
             "rsample_batched_context": ("naf_context", True, False)}


@pytest.mark.parametrize("case", list(IFT_CASES))
def test_ift_gradients_match_zuko_tpu(case, monkeypatch):
    """``rsample_and_log_prob`` (or ``rsample`` alone) through the NAF tier
    of the IFT, from the draws ``zuko_tpu`` makes from its key: the loss, and
    its gradients to every parameter, to the context and through log q,
    against ``zuko_tpu``'s ``fused_naf_rsample``: 1e-6 (both differentiate
    at roots that agree to roundoff)."""
    name, batched, with_log_q = IFT_CASES[case]
    jflow, tflow, F, C = _pair(name)
    jc, tc = _context(name, batched)
    key, shape = jax.random.PRNGKey(4), (8,)
    params, static = partition(jflow)

    def jloss(p, c_):
        dist = combine(p, static)(c_)
        if not with_log_q:
            x = dist.rsample(key, shape)
            return jnp.mean(jnp.sum(x**2, -1)), (x, jnp.zeros(x.shape[:-1]))
        x, lq = dist.rsample_and_log_prob(key, shape)
        return jnp.mean(lq) + jnp.mean(jnp.sum(x**2, -1)), (x, lq)

    _dispatch(monkeypatch, True)
    assert type(jflow(jc)).__name__ == "FusedNeuralSamplingFlow"
    argnums = (0, 1) if C else 0
    (jvalue, (jx, jlq)), jgrads = jax.jit(jax.value_and_grad(jloss, argnums, has_aux=True))(
        params, jc)
    jgp = jgrads[0] if C else jgrads
    z = np.asarray(jax_naf._prep_naf_sample(jflow, key, shape, jc)[3])[:, :F]
    monkeypatch.setattr(torch, "randn", lambda shape, **kw: torch.tensor(z).reshape(shape))

    tflow.zero_grad()
    tcg = None if tc is None else tc.clone().requires_grad_(True)
    dist = tflow(tcg)
    assert isinstance(dist, FusedNeuralSamplingFlow)
    if with_log_q:
        x, lq = dist.rsample_and_log_prob(shape)
    else:
        x, lq = dist.rsample(shape), torch.zeros(jx.shape[:-1], dtype=torch.float64)
    assert x.shape == jx.shape and lq.shape == jlq.shape
    np.testing.assert_allclose(x.detach().numpy(), np.asarray(jx), rtol=0, atol=1e-6)
    loss = lq.mean() + (x**2).sum(dim=-1).mean()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jvalue), rtol=0, atol=1e-6)
    got, want = _grads_by_name(jgp, tflow)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)
    assert max(np.abs(g).max() for g in got.values()) > 1e-3
    if C:
        np.testing.assert_allclose(tcg.grad.numpy(), np.asarray(jgrads[1]), rtol=1e-6, atol=1e-6)
        assert np.abs(tcg.grad.numpy()).max() > 0


# ---------------------------------------------------------------- training


def _assert_same_parameters(tflow, jparams, atol):
    expected = {to_torch_name(k): np.asarray(v) for k, v in named_parameters(jparams)}
    got = dict(tflow.named_parameters())
    assert sorted(got) == sorted(expected)
    for k, p in got.items():
        np.testing.assert_allclose(p.detach().numpy(), expected[k], rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_mle_steps_match_zuko_tpu(name, monkeypatch):
    """One Adam step of maximum likelihood, then two more on the same batch,
    fused on both sides: the loss to 1e-10, every updated parameter to
    1e-8 after the first and the third step."""
    jflow, tflow, F, C = (*_build(name), *CASES[name][:2])
    jc, tc = _context(name, True, rows=16)
    x = 1.5 * np.random.default_rng(10).standard_normal((16, F))
    params, static = partition(jflow)

    _dispatch(monkeypatch, True)
    jinit, jstep = jax_train.make_mle_step(static, lr=1e-3)
    jstate = jinit(params)
    tinit, tstep = make_mle_step(tflow, lr=1e-3)
    tstate = tinit()
    assert isinstance(tflow(tc), FusedNeuralSamplingFlow)
    for step in range(3):
        jstate, jloss = jstep(jstate, jnp.asarray(x), jc)
        tstate, tloss = tstep(tstate, torch.as_tensor(x), tc)
        assert tstate.step == step + 1
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-10, atol=1e-10)
        if step in (0, 2):
            _assert_same_parameters(tflow, jstate.params, atol=1e-8)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_reverse_kl_steps_match_zuko_tpu(fused, monkeypatch):
    """One Adam step of reverse KL on the ring energy, then two more from
    the same base draws, on both sides through the NAF tier of the IFT
    (fused) or through the solves' implicit backward (unfused): the loss to
    1e-6 and the updated parameters to 1e-8 after the first and the third
    step. Adam's first step is ``lr * g / (|g| + 1e-8)``, so a gradient
    agreeing to 1e-6 of itself moves a parameter by far less. In the
    unfused case the solves of both packages end anywhere within ``eps`` =
    1e-6 of the root once every element has moved by less, so a roundoff
    that changes when the loop stops moves a sample by up to that much. At
    these draws (jitted or not) one element of
    ``zuko_tpu``'s solve converges, has Newton's step refused by the
    progress test (``|2 r| <= |dx_old f'|`` with a last step of 1e-17)
    and bisects away while other elements keep the loop running: it ends
    5.9e-7 from its root, where the port's ends on it. Adam's normalised
    step takes that to 1.3e-8 (2.1e-8 after the third step) on one
    weight of the last MADE layer whose gradient is small, so the
    unfused parameters are held to 3e-8."""
    CASES["naf2"] = (2, 0, 2, 4)
    try:
        jflow, tflow = _build("naf2")
    finally:
        del CASES["naf2"]
    params, static = partition(jflow)
    key, n = jax.random.PRNGKey(2), 32
    z = np.asarray(jax_naf._prep_naf_sample(jflow, key, (n,), None)[3])
    np.testing.assert_array_equal(np.asarray(jflow(None).base.sample(key, (n,))), z)
    monkeypatch.setattr(torch, "randn", lambda shape, **kw: torch.tensor(z).reshape(shape))

    _dispatch(monkeypatch, fused)
    jinit, jstep = jax_train.make_reverse_kl_step(
        static, zuko_tpu.data.ring_energy, n_samples=n, lr=1e-3)
    jstate = jinit(params)
    tinit, tstep = make_reverse_kl_step(tflow, zt.data.ring_energy, n_samples=n, lr=1e-3)
    tstate = tinit()
    assert type(tflow(None)) is (FusedNeuralSamplingFlow if fused else NormalizingFlow)
    for step in range(3):
        jstate, jloss = jstep(jstate, key)
        tstate, tloss = tstep(tstate)
        assert tstate.step == step + 1
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=0, atol=1e-6)
        if step in (0, 2):
            _assert_same_parameters(tflow, jstate.params, atol=1e-8 if fused else 3e-8)


# ------------------------------------------------- dispatch, structure, limits


def test_naf_dispatch(monkeypatch):
    """Under ``=1`` a NAF dispatches to the NAF class; ``auto`` keeps CPU
    parameters unfused; an inverted NAF keeps the unfused path, as in
    ``zuko_tpu``."""
    _, tflow, F, _ = _pair("naf")
    monkeypatch.setenv("ZUKO_TPU_TORCH_FUSED_DISPATCH", "auto")
    assert type(tflow(None)) is NormalizingFlow
    monkeypatch.setenv("ZUKO_TPU_TORCH_FUSED_DISPATCH", "1")
    assert type(tflow(None)) is FusedNeuralSamplingFlow
    inverted = Flow(tflow.transform.inv, tflow.base)
    dist = inverted(None)
    assert type(dist) is NormalizingFlow
    with torch.no_grad():
        assert dist.log_prob(torch.zeros(2, F, dtype=torch.float64)).shape == (2,)
    with pytest.raises(FusedStructureError, match="features"):
        tflow(None).log_prob(torch.zeros(2, F + 1, dtype=torch.float64))


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the GPU."""

    is_cuda = property(lambda self: True)


@pytest.mark.parametrize("kwargs, made_w, mono_w, slots", [
    ({"features": 65, "signal": 2}, [65, 16, 130], [3, 8, 1], 303),
    ({"signal": 65}, [3, 16, 195], [66, 8, 1], 144),
    ({"network": {"hidden_features": (130,)}}, [3, 16, 12], [5, 130, 1], 693),
    ({"hidden_features": (257,)}, [3, 257, 12], [5, 8, 1], 565),
], ids=["features", "signal", "monotone_width", "made_width"])
def test_kernel_limits_raise_before_launch(kwargs, made_w, mono_w, slots):
    """Past the narrow tier's limits (64 features, a signal of 64, monotone
    widths of 128, MADE widths of 256) the NAF kernels raise no more: the
    planner gives the flow the wide tier, a workspace of ``F + C + 2
    max(MADE widths) + S + 1 + 5 max(monotone widths) + F`` floats a row and
    a descriptor buffer of its widths and stages, and the wrappers go on to
    the launch, where the CPU weights stop them (a GPU tensor would
    launch)."""
    torch.manual_seed(0)
    kwargs = {"features": 3, "transforms": 2, "signal": 4, "hidden_features": (16,),
              "network": {"hidden_features": (8,)}, **kwargs}
    flow = zt.NAF(device="cpu", **kwargs)
    with torch.no_grad():
        params, layout, F, S = torch_naf._flatten_naf(flow)
        assert torch_naf._widths(params, layout, F, 0, S) == ("mnn", made_w, mono_w)
        plan = torch_naf.plan_naf("mnn", made_w, mono_w, F, 0, S, len(layout), 1000)
        # 10 ints of widths and offsets in 48 bytes, 24 a stage
        assert plan == (True, slots, 1024, 4 * slots * 1024, 48 + 24 * len(layout))
        xc = torch.randn(4, F)
        torch_naf.naf_density(xc, params, layout, F, S)  # the plain version
        ops.reset_launches()
        for fn in (torch_naf.naf_density, torch_naf.naf_sample):
            with pytest.raises(ValueError, match="on the GPU"):
                fn(xc.as_subclass(_OnCard), params, layout, F, S)
    assert all(count == 0 for count in ops.LAUNCHES.values())


# ---------------------------------------------------------------- assets


def _flagship():
    return zuko_tpu.flows.NAF(6, 0, transforms=3, signal=16, key=jax.random.PRNGKey(0))


def test_flagship_weights_regenerate_from_zuko_tpu():
    """``naf_flagship.npz`` is ``zuko_tpu``'s ``NAF(6, 0, transforms=3,
    signal=16, key=PRNGKey(0))``: every array, bit for bit, and the port
    loads it one to one (47 arrays of 161,214 floats, the MADE masks and the
    base's buffers included)."""
    buffer = io.BytesIO()
    save_params(buffer, _flagship())
    buffer.seek(0)
    with np.load(buffer) as fresh, np.load(ASSETS / "naf_flagship.npz") as committed:
        assert sorted(fresh.files) == sorted(committed.files)
        for k in fresh.files:
            np.testing.assert_array_equal(fresh[k], committed[k], err_msg=k)
        weights = {k: committed[k] for k in committed.files}
    flow = zt.NAF(6, 0, transforms=3, signal=16, device="cpu")
    load_params(flow, weights)
    assert sum(v.numel() for v in flow.state_dict().values()) == 161214
    assert len(flow.state_dict()) == len(weights) == 47


def test_flagship_truth_regenerates_from_zuko_tpu(monkeypatch):
    """``naf_truth_f64.npz`` holds 4,096 standard-normal rows (numpy seed 0)
    and ``zuko_tpu``'s float64 ``log_prob`` of them on the flagship: a
    subset regenerates to 1e-12, and the port, fused and unfused, reproduces
    it to 1e-10."""
    with np.load(ASSETS / "naf_truth_f64.npz") as data:
        x, lp = data["x"], data["lp"]
    assert x.shape == (4096, 6) and lp.shape == (4096,) and x.dtype == lp.dtype == np.float64
    np.testing.assert_array_equal(x, np.random.default_rng(0).standard_normal((4096, 6)))
    rows = slice(0, 4096, 128)
    _dispatch(monkeypatch, False)
    np.testing.assert_allclose(
        np.asarray(_f64(_flagship())(None).log_prob(jnp.asarray(x[rows]))), lp[rows],
        rtol=0, atol=1e-12)
    flow = load_params(zt.NAF(6, 0, transforms=3, signal=16, device="cpu").double(),
                       ASSETS / "naf_flagship.npz")
    for fused in (True, False):
        _dispatch(monkeypatch, fused)
        with torch.no_grad():
            got = flow(None).log_prob(torch.as_tensor(x[rows])).numpy()
        np.testing.assert_allclose(got, lp[rows], rtol=0, atol=1e-10)
