r"""Parity of the port's unconstrained neural autoregressive flow
(``zuko_tpu_torch.flows.UNAF`` and what it is built from) with ``zuko_tpu``
on the CPU.

Both packages build the same model: ``zuko_tpu`` from a PRNG key, the port
from its ``zuko_tpu.serial.save_params`` checkpoint through ``load_params``.
Inputs and base draws are made with numpy from a seed and handed to both.
Everything runs in float64 on the CPU, where the port's kernel wrappers take
their plain versions and ``zuko_tpu``'s fused entry points their jnp math
(warm-started sweeps on, its default).

Two quadrature rules meet here. The unfused flows integrate with 32
Gauss-Legendre nodes (``UnconstrainedMonotonicTransform``'s default), the
fused paths with 16 (and 4 and 8 inside the solve), in both packages. Each
is held against its counterpart to roundoff; the gap between the two rules
is measured and held on its own (:func:`test_the_gl16_gl32_gap_is_small`).
"""

import contextlib
import io

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zuko_tpu
import zuko_tpu_torch as zt

from zuko_tpu import transforms as jax_transforms
from zuko_tpu import utils as jax_utils
from zuko_tpu.core import combine, named_parameters, partition
from zuko_tpu.ops import naf_fused as jax_naf
from zuko_tpu.parallel import train as jax_train
from zuko_tpu.serial import save_params
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
CASES = {"unaf": (3, 0, 2, 6), "unaf_context": (3, 2, 2, 6)}
KWARGS = dict(network={"hidden_features": (8, 8)}, hidden_features=(16, 16))
_PAIRS = {}


def _build(name, key=0):
    """The same UNAF in both packages, the port's in float64 on the CPU."""
    F, C, T, S = CASES[name]
    jflow = _f64(zuko_tpu.flows.UNAF(F, C, transforms=T, signal=S, key=jax.random.PRNGKey(key),
                                     **KWARGS))
    tflow = _carry(jflow, zt.UNAF(F, C, transforms=T, signal=S, device="cpu", **KWARGS))
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


@pytest.mark.parametrize("n", [3, 16, 32])
def test_gauss_legendre_matches_zuko_tpu(n):
    """The rule on a batch of intervals, value and gradients to both ends
    and to a parameter of the integrand: 1e-12."""
    rng = np.random.default_rng(n)
    a, b, w = rng.standard_normal(5), 2 * rng.standard_normal(5), rng.standard_normal(5)

    def jloss(a_, b_, w_):
        return jnp.sum(jax_utils.gauss_legendre(
            lambda x: jnp.exp(w_ * jnp.sin(x)), a_, b_, n=n) * jnp.arange(1, 6))

    jvalue = jax_utils.gauss_legendre(
        lambda x: jnp.exp(jnp.asarray(w) * jnp.sin(x)), jnp.asarray(a), jnp.asarray(b), n=n)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (a, b, w)))
    ta, tb, tw = (torch.tensor(v, requires_grad=True) for v in (a, b, w))
    tvalue = zt.utils.gauss_legendre(lambda x: torch.exp(tw * torch.sin(x)), ta, tb, n=n)
    (tvalue * torch.arange(1, 6)).sum().backward()
    np.testing.assert_allclose(tvalue.detach().numpy(), np.asarray(jvalue), rtol=1e-12, atol=1e-12)
    for got, want in zip((ta.grad, tb.grad, tw.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
    if n == 3:  # exact for degree 5
        value = zt.utils.gauss_legendre(lambda x: x**5 - x**2, torch.tensor(0.0),
                                        torch.tensor(1.0), n=3)
        assert abs(float(value) - (1 / 6 - 1 / 3)) < 1e-6


def test_additive_and_unconstrained_monotonic_transforms_match_zuko_tpu():
    """``AdditiveTransform`` exactly, ``UnconstrainedMonotonicTransform``'s
    GL-32 value and ``log g`` ladj to 1e-12, and its inverse (the monotone
    solve on both sides, which stop at different iterates within its
    ``eps``) to that ``eps``, 1e-6."""
    rng = np.random.default_rng(2)
    x, shift = 3 * rng.standard_normal((4, 3)), rng.standard_normal(3)
    jt, tt = jax_transforms.AdditiveTransform(jnp.asarray(shift)), \
        zt.transforms.AdditiveTransform(torch.as_tensor(shift))
    for j, t in ((jt.call_and_ladj, tt.call_and_ladj), (jt.inverse_and_ladj, tt.inverse_and_ladj)):
        for want, got in zip(j(jnp.asarray(x)), t(torch.as_tensor(x))):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-15)

    p = rng.standard_normal(3)
    jm = jax_transforms.UnconstrainedMonotonicTransform(
        lambda u: jnp.exp(jnp.asarray(p) * jnp.tanh(u)))
    tp = torch.as_tensor(p)
    tm = zt.transforms.UnconstrainedMonotonicTransform(
        lambda u: torch.exp(tp * torch.tanh(u)), phi=(tp,))
    assert tm.n == jm.n == 32
    for want, got in zip(jm.call_and_ladj(jnp.asarray(x)), tm.call_and_ladj(torch.as_tensor(x))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
    y = tm(torch.as_tensor(x))
    back, ladj = tm.inverse_and_ladj(y)
    jback, jladj = jm.inverse_and_ladj(jnp.asarray(y.numpy()))
    np.testing.assert_allclose(back.numpy(), np.asarray(jback), rtol=0, atol=1e-6)
    np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ladj.numpy(), np.asarray(jladj), rtol=0, atol=1e-6)


def test_umnn_matches_zuko_tpu():
    """A stacked ``UMNN`` called on a signal and a constant: the composed
    transform's value and ladj to 1e-12, and the integrand is named as in
    ``zuko_tpu`` (``integrand.layers.*``), so the checkpoint loads."""
    jm = _f64(zuko_tpu.flows.UMNN(signal=4, stack=3, hidden_features=(8, 8),
                                  key=jax.random.PRNGKey(1)))
    tm = _carry(jm, zt.flows.UMNN(signal=4, stack=3, hidden_features=(8, 8), device="cpu"))
    assert all(k.startswith("integrand.layers.") for k, _ in tm.named_parameters())
    rng = np.random.default_rng(4)
    sig, const, x = (rng.standard_normal(s) for s in ((5, 3, 4), (5, 3), (5, 3)))
    jy, jl = jm(jnp.asarray(sig), jnp.asarray(const)).call_and_ladj(jnp.asarray(x))
    ty, tl = tm(torch.as_tensor(sig), torch.as_tensor(const)).call_and_ladj(torch.as_tensor(x))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), rtol=1e-12, atol=1e-12)


def test_the_kernel_quadrature_tables_are_numpys():
    """The UMNN mode of ``csrc/naf_fused.cu`` integrates with
    ``__constant__`` tables of the GL-4, GL-8 and GL-16 rules: each node's
    fraction ``(t + 1) / 2`` of ``x`` and its weight, numpy's float64 values
    written out in full (17 significant digits), in the order and at the
    offsets the kernel reads them (4 nodes at 0, 8 at 4, 16 at 12); the
    plain version takes the same numpy rules."""
    text = (ROOT / "zuko_tpu_torch" / "ops" / "csrc" / "naf_fused.cu").read_text()

    def table(name):
        body = text.split(f"__constant__ float {name}[28] = {{", 1)[1].split("};", 1)[0]
        values = [line.split("//")[0] for line in body.splitlines()]
        return np.array([float(v) for v in ",".join(values).split(",") if v.strip()])

    points, weights = table("kGLPoint"), table("kGLWeight")
    assert points.shape == weights.shape == (28,)
    for n, at in ((4, 0), (8, 4), (16, 12)):
        t, w = np.polynomial.legendre.leggauss(n)
        np.testing.assert_array_equal(points[at : at + n], 0.5 * (t + 1))
        np.testing.assert_array_equal(weights[at : at + n], w)
        pt, pw = torch_naf._GAUSS_LEGENDRE[n]
        np.testing.assert_array_equal(pt, t)
        np.testing.assert_array_equal(pw, w)


# ------------------------------------------------------------- the density


DENSITY_CASES = {
    "plain": ("unaf", False, (12, 3)),
    "one_context": ("unaf_context", False, (12, 3)),
    "batched_context": ("unaf_context", True, (5, 6, 3)),  # x over the context batch
}


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("case", list(DENSITY_CASES))
def test_log_prob_matches_zuko_tpu(case, fused, monkeypatch):
    """The port against ``zuko_tpu`` the same way: unfused (GL-32 on both
    sides) and fused (GL-16, the port's plain version of the kernel against
    ``_naf_density_math_T``), 1e-10."""
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


def test_the_gl16_gl32_gap_is_small(monkeypatch):
    """The fused density (GL-16) against the unfused one (GL-32) on the same
    flow: the gap between the two rules, not an error of either. Measured
    here (float64, 64 rows of 1.5 x standard normals): median 1.8e-7, max
    3.0e-5, the integrand's curvature growing with |x|; held to median 1e-6
    and max 1e-4, the tolerance ``zuko_tpu``'s own fused-against-unfused
    UNAF density test takes (``tests/test_fused_dispatch.py``).
    ``unaf_truth_f64.npz`` records the gap for the flagship."""
    _, tflow, F, C = _pair("unaf")
    x = torch.as_tensor(1.5 * np.random.default_rng(11).standard_normal((64, F)))
    lp = {}
    for fused in (True, False):
        _dispatch(monkeypatch, fused)
        with torch.no_grad():
            lp[fused] = tflow(None).log_prob(x)
    gap = (lp[True] - lp[False]).abs()
    assert float(gap.median()) < 1e-6 and float(gap.max()) < 1e-4, gap
    assert float(gap.max()) > 1e-9  # two rules, not one


@pytest.mark.parametrize("case", ["batched_context"])
def test_unaf_density_gradients_match_zuko_tpu(case, monkeypatch):
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


# ---------------------------------------------------------------- sampling


@pytest.mark.parametrize("name", list(CASES))
def test_unaf_sample_matches_zuko_tpu(name, monkeypatch):
    """``naf_sample`` with and without log q from the same ``z``, against
    ``zuko_tpu``'s ``_naf_sample_core`` (its jnp math: GL-4 bisection, GL-8
    and GL-16 Newton steps, warm sweeps): samples to 1e-8 and log q to
    1e-10, the two running the same steps. Every layer takes more than one
    sweep, so the cold first sweep and the warm later ones both run. Then
    the round trip: the fused forward brings ``x`` back to ``z``, and the
    fused density at ``x`` is log q."""
    jflow, tflow, F, C = _pair(name)
    jc, tc = _context(name, True, rows=40)
    n = 40
    z = np.random.default_rng(9).standard_normal((n, F))
    zc = z if C == 0 else np.concatenate([z, np.asarray(jc)], axis=1)

    params, layout, F_, S = torch_naf._flatten_naf(tflow)
    assert F_ == F and all(e[3] > 1 and e[4] == "umnn" for e in layout if e[0] == "ar")
    zt_ = torch.as_tensor(zc)
    x = torch_naf.naf_sample(zt_, params, layout, F, S)
    x2, lq = torch_naf.naf_sample(zt_, params, layout, F, S, True)
    assert x.shape == (n, F) and lq.shape == (n,) and not x.requires_grad
    assert torch.equal(x, x2)

    stages, cfg = jax_naf.extract_naf_params(jflow)
    jflat, jlayout = jax_naf._stage_layout(stages, F, S)
    jx, jlq = jax.jit(lambda zc_: jax_naf._naf_sample_core(jlayout, F, C, S, True, zc_,
                                                            list(jflat)))(jnp.asarray(zc))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=1e-8)
    np.testing.assert_allclose(lq.numpy(), np.asarray(jlq), rtol=0, atol=1e-10)

    with torch.no_grad():
        lp = torch_naf.fused_naf_log_prob((params, layout, F, S), x, tc)
    solved = torch.ones(n, dtype=torch.bool)
    xc = x if tc is None else torch.cat([x, tc], dim=1)
    y = xc[:, :F]
    for entry, made, mono_w, mono_b in torch_naf._stages(params, layout):
        if entry[0] == "softclip":
            y, _ = torch_naf._softclip(y, entry[1])
        else:
            h = torch_naf._made(torch.cat([y, xc[:, F:]], dim=1), made)
            y, _ = torch_naf._ar_layer(y, h, entry[4], mono_w, mono_b, F, S)
    solved = (y - torch.as_tensor(z)).abs().amax(dim=1) <= 1e-6
    assert float(solved.double().mean()) >= 0.9
    np.testing.assert_allclose(lq.numpy()[solved], lp.numpy()[solved], rtol=0, atol=1e-6)


@pytest.mark.parametrize("batched", [False, True], ids=["plain", "batched_context"])
def test_sampling_through_the_public_api(batched, monkeypatch):
    """Shapes are ``sample_shape + context batch + (F,)``; the same generator
    state gives ``sample``, ``sample_and_log_prob`` and ``rsample`` the same
    ``x`` exactly."""
    _dispatch(monkeypatch, True)
    name = "unaf_context" if batched else "unaf"
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


# ----------------------------------------------------------- IFT gradients


IFT_CASES = {"plain": ("unaf", False, True), "batched_context": ("unaf_context", True, True),
             "rsample_batched_context": ("unaf_context", True, False)}


@pytest.mark.parametrize("case", list(IFT_CASES))
def test_ift_gradients_match_zuko_tpu(case, monkeypatch):
    """``rsample_and_log_prob`` (or ``rsample`` alone) through the NAF tier
    of the IFT, UMNN layers, from the draws ``zuko_tpu`` makes from its key:
    the loss, and its gradients to every parameter, to the context and
    through log q, against ``zuko_tpu``'s ``fused_naf_rsample`` (the case
    ``tests/test_fused_dispatch.py`` holds against differentiating the
    unfused solve): 1e-6, both differentiating the GL-16 integral at roots
    that agree to roundoff."""
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
    np.testing.assert_allclose(x.detach().numpy(), np.asarray(jx), rtol=0, atol=1e-8)
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
    agreeing to 1e-6 of itself moves a parameter by far less. ``zuko_tpu``
    runs eagerly in the unfused case: its solves end anywhere within
    ``eps`` of the root once every element has moved by less, and a jitted
    step's roundoff changes when its loop stops (the loss then parts by
    2.5e-6 at the second step)."""
    CASES["unaf2"] = (2, 0, 2, 6)
    try:
        jflow, tflow = _build("unaf2")
    finally:
        del CASES["unaf2"]
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
        with contextlib.nullcontext() if fused else jax.disable_jit():
            jstate, jloss = jstep(jstate, key)
        tstate, tloss = tstep(tstate)
        assert tstate.step == step + 1
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=0, atol=1e-6)
        if step in (0, 2):
            _assert_same_parameters(tflow, jstate.params, atol=1e-8)


# ------------------------------------------------------ dispatch, structure


def test_unaf_dispatch(monkeypatch):
    """Under ``=1`` a UNAF dispatches to the NAF class, whose layout names
    the UMNN layers; ``auto`` keeps CPU parameters unfused; an inverted UNAF
    keeps the unfused path, as an inverted NAF does."""
    _, tflow, F, _ = _pair("unaf")
    monkeypatch.setenv("ZUKO_TPU_TORCH_FUSED_DISPATCH", "auto")
    assert type(tflow(None)) is NormalizingFlow
    monkeypatch.setenv("ZUKO_TPU_TORCH_FUSED_DISPATCH", "1")
    dist = tflow(None)
    assert type(dist) is FusedNeuralSamplingFlow
    assert [e[4] for e in dist._flat[1] if e[0] == "ar"] == ["umnn", "umnn"]
    inverted = Flow(tflow.transform.inv, tflow.base)
    dist = inverted(None)
    assert type(dist) is NormalizingFlow
    with torch.no_grad():
        assert dist.log_prob(torch.zeros(2, F, dtype=torch.float64)).shape == (2,)


def test_other_integrands_are_not_fused(monkeypatch):
    """An integrand with another activation than ELU raises
    :class:`FusedStructureError` and the flow keeps the unfused path."""
    torch.manual_seed(0)
    flow = zt.UNAF(3, transforms=2, signal=4, network={"activation": torch.tanh}, device="cpu")
    with pytest.raises(FusedStructureError, match="UMNN integrand"):
        torch_naf.extract_naf_params(flow)
    monkeypatch.setenv("ZUKO_TPU_TORCH_FUSED_DISPATCH", "1")
    assert type(flow(None)) is NormalizingFlow


# ---------------------------------------------------------------- assets


def _flagship():
    return zuko_tpu.flows.UNAF(6, 0, transforms=3, signal=16, key=jax.random.PRNGKey(0))


def test_flagship_weights_regenerate_from_zuko_tpu():
    """``unaf_flagship.npz`` is ``zuko_tpu``'s ``UNAF(6, 0, transforms=3,
    signal=16, key=PRNGKey(0))``: every array, bit for bit, and the port
    loads it one to one (47 arrays of 163,536 floats, the MADE masks and the
    base's buffers included)."""
    buffer = io.BytesIO()
    save_params(buffer, _flagship())
    buffer.seek(0)
    with np.load(buffer) as fresh, np.load(ASSETS / "unaf_flagship.npz") as committed:
        assert sorted(fresh.files) == sorted(committed.files)
        for k in fresh.files:
            np.testing.assert_array_equal(fresh[k], committed[k], err_msg=k)
        weights = {k: committed[k] for k in committed.files}
    flow = zt.UNAF(6, 0, transforms=3, signal=16, device="cpu")
    load_params(flow, weights)
    assert sum(v.numel() for v in flow.state_dict().values()) == 163536
    assert len(flow.state_dict()) == len(weights) == 47


def test_flagship_truth_regenerates_from_zuko_tpu(monkeypatch):
    """``unaf_truth_f64.npz`` holds 4,096 standard-normal rows (numpy seed
    0), ``zuko_tpu``'s float64 unfused ``log_prob`` of them on the flagship
    (``lp``, GL-32) and its fused float64 math (``lp_gl16``, GL-16): a
    subset of each regenerates to 1e-12, and the port reproduces them,
    unfused and fused, to 1e-10. The gap between the two rules, on the
    record here: median 1.2e-7, 99th percentile 1.6e-6, max 3.4e-6 (at a
    row with |x| = 2.8); held below 1e-5."""
    with np.load(ASSETS / "unaf_truth_f64.npz") as data:
        x, lp, lp16 = data["x"], data["lp"], data["lp_gl16"]
    assert x.shape == (4096, 6) and lp.shape == lp16.shape == (4096,)
    assert x.dtype == lp.dtype == lp16.dtype == np.float64
    np.testing.assert_array_equal(x, np.random.default_rng(0).standard_normal((4096, 6)))
    assert np.abs(lp - lp16).max() < 1e-5
    rows = slice(0, 4096, 256)
    jflow = _f64(_flagship())
    flow = load_params(zt.UNAF(6, 0, transforms=3, signal=16, device="cpu").double(),
                       ASSETS / "unaf_flagship.npz")
    for fused, want in ((False, lp), (True, lp16)):
        _dispatch(monkeypatch, fused)
        jlp = jax.jit(lambda x_: jflow(None).log_prob(x_))(jnp.asarray(x[rows]))
        np.testing.assert_allclose(np.asarray(jlp), want[rows], rtol=0, atol=1e-12)
        with torch.no_grad():
            got = flow(None).log_prob(torch.as_tensor(x[rows])).numpy()
        np.testing.assert_allclose(got, want[rows], rtol=0, atol=1e-10)
