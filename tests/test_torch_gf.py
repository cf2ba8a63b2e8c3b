r"""Parity of the port's Gaussianization flow (``zuko_tpu_torch.flows.GF`` and
what it is built from) with ``zuko_tpu`` on the CPU.

Both packages build the same model: ``zuko_tpu`` from a PRNG key, the port
from its ``zuko_tpu.serial.save_params`` checkpoint through ``load_params``.
Inputs and base draws are made with numpy from a seed and handed to both.
Everything runs in float64 on the CPU, where the port's kernel wrappers take
their plain versions and ``zuko_tpu``'s fused path its jnp fallback.

Tolerances, each with its reason, stand beside the tests. In short: closed
forms agree to 1e-9 or better (exact ``erf`` on both sides); ``zuko_tpu``'s
*fused* fallback keeps the approximate ``erf`` / ``erfinv`` pair of its TPU
kernel, so the port agrees with it to 5e-4 only, that package's own bound;
inverses agree to the solve's contract, and samples by quantiles, because a
tail target pegs at the bracket and a plateau of the mixture leaves the root
ill-conditioned, both by design.
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
from zuko_tpu.flows import gaussianization as jax_gaussianization
from zuko_tpu.ops import gf_fused as jax_gf
from zuko_tpu.parallel import train as jax_train
from zuko_tpu.serial import save_params
from zuko_tpu_torch import transforms as torch_transforms
from zuko_tpu_torch.distributions import NormalizingFlow
from zuko_tpu_torch.flows import ElementWiseTransform
from zuko_tpu_torch.lazy import Flow, UnconditionalDistribution
from zuko_tpu_torch.ops import gf_fused as torch_gf
from zuko_tpu_torch.ops import ift as torch_ift
from zuko_tpu_torch.ops.dispatch import FusedAutoregressiveFlow, FusedGaussianizationFlow
from zuko_tpu_torch.ops.nsf_fused import FusedStructureError
from zuko_tpu_torch.parallel import make_mle_step, make_reverse_kl_step
from zuko_tpu_torch.serial import load_params, to_torch_name

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


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


def _f64(tree, factor=1.0):
    return jax.tree_util.tree_map(
        lambda a: (a * factor).astype(jnp.float64)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def _carry(jmodule, tmodule):
    """``jmodule``'s arrays into ``tmodule`` through the checkpoint format."""
    buffer = io.BytesIO()
    save_params(buffer, jmodule)
    buffer.seek(0)
    with np.load(buffer) as data:
        return load_params(tmodule.double(), {k: data[k] for k in data.files})


# name -> (features, context, transforms, components)
CASES = {"gf": (4, 0, 3, 5), "gf_context": (4, 3, 2, 5)}
HIDDEN = (16, 16)
_PAIRS = {}


def _pair(name, damp=1.0):
    """The same GF in both packages, its parameters multiplied by ``damp``;
    the port's in float64 on the CPU. Built once per ``(name, damp)``."""
    if (name, damp) not in _PAIRS:
        F, C, T, K = CASES[name]
        kwargs = {"hidden_features": HIDDEN} if C else {}
        jflow = zuko_tpu.flows.GF(
            F, C, transforms=T, components=K, key=jax.random.PRNGKey(0), **kwargs)
        params, static = partition(jflow)
        jflow = combine(_f64(params, damp), static)
        tflow = _carry(jflow, zt.GF(F, C, transforms=T, components=K, device="cpu", **kwargs))
        _PAIRS[name, damp] = (jflow, tflow)
    return (*_PAIRS[name, damp], *CASES[name][:2])


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


@pytest.mark.parametrize("normalize", [False, True], ids=["plain", "normalize"])
def test_mlp_matches_zuko_tpu(normalize):
    """1e-10: three products of width 16 and, with ``normalize``, the
    unbiased variance of ``LayerNorm``."""
    jnet = jax_nn.MLP(3, 5, HIDDEN, normalize=normalize, key=jax.random.PRNGKey(1))
    tnet = _carry(jnet, zt.nn.MLP(3, 5, HIDDEN, normalize=normalize, device="cpu"))
    assert [type(m).__name__ for m in tnet.layers].count("LayerNorm") == 2 * normalize
    x = np.random.default_rng(0).standard_normal((7, 3))
    np.testing.assert_allclose(
        tnet(torch.as_tensor(x)).detach().numpy(), np.asarray(_f64(jnet)(jnp.asarray(x))),
        rtol=1e-10, atol=1e-10)


def test_gaussianization_transform_matches_zuko_tpu():
    """Forward and analytic ladj to 1e-10; the inverse to the solve's
    contract (both stop once every element moves by less than 1e-6)."""
    rng = np.random.default_rng(1)
    shift, raw = rng.standard_normal((5, 8)), 0.5 * rng.standard_normal((5, 8))
    x = rng.standard_normal((7, 5))
    jt = jax_transforms.GaussianizationTransform(jnp.asarray(shift), jnp.asarray(raw))
    tt = torch_transforms.GaussianizationTransform(torch.as_tensor(shift), torch.as_tensor(raw))
    jy, jl = jt.call_and_ladj(jnp.asarray(x))
    ty, tl = tt.call_and_ladj(torch.as_tensor(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(tt(torch.as_tensor(x)).numpy(), np.asarray(jy), atol=1e-10)
    jx, jli = jt.inverse_and_ladj(jy)
    tx, tli = tt.inverse_and_ladj(ty)
    np.testing.assert_allclose(tx.numpy(), x, rtol=0, atol=1e-6)
    # each side stops within its own 1e-6 of the root; zuko_tpu's lands 2e-6
    # from x here
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=5e-6)
    np.testing.assert_allclose(tli.numpy(), np.asarray(jli), rtol=0, atol=5e-5)
    # the analytic ladj is the generic one (differentiating f) where that
    # does not underflow
    _, generic = torch_transforms.MonotonicTransform.call_and_ladj(tt, torch.as_tensor(x))
    np.testing.assert_allclose(generic.detach().numpy(), tl.numpy(), rtol=1e-10, atol=1e-10)


def test_rotation_transform_matches_zuko_tpu():
    A = np.random.default_rng(2).standard_normal((4, 4))
    x = np.random.default_rng(3).standard_normal((6, 4))
    jt = jax_transforms.RotationTransform(jnp.asarray(A))
    tt = torch_transforms.RotationTransform(torch.as_tensor(A))
    ty, tl = tt.call_and_ladj(torch.as_tensor(x))
    jy, jl = jt.call_and_ladj(jnp.asarray(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-10, atol=1e-10)
    assert tl.shape == (6,) and not tl.any() and not np.asarray(jl).any()
    tx, tli = tt.inverse_and_ladj(ty)
    np.testing.assert_allclose(tx.numpy(), x, rtol=1e-10, atol=1e-10)
    assert not tli.any()
    R = tt.R.numpy()
    np.testing.assert_allclose(R @ R.T, np.eye(4), atol=1e-12)


@pytest.mark.parametrize("context", [0, 3], ids=["plain", "context"])
def test_elementwise_transform_matches_zuko_tpu(context):
    """The default affine univariate: closed forms both ways, 1e-10."""
    jt = jax_gaussianization.ElementWiseTransform(3, context, key=jax.random.PRNGKey(2))
    tt = _carry(jt, ElementWiseTransform(3, context, device="cpu"))
    names = [k for k, _ in tt.named_parameters()]
    assert names == (["phi.0", "phi.1"] if not context else [
        f"hyper.layers.{i}.{w}" for i in (0, 2, 4) for w in ("weight", "bias")])
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, 3))
    c = rng.standard_normal((5, context)) if context else None
    jc, tc = (None, None) if c is None else (jnp.asarray(c), torch.as_tensor(c))
    jy, jl = _f64(jt)(jc).call_and_ladj(jnp.asarray(x))
    ty, tl = tt(tc).call_and_ladj(torch.as_tensor(x))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), rtol=1e-10, atol=1e-10)
    assert tl.shape == (5,)
    tx, tli = tt(tc).inverse_and_ladj(ty)
    np.testing.assert_allclose(tx.detach().numpy(), x, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(tli.detach().numpy(), -np.asarray(jl), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("context", [0, 2], ids=["plain", "context"])
@pytest.mark.parametrize("cls", ["MAF", "NSF"])
def test_single_feature_flows_match_zuko_tpu(cls, context, monkeypatch):
    """One feature: nothing to mask, so both packages build an
    ``ElementWiseTransform``. Values to 1e-10."""
    _dispatch(monkeypatch, False)
    kwargs = dict(transforms=2, hidden_features=HIDDEN)
    jflow = getattr(zuko_tpu, cls)(1, context, key=jax.random.PRNGKey(3), **kwargs)
    tflow = _carry(jflow, getattr(zt, cls)(1, context, device="cpu", **kwargs))
    assert all(type(t) is ElementWiseTransform for t in tflow.transform.transforms)
    rng = np.random.default_rng(5)
    x = 2 * rng.standard_normal((9, 1))
    c = rng.standard_normal((9, context)) if context else None
    jc, tc = (None, None) if c is None else (jnp.asarray(c), torch.as_tensor(c))
    with torch.no_grad():
        got = tflow(tc).log_prob(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(_f64(jflow)(jc).log_prob(jnp.asarray(x))), rtol=1e-10, atol=1e-10)


# ------------------------------------------------------------- the density


DENSITY_CASES = {
    "plain": ("gf", False, (32, 4)),
    "one_context": ("gf_context", False, (32, 4)),
    "batched_context": ("gf_context", True, (6, 4)),
    "broadcast": ("gf_context", True, (5, 6, 4)),  # x over the context batch
}


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("case", list(DENSITY_CASES))
def test_log_prob_matches_zuko_tpu(case, fused, monkeypatch):
    """The port, fused (plain version of the kernel) and unfused, against
    unfused ``zuko_tpu``: 1e-9, closed form with the exact ``erf`` on both
    sides. Against ``zuko_tpu``'s fused fallback: 5e-4, that package's own
    bound for its approximate ``erf`` pair."""
    name, batched, shape = DENSITY_CASES[case]
    jflow, tflow, F, C = _pair(name)
    jc, tc = _context(name, batched)
    x = 1.5 * np.random.default_rng(6).standard_normal(shape)

    _dispatch(monkeypatch, False)
    # traced once, as a whole: the same arithmetic as op by op, a fraction
    # of the time
    expected = np.asarray(jax.jit(lambda x_: jflow(jc).log_prob(x_))(jnp.asarray(x)))
    _dispatch(monkeypatch, fused)
    tdist = tflow(tc)
    assert type(tdist) is (FusedGaussianizationFlow if fused else NormalizingFlow)
    with torch.no_grad():
        got = tdist.log_prob(torch.as_tensor(x)).numpy()
    assert got.shape == shape[:-1] == expected.shape
    np.testing.assert_allclose(got, expected, rtol=1e-9, atol=1e-9)
    if fused:
        jdist = jflow(jc)
        assert type(jdist).__name__ == "FusedGaussianizationFlow"
        np.testing.assert_allclose(
            got, np.asarray(jax.jit(lambda x_: jflow(jc).log_prob(x_))(jnp.asarray(x))), rtol=0,
            atol=5e-4)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("case", ["plain", "batched_context"])
def test_log_prob_gradients_match_zuko_tpu(case, fused, monkeypatch):
    """Gradients of the mean log-density by dotted name, and to ``x``, against
    unfused ``zuko_tpu``: 1e-8 (one more differentiation than the values)."""
    name, batched, shape = DENSITY_CASES[case]
    jflow, tflow, F, C = _pair(name)
    jc, tc = _context(name, batched)
    x = 1.5 * np.random.default_rng(7).standard_normal(shape)
    params, static = partition(jflow)

    _dispatch(monkeypatch, False)
    jgp, jgx = jax.jit(jax.grad(
        lambda p, x_: jnp.mean(combine(p, static)(jc).log_prob(x_)), argnums=(0, 1)))(
        params, jnp.asarray(x))
    _dispatch(monkeypatch, fused)
    tflow.zero_grad()
    tx = torch.tensor(x, requires_grad=True)
    tflow(tc).log_prob(tx).mean().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-8, atol=1e-8)
    got, want = _grads_by_name(jgp, tflow)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-8, atol=1e-8, err_msg=k)


def test_saturated_ladj_stays_finite():
    """With every component saturated (``|s x + b| = 50``) the log-sum-exp
    ladj and its gradients are finite in float32, in the transform and in
    the kernel's plain version, where differentiating ``f`` gives ``-inf``."""
    shift = torch.full((8,), 50.0, requires_grad=True)
    raw = torch.zeros(8, requires_grad=True)
    x = torch.tensor(0.0)
    t = torch_transforms.GaussianizationTransform(shift, raw)
    y, ladj = t.call_and_ladj(x)
    assert bool(torch.isfinite(y)) and bool(torch.isfinite(ladj))
    _, generic = torch_transforms.MonotonicTransform.call_and_ladj(t, x)
    assert float(generic.detach()) == -float("inf")
    (y + ladj).backward()
    assert bool(torch.isfinite(shift.grad).all()) and bool(torch.isfinite(raw.grad).all())
    _, lF = torch_gf._gauss_forward(torch.zeros(1, 4), shift.detach().expand(4, 8),
                                     raw.detach().expand(4, 8))
    assert bool(torch.isfinite(lF).all())
    torch.testing.assert_close(lF[0, 0], ladj.detach())
    # the same value as zuko_tpu's transform, to what the two libraries'
    # float32 erfinv differ by at 1 - 1e-6 (its slope there is 2e5): 2e-4 of
    # a ladj near -1238, the bound zuko_tpu's own test states
    jl = jax_transforms.GaussianizationTransform(
        jnp.full((8,), 50.0, jnp.float32), jnp.zeros((8,), jnp.float32)
    ).call_and_ladj(jnp.asarray(0.0, jnp.float32))[1]
    np.testing.assert_allclose(float(ladj.detach()), float(jl), rtol=2e-4)


def test_gf_truth_parameters_reproduce_its_float64_densities(monkeypatch):
    """``tools/gf_truth_f64.npz`` holds the trained parameters of ``GF(6, 0,
    transforms=3)`` by dotted name, 16,384 rows and their float64 log-density:
    the port reproduces it to 1e-9, fused and unfused. The file holds no
    buffers, so the standard-normal base goes in beside it; without it the
    bridge raises."""
    with np.load(ROOT / "tools" / "gf_truth_f64.npz") as data:
        x, lp = data["x"], data["lp"]
        weights = {k: data[k] for k in data.files if k not in ("x", "lp")}
    assert sorted(weights) == sorted(
        [f"transform.transforms.{i}.phi.{j}" for i in (0, 2, 4) for j in (0, 1)]
        + [f"transform.transforms.{i}.args.0" for i in (1, 3)])
    flow = zt.GF(6, 0, transforms=3, device="cpu").double()
    with pytest.raises(KeyError, match="missing"):
        load_params(flow, weights)
    load_params(flow, {**weights, "base.args.0": np.zeros(6), "base.args.1": np.ones(6)})
    for fused in (True, False):
        _dispatch(monkeypatch, fused)
        with torch.no_grad():
            got = flow(None).log_prob(torch.as_tensor(x, dtype=torch.float64)).numpy()
        np.testing.assert_allclose(got, lp, rtol=0, atol=1e-9)


# ---------------------------------------------------------------- sampling


def _quantile_contract(got, want):
    """Samples agree by quantiles: where a layer saturates the inverse is
    ill-conditioned and tail targets peg at the bracket, on both sides."""
    e = np.abs(np.asarray(got) - np.asarray(want))
    assert np.median(e) <= 1e-5, np.median(e)
    assert np.quantile(e, 0.95) <= 1e-2, np.quantile(e, 0.95)


@pytest.mark.parametrize("name", list(CASES))
def test_sampling_from_fixed_draws_matches_zuko_tpu(name, monkeypatch):
    """Parameters damped by 0.3 (a random-init GF saturates). The port's
    plain sampling kernel against ``zuko_tpu``'s fused fallback and against
    both unfused inverses, from the same ``z``."""
    jflow, tflow, F, C = _pair(name, 0.3)
    jc, tc = _context(name, True)
    n = 6 if C else 128
    z = np.random.default_rng(8).standard_normal((n, F))

    flat = torch_gf._flatten_gf(tflow, tc)
    params, layout = torch_gf._row_params(flat[0], flat[1], (n,)), flat[1]
    x = torch_gf.gf_sample(torch.as_tensor(z), params, layout, F)
    x2, lq = torch_gf.gf_sample(torch.as_tensor(z), params, layout, F, True)
    assert x.shape == (n, F) and lq.shape == (n,) and not x.requires_grad
    assert torch.equal(x, x2)

    jflat, jlayout, _, cols = jax_gf._flatten_gf(jflow, jc)
    zf = jnp.asarray(z) if cols is None else jnp.concatenate([jnp.asarray(z), cols], axis=1)
    jx, jlq = jax_gf._gf_sample_core(jlayout, F, True, zf, list(jflat))
    _quantile_contract(x, jx)
    # log q: the approximate erf pair of the fallback, as for the density
    assert np.median(np.abs(lq.numpy() - np.asarray(jlq))) <= 5e-4

    _dispatch(monkeypatch, False)
    with torch.no_grad():
        ux, uladj = tflow(tc).transform.inverse_and_ladj(torch.as_tensor(z))
    _quantile_contract(x, ux)
    _quantile_contract(x, jflow(jc).transform.inverse(jnp.asarray(z)))
    # log q of the plain kernel against the density at the drawn points, and
    # against the unfused pair: the median row is solved to the last bit
    lp = torch_gf.fused_gf_log_prob(flat, x)
    assert float((lq - lp).abs().median()) <= 1e-6
    base = -0.5 * (z**2).sum(axis=1) - 0.5 * F * np.log(2 * np.pi)
    assert np.median(np.abs(lq.numpy() - (base - uladj.numpy()))) <= 1e-5


@pytest.mark.parametrize("batched", [False, True], ids=["plain", "batched_context"])
def test_sampling_through_the_public_api(batched, monkeypatch):
    """Shapes are ``sample_shape + context batch + (F,)``; the same
    generator state gives ``sample``, ``sample_and_log_prob`` and ``rsample``
    the same ``x`` exactly."""
    _dispatch(monkeypatch, True)
    name = "gf_context" if batched else "gf"
    _, tflow, F, C = _pair(name, 0.3)
    _, tc = _context(name, batched)
    dist = tflow(tc)
    assert isinstance(dist, FusedGaussianizationFlow)
    batch = (6,) if batched else ()

    def gen():
        return torch.Generator().manual_seed(5)

    x = dist.sample((7,), gen())
    x2, lq = dist.sample_and_log_prob((7,), gen())
    xr = dist.rsample((7,), gen())
    xr2, lqr = dist.rsample_and_log_prob((7,), gen())
    assert x.shape == (7, *batch, F) and lq.shape == (7, *batch)
    assert not x.requires_grad and not lq.requires_grad and xr.requires_grad and lqr.requires_grad
    for other in (x2, xr.detach(), xr2.detach()):
        assert torch.equal(x, other)
    assert torch.equal(lq, lqr.detach())
    assert dist.sample(generator=gen()).shape == (*batch, F)
    with torch.no_grad():
        assert float((lq - dist.log_prob(x)).abs().median()) <= 1e-6


# ----------------------------------------------------------- IFT gradients


IFT_CASES = {"plain": ("gf", False), "one_context": ("gf_context", False),
             "batched_context": ("gf_context", True)}


def _max_relative(got, want):
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-12)


@pytest.mark.parametrize("case", list(IFT_CASES))
def test_ift_gradients_match_zuko_tpu_and_unfused_autograd(case, monkeypatch):
    """``rsample_and_log_prob`` gradients, parameters damped by 0.2, from
    the draws ``zuko_tpu`` makes from its key. Against autograd through the
    unfused inverse (Newton steps, the implicit rule per element) of
    ``zuko_tpu`` and of the port: max-relative 1e-4 (the roots of the two
    solvers sit up to 1e-6 apart). Against ``zuko_tpu``'s own IFT:
    max-relative 1e-2, the bound its test holds this tier to (its fallback
    solves with the approximate ``erf`` pair; 1.7e-3 at a rotation here)."""
    name, batched = IFT_CASES[case]
    jflow, tflow, F, C = _pair(name, 0.2)
    jc, tc = _context(name, batched)
    key, shape = jax.random.PRNGKey(4), (16,)
    params, static = partition(jflow)

    def jloss(p):
        x, lq = combine(p, static)(jc).rsample_and_log_prob(key, shape)
        return jnp.mean(lq) + jnp.mean(jnp.sum(x**2, -1)), (x, lq)

    wants = {}
    for fused in (True, False):
        _dispatch(monkeypatch, fused)
        assert (type(jflow(jc)).__name__ == "FusedGaussianizationFlow") == fused
        (jvalue, (jx, jlq)), jgp = jax.value_and_grad(jloss, has_aux=True)(params)
        wants[fused] = (float(jvalue), jgp)
    z = np.asarray(jax_gf._gf_prep_sample(jflow, key, shape, jc)[3])[:, :F]
    monkeypatch.setattr(torch, "randn", lambda shape, **kw: torch.tensor(z).reshape(shape))

    grads = {}
    for fused in (True, False):
        _dispatch(monkeypatch, fused)
        tflow.zero_grad()
        dist = tflow(tc)
        assert isinstance(dist, FusedGaussianizationFlow) == fused
        x, lq = dist.rsample_and_log_prob(shape)
        assert x.shape == jx.shape and lq.shape == jlq.shape
        loss = lq.mean() + (x**2).sum(dim=-1).mean()
        loss.backward()
        np.testing.assert_allclose(float(loss), wants[False][0], rtol=0, atol=1e-5)
        np.testing.assert_allclose(float(loss), wants[True][0], rtol=0, atol=1e-3)
        grads[fused], _ = _grads_by_name(wants[False][1], tflow)
    _, unfused = _grads_by_name(wants[False][1], tflow)
    _, jax_ift_grads = _grads_by_name(wants[True][1], tflow)
    for k, got in grads[True].items():
        assert _max_relative(got, unfused[k]) <= 1e-4, k
        assert _max_relative(got, grads[False][k]) <= 1e-4, k
        assert _max_relative(got, jax_ift_grads[k]) <= 1e-2, k
        assert np.abs(got).max() > 0


def test_ift_gates_a_pegged_row():
    """A target the saturated mixture cannot reach pegs at the bracket; the
    IFT gives that row no cotangent and the others theirs."""
    _, tflow, F, _ = _pair("gf", 0.2)
    params, layout, _, _ = torch_gf._flatten_gf(tflow)
    z = torch.tensor(np.random.default_rng(9).standard_normal((4, F)))
    z[0, 0] = 7.0  # beyond sqrt(2) erfinv(1 - 1e-6) = 4.89
    z.requires_grad_(True)
    x, lq = torch_ift._GFIFTFunction.apply(z, (layout, F), True, *params)
    assert abs(abs(float(x.detach().abs().max())) - 10.0) < 1e-6
    (lq.sum() + (x**2).sum()).backward()
    assert not z.grad[0].any() and bool(z.grad[1:].abs().sum(dim=1).gt(0).all())


# ---------------------------------------------------------------- training


def _assert_same_parameters(tflow, jparams, atol):
    expected = {to_torch_name(k): np.asarray(v) for k, v in named_parameters(jparams)}
    got = dict(tflow.named_parameters())
    assert sorted(got) == sorted(expected)
    for k, p in got.items():
        np.testing.assert_allclose(p.detach().numpy(), expected[k], rtol=0, atol=atol, err_msg=k)


def _fresh(name, damp):
    """A pair whose port flow this test may train in place."""
    _PAIRS.pop((name, damp), None)
    pair = _pair(name, damp)
    _PAIRS.pop((name, damp))
    return pair


@pytest.mark.parametrize("name", list(CASES))
def test_mle_step_matches_zuko_tpu(name, monkeypatch):
    """One Adam step of maximum likelihood, fused in the port against unfused
    ``zuko_tpu`` (exact ``erf`` on both sides): loss to 1e-10, every updated
    parameter to 1e-8."""
    jflow, tflow, F, C = _fresh(name, 1.0)
    jc, tc = _context(name, True, rows=32)
    x = 1.5 * np.random.default_rng(10).standard_normal((32, F))
    params, static = partition(jflow)

    _dispatch(monkeypatch, False)
    jinit, jstep = jax_train.make_mle_step(static, lr=1e-3)
    jstate, jloss = jstep(jinit(params), jnp.asarray(x), jc)
    monkeypatch.setenv("ZUKO_TPU_TORCH_FUSED_DISPATCH", "1")
    tinit, tstep = make_mle_step(tflow, lr=1e-3)
    assert isinstance(tflow(tc), FusedGaussianizationFlow)
    tstate, tloss = tstep(tinit(), torch.as_tensor(x), tc)
    assert tstate.step == 1
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-10, atol=1e-10)
    _assert_same_parameters(tflow, jstate.params, atol=1e-8)


def test_reverse_kl_step_matches_zuko_tpu(monkeypatch):
    """One Adam step of reverse KL on the ring energy, parameters damped by
    0.2, from ``zuko_tpu``'s base draws: the port through the GF tier of the
    IFT against unfused ``zuko_tpu`` (exact ``erf`` on both sides, roots up
    to 1e-6 apart). The loss to 1e-5; the updated parameters to 1e-8: Adam's
    first step is ``lr * g / (|g| + 1e-8)``, so a gradient's relative error
    of 1e-4 moves it by 1e-4 * lr * 1e-8 / |g|."""
    CASES["gf2"] = (2, 0, 2, 5)
    try:
        jflow, tflow, F, _ = _fresh("gf2", 0.2)
    finally:
        del CASES["gf2"]
    params, static = partition(jflow)
    key, n = jax.random.PRNGKey(2), 48
    z = np.asarray(jax_gf._gf_prep_sample(jflow, key, (n,), None)[3])
    monkeypatch.setattr(torch, "randn", lambda shape, **kw: torch.tensor(z).reshape(shape))

    _dispatch(monkeypatch, False)
    jinit, jstep = jax_train.make_reverse_kl_step(
        static, zuko_tpu.data.ring_energy, n_samples=n, lr=1e-3)
    jstate, jloss = jstep(jinit(params), key)
    monkeypatch.setenv("ZUKO_TPU_TORCH_FUSED_DISPATCH", "1")
    tinit, tstep = make_reverse_kl_step(tflow, zt.data.ring_energy, n_samples=n, lr=1e-3)
    assert isinstance(tflow(None), FusedGaussianizationFlow)
    tstate, tloss = tstep(tinit())
    assert tstate.step == 1
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=0, atol=1e-5)
    _assert_same_parameters(tflow, jstate.params, atol=1e-8)


# ---------------------------------------------------------------- dispatch


def test_gf_dispatch(monkeypatch):
    """Under ``=1`` a GF dispatches to the GF class and an NSF to its own;
    ``auto`` keeps CPU parameters unfused; an inverted GF, a trainable base
    and another univariate keep the unfused path."""
    _, tflow, F, _ = _pair("gf")
    _, cflow, _, _ = _pair("gf_context")
    monkeypatch.setenv("ZUKO_TPU_TORCH_FUSED_DISPATCH", "auto")
    assert type(tflow(None)) is NormalizingFlow
    monkeypatch.setenv("ZUKO_TPU_TORCH_FUSED_DISPATCH", "1")
    assert type(tflow(None)) is FusedGaussianizationFlow
    assert type(cflow(torch.zeros(3, dtype=torch.float64))) is FusedGaussianizationFlow
    assert type(cflow(torch.zeros(2, 5, 3, dtype=torch.float64))) is FusedGaussianizationFlow

    torch.manual_seed(0)
    nsf = zt.NSF(3, 0, transforms=1, hidden_features=HIDDEN, device="cpu")
    assert type(nsf(None)) is FusedAutoregressiveFlow
    with pytest.raises(FusedStructureError, match="ElementWiseTransform and rotation"):
        torch_gf.extract_gf_params(nsf)

    inverted = Flow(tflow.transform.inv, tflow.base)
    dist = inverted(None)
    assert type(dist) is NormalizingFlow
    z = torch.zeros(2, F, dtype=torch.float64)
    with torch.no_grad():  # the inverted flow's density is the flow's solve
        assert dist.log_prob(z).shape == (2,)

    trainable = Flow(tflow.transform, UnconditionalDistribution(
        zt.distributions.DiagNormal, torch.zeros(F), torch.ones(F)))
    with pytest.raises(FusedStructureError):
        torch_gf.extract_gf_params(trainable)
    assert type(trainable(None)) is NormalizingFlow

    affine = Flow([ElementWiseTransform(F, device="cpu")], tflow.base)
    with pytest.raises(FusedStructureError, match="GaussianizationTransform"):
        torch_gf.extract_gf_params(affine)
    assert type(affine(None)) is NormalizingFlow

    with pytest.raises(FusedStructureError, match="without context"):
        torch_gf.extract_gf_params(cflow)
    with pytest.raises(FusedStructureError, match="features"):
        tflow(None).log_prob(torch.zeros(2, F + 1, dtype=torch.float64))
