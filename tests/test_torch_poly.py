r"""Parity of the port's polynomial flows (``zuko_tpu_torch.flows.SOSPF`` and
``BPF``, the ``sosp`` and ``bernstein`` modes of the whole-flow NSF kernels'
plain versions, and what they are built from) with ``zuko_tpu`` on the CPU.

Both packages build the same model: ``zuko_tpu`` from a PRNG key, the port
from its ``zuko_tpu.serial.save_params`` checkpoint through ``load_params``.
Inputs and base draws are made with numpy from a seed and handed to both.
Everything runs in float64, where the port's kernel wrappers take their
plain versions and ``zuko_tpu``'s fused entry points their jnp math. The
fused solve is ``zuko_tpu``'s own (bisection on the exact forward, Newton
steps, warm-started later sweeps), so the samples agree to roundoff, not to
a solver's tolerance. Each ``zuko_tpu`` flow is built once per module and
its jitted functions traced once; the degree-16 flagship BPF is only
evaluated, never sampled or differentiated in JAX.
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

from zuko_tpu import transforms as jax_transforms
from zuko_tpu.core import combine, named_parameters, partition
from zuko_tpu.ops import nsf_fused as jax_fused
from zuko_tpu.parallel import train as jax_train
from zuko_tpu.serial import save_params
from zuko_tpu_torch.distributions import NormalizingFlow
from zuko_tpu_torch.lazy import Flow, UnconditionalTransform
from zuko_tpu_torch.ops import _common
from zuko_tpu_torch.ops import nsf_fused as torch_fused
from zuko_tpu_torch.ops.dispatch import (
    FusedAutoregressiveFlow,
    FusedDensityFlow,
    FusedInvertedAutoregressiveFlow,
    maybe_fused_flow,
)
from zuko_tpu_torch.ops.nsf_fused import FusedStructureError
from zuko_tpu_torch.parallel import make_mle_step, make_reverse_kl_step
from zuko_tpu_torch.serial import load_params, to_torch_name
from zuko_tpu_torch.transforms import SoftclipTransform

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


# name -> (family, features, context, extra keyword arguments)
CASES = {
    "sospf": ("SOSPF", 3, 0, {"degree": 2, "polynomials": 2}),
    "sospf_context": ("SOSPF", 3, 2, {"degree": 2, "polynomials": 2}),
    "bpf": ("BPF", 3, 0, {"degree": 4}),
    "bpf_context": ("BPF", 3, 2, {"degree": 4}),
}
HIDDEN = (16, 16)
ROWS = 16


def _build(name, key=0):
    """The same small flow in both packages, the port's in float64 on the
    CPU."""
    family, F, C, kw = CASES[name]
    jflow = _f64(getattr(zuko_tpu.flows, family)(
        F, C, transforms=2, hidden_features=HIDDEN, key=jax.random.PRNGKey(key), **kw))
    tflow = _carry(jflow, getattr(zt, family)(
        F, C, transforms=2, hidden_features=HIDDEN, device="cpu", **kw))
    return jflow, tflow


@functools.lru_cache(maxsize=None)
def _pair(name):
    """:func:`_build` once per module and name (tests that train build
    their own)."""
    return (*_build(name), *CASES[name][1:3])


def _inputs(name, seed=0, batched=True):
    """``(x, c)``: standard-normal rows and a batched context (or one
    context vector, or ``None``)."""
    _, F, C, _ = CASES[name]
    rng = np.random.default_rng(seed)
    x = 1.5 * rng.standard_normal((ROWS, F))
    if not C:
        return x, None
    return x, rng.standard_normal((ROWS, C) if batched else (C,))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.as_tensor(a)


def _grads_by_name(jgrads, tflow):
    want = {to_torch_name(k): np.asarray(g) for k, g in named_parameters(jgrads)}
    got = {k: p.grad.numpy() for k, p in tflow.named_parameters()}
    assert sorted(got) == sorted(want)
    return got, want


# ------------------------------------------------------------- transforms


def _bernstein(cls, theta):
    jt = getattr(jax_transforms, cls)(jnp.asarray(theta))
    tt = getattr(zt.transforms, cls)(torch.as_tensor(theta))
    return jt, tt


@pytest.mark.parametrize("cls", ["BernsteinTransform", "BoundedBernsteinTransform",
                                 "SOSPolynomialTransform"])
def test_transforms_match_zuko_tpu(cls):
    """Forward and log-Jacobian to 1e-10, the inverse (the transforms' own
    safeguarded Newton solve, to 1e-6 in x on both sides) to 1e-6, and the
    round trip: inputs inside the bounds and beyond them, where a Bernstein
    polynomial is its line."""
    rng = np.random.default_rng(3)
    if cls == "SOSPolynomialTransform":
        a = 0.5 * rng.standard_normal((5, 2, 3))
        jt = jax_transforms.SOSPolynomialTransform(jnp.asarray(a))
        tt = zt.transforms.SOSPolynomialTransform(torch.as_tensor(a))
        x = np.array([-9.5, -3.0, 0.0, 2.5, 9.0])
    else:
        jt, tt = _bernstein(cls, rng.standard_normal((5, 7)))
        x = np.array([-6.0, -2.0, 0.3, 4.999999, 5.5])
    jy, jl = jax.jit(jt.call_and_ladj)(jnp.asarray(x))
    ty, tl = tt.call_and_ladj(torch.as_tensor(x))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), rtol=1e-10, atol=1e-10)
    y = np.asarray(jy)
    jx = np.asarray(jax.jit(jt.inverse)(jnp.asarray(y)))
    tx, til = tt.inverse_and_ladj(torch.as_tensor(y))
    np.testing.assert_allclose(tx.detach().numpy(), jx, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tx.detach().numpy(), x, rtol=0, atol=1e-6)
    np.testing.assert_allclose(til.detach().numpy(), -np.asarray(jl), rtol=0, atol=1e-5)


def test_bernstein_inverse_gradients_are_implicit():
    """The inverse's gradients to the raw coefficients go through the
    implicit-function rule of the solve: ``d/dtheta f(x(theta)) = 0`` at a
    fixed target, so the round trip's gradient vanishes."""
    theta = torch.randn(4, 6, dtype=torch.float64, requires_grad=True)
    t = zt.transforms.BoundedBernsteinTransform(theta)
    y = torch.tensor([-3.0, -1.0, 0.5, 2.0], dtype=torch.float64)
    x = t.inverse(y)
    (back,) = torch.autograd.grad(t(x).sum(), theta)
    assert back.abs().max() < 1e-10


# ------------------------------------------------------------------ flows


@pytest.mark.parametrize("name", list(CASES))
def test_unfused_log_prob_matches_zuko_tpu(name, monkeypatch):
    """The unfused flows (the transforms above inside the autoregressive
    layers, SOSPF's softclips between them), dispatch off on both sides:
    1e-10."""
    jflow, tflow, F, C = _pair(name)
    x, c = _inputs(name)
    _dispatch(monkeypatch, False)
    tdist = tflow(_t(c))
    assert type(tdist) is NormalizingFlow
    with torch.no_grad():
        got = tdist.log_prob(torch.as_tensor(x)).numpy()
    want = jax.jit(lambda x_, c_: jflow(c_).log_prob(x_))(jnp.asarray(x), _j(c))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("name, batched", [
    ("sospf", True), ("sospf_context", False), ("sospf_context", True), ("bpf", True),
    ("bpf_context", True),
], ids=["sospf", "sospf_one_context", "sospf_batched_context", "bpf", "bpf_batched_context"])
def test_density_and_apply_match_zuko_tpu(name, batched, monkeypatch):
    """K1's plain version (``nsf_density``, what ``FusedDensityFlow.log_prob``
    runs on the CPU) against ``zuko_tpu``'s ``fused_nsf_log_prob``, and K2's
    (``nsf_apply``) against ``fused_nsf_apply``, unconditional or with one
    context or a batched one: 1e-10."""
    jflow, tflow, F, C = _pair(name)
    x, c = _inputs(name, batched=batched)
    _dispatch(monkeypatch, True)
    tdist = tflow(_t(c))
    assert type(tdist) is FusedDensityFlow
    with torch.no_grad():
        got = tdist.log_prob(torch.as_tensor(x)).numpy()
        ty, tl = torch_fused.fused_nsf_apply(tdist._flat, torch.as_tensor(x), _t(c))
    jlp, (jy, jl) = jax.jit(lambda x_, c_: (jax_fused.fused_nsf_log_prob(jflow, x_, c_),
                                            jax_fused.fused_nsf_apply(jflow, x_, c_)))(
        jnp.asarray(x), _j(c))
    np.testing.assert_allclose(got, np.asarray(jlp), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("name", ["sospf", "sospf_context", "bpf", "bpf_context"])
def test_sample_math_matches_zuko_tpu(name):
    """K3's plain version from the same base draws (a third of them beyond
    the polynomials' reach at scale 3, where SOSPF's solve pegs and BPF's
    takes its line) against ``zuko_tpu``'s ``_sample_math_T`` with log q, in
    all three modes: ``x`` (every mode runs the same solve), log q, and the
    bare sum of ladjs against ``zuko_tpu``'s log q less the base term;
    1e-9. One trace of ``zuko_tpu``'s sampler a case keeps the JAX side
    cheap."""
    jflow, tflow, F, C = _pair(name)
    rng = np.random.default_rng(5)
    z = 3 * rng.standard_normal((ROWS, F))
    c = rng.standard_normal((ROWS, C)) if C else None
    fp, layout, cfg = jax_fused._flatten_flow(jflow)
    jx, jlq = jax.jit(lambda zT, cT: jax_fused._sample_math_T(
        zT, fp, layout, F, cfg["bins"], cfg["bound"], cfg["slope"], cT, want_log_prob=True,
        univ=cfg["univ"], base=cfg["base"]))(
            jnp.asarray(z).T, None if c is None else jnp.asarray(c).T)
    jx, jlq = np.asarray(jx).T, np.asarray(jlq)[0]
    # zuko_tpu's raw sum is its log q less the base term, to roundoff
    jraw = jlq + 0.5 * (z**2).sum(axis=1) + 0.5 * F * np.log(2 * np.pi)
    params, tlayout, tcfg = torch_fused._flatten_flow(tflow)
    zc = torch.as_tensor(z if c is None else np.concatenate([z, c], axis=1))
    args = (params, tlayout, *torch_fused._statics(tcfg, F))
    x = torch_fused.nsf_sample(zc, *args, False)
    xl, lq = torch_fused.nsf_sample(zc, *args, True)
    xr, lr = torch_fused.nsf_sample(zc, *args, "raw")
    for got in (x, xl, xr):
        np.testing.assert_allclose(got.numpy(), jx, rtol=0, atol=1e-9)
    np.testing.assert_allclose(lq.numpy(), jlq, rtol=0, atol=1e-9)
    np.testing.assert_allclose(lr.numpy(), jraw, rtol=0, atol=1e-9)


# ------------------------------------------------ extraction and dispatch


def test_dispatch_routes_the_polynomial_flows(monkeypatch):
    """``maybe_fused_flow`` gives SOSPF and BPF :class:`FusedDensityFlow`
    (an :class:`FusedAutoregressiveFlow`), their inverted flows
    :class:`FusedInvertedAutoregressiveFlow`; SOSPF's layout holds its
    softclips, each right after an autoregressive layer; ``auto`` keeps CPU
    parameters unfused."""
    _dispatch(monkeypatch, True)
    for name in ("sospf", "bpf"):
        _, tflow, F, _ = _pair(name)
        dist = tflow(None)
        assert type(dist) is FusedDensityFlow and isinstance(dist, FusedAutoregressiveFlow)
        assert maybe_fused_flow(tflow, dist.transform, dist.base, None).__class__ is \
            FusedDensityFlow
        params, layout, cfg = dist._flat
        assert cfg["univ"] == ("sosp" if name == "sospf" else "bernstein")
        assert cfg["base"] == ("normal",)
        if name == "sospf":
            assert cfg["bins"] == (2, 3) and cfg["bound"] == 10.0
            assert [e[0] == "softclip" for e in layout] == [False, True, False]
            assert layout[1] == ("softclip", 11.0)
            assert torch_fused._softclip_bounds(layout) == [11.0, 0.0]
        else:
            assert cfg["bins"] == 5 and cfg["bound"] == 5.0
        inverted = Flow(tflow.transform.inv, tflow.base)
        assert type(inverted(None)) is FusedInvertedAutoregressiveFlow
    monkeypatch.setenv("ZUKO_TPU_TORCH_FUSED_DISPATCH", "auto")
    assert type(_pair("bpf")[1](None)) is NormalizingFlow


def test_extraction_rejects_what_zuko_tpu_rejects(monkeypatch):
    """Mixed univariates, a softclip with positional arguments, and (the
    kernels' own layout) a softclip first: :class:`FusedStructureError`,
    and the flow keeps the unfused path."""
    torch.manual_seed(0)
    mixed = zt.SOSPF(3, transforms=2, degree=2, polynomials=2, device="cpu")
    bpf = zt.BPF(3, transforms=1, degree=4, device="cpu")
    mixed.transform.transforms[2] = bpf.transform.transforms[0]
    with pytest.raises(FusedStructureError, match="share a univariate config"):
        torch_fused.extract_nsf_params(mixed)
    positional = zt.SOSPF(3, transforms=2, degree=2, polynomials=2, device="cpu")
    positional.transform.transforms[1] = UnconditionalTransform(SoftclipTransform, 11.0)
    with pytest.raises(FusedStructureError, match="SoftclipTransform"):
        torch_fused.extract_nsf_params(positional)
    first = zt.SOSPF(3, transforms=2, degree=2, polynomials=2, device="cpu")
    first.transform.transforms.insert(0, UnconditionalTransform(SoftclipTransform, bound=11.0))
    with pytest.raises(FusedStructureError, match="right after"):
        torch_fused.extract_nsf_params(first)
    _dispatch(monkeypatch, True)
    for flow in (mixed, positional, first):
        assert type(flow(None)) is NormalizingFlow


def test_launch_counters_name_the_modes():
    """Every mode of the three kernels counts under its own name, in both
    tiers, and the existing names stay as they were."""
    for univ in ("sosp", "bernstein"):
        names = [torch_fused._counter(n, univ) for n in (
            "nsf_density", "nsf_apply", "nsf_sample", "nsf_sample_log_prob", "nsf_sample_raw")]
        assert names == [f"nsf_density_{univ}", f"nsf_apply_{univ}", f"nsf_sample_{univ}",
                         f"nsf_sample_{univ}_log_prob", f"nsf_sample_{univ}_raw"]
        for name in names:
            assert name in _common.WHOLE_FLOW
            assert _common.LAUNCHES[name] == 0 and f"{name}_wide" in _common.LAUNCHES
    assert torch_fused._counter("nsf_sample_log_prob", "rqs") == "nsf_sample_log_prob"


# --------------------------------------------------------------- gradients


@pytest.mark.parametrize("name", ["sospf", "sospf_context", "bpf_context"])
def test_density_gradients_match_zuko_tpu(name, monkeypatch):
    """The gradient of the mean fused log-density to every parameter, the
    inputs and the context, against ``zuko_tpu``'s (autodiff over its jnp
    math, ``_fused_bwd`` :1746): 1e-9."""
    jflow, tflow, F, C = _pair(name)
    x, c = _inputs(name, seed=7)
    params, static = partition(jflow)

    def jloss(p, x_, c_):
        return jnp.mean(jax_fused.fused_nsf_log_prob(combine(p, static), x_, c_))

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2) if C else (0, 1)))(
        params, jnp.asarray(x), _j(c))
    _dispatch(monkeypatch, True)
    tflow.zero_grad()
    tx = torch.as_tensor(x).requires_grad_(True)
    tc = None if c is None else torch.as_tensor(c).requires_grad_(True)
    tflow(tc).log_prob(tx).mean().backward()
    got, want = _grads_by_name(jg[0], tflow)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9, atol=1e-9, err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[1]), rtol=1e-9, atol=1e-9)
    if C:
        np.testing.assert_allclose(tc.grad.numpy(), np.asarray(jg[2]), rtol=1e-9, atol=1e-9)


IFT_CASES = {"sospf": ("sospf", False), "sospf_context": ("sospf_context", True),
             "bpf": ("bpf", False)}


@pytest.mark.parametrize("case", list(IFT_CASES))
def test_ift_gradients_match_zuko_tpu(case, monkeypatch):
    """``rsample_and_log_prob`` through the NSF tier of the IFT (the solve
    forward, three sweeps back, SOSPF's softclips among them), from the
    draws ``zuko_tpu`` makes from its key: the samples to 1e-9, the loss and
    its gradients to every parameter and to a batched context to 1e-8,
    against ``zuko_tpu``'s ``fused_nsf_rsample``."""
    name, batched = IFT_CASES[case]
    jflow, tflow, F, C = _pair(name)
    _, c = _inputs(name, seed=8)
    key, shape = jax.random.PRNGKey(4), (() if batched else (ROWS,))
    params, static = partition(jflow)

    def jloss(p, c_):
        x, lq = combine(p, static)(c_).rsample_and_log_prob(key, shape)
        return jnp.mean(lq) + jnp.mean(jnp.sum(x**2, -1)), x

    _dispatch(monkeypatch, True)
    assert type(jflow(_j(c))).__name__ == "FusedDensityFlow"
    argnums = (0, 1) if C else 0
    (jvalue, jx), jgrads = jax.jit(jax.value_and_grad(jloss, argnums, has_aux=True))(params, _j(c))
    jgp = jgrads[0] if C else jgrads
    z = np.asarray(jax_fused._prep_sample(jflow, key, shape, _j(c))[4])[:, :F]
    monkeypatch.setattr(torch, "randn", lambda shape, **kw: torch.tensor(z).reshape(shape))

    tflow.zero_grad()
    tc = None if c is None else torch.as_tensor(c).requires_grad_(True)
    dist = tflow(tc)
    assert type(dist) is FusedDensityFlow
    x, lq = dist.rsample_and_log_prob(shape)
    np.testing.assert_allclose(x.detach().numpy(), np.asarray(jx), rtol=0, atol=1e-9)
    loss = lq.mean() + (x**2).sum(dim=-1).mean()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jvalue), rtol=0, atol=1e-8)
    got, want = _grads_by_name(jgp, tflow)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-8, atol=1e-8, err_msg=k)
    assert max(np.abs(g).max() for g in got.values()) > 1e-3
    if C:
        np.testing.assert_allclose(tc.grad.numpy(), np.asarray(jgrads[1]), rtol=1e-8, atol=1e-8)


# ---------------------------------------------------------------- training


def _assert_same_parameters(tflow, jparams, atol):
    expected = {to_torch_name(k): np.asarray(v) for k, v in named_parameters(jparams)}
    got = dict(tflow.named_parameters())
    assert sorted(got) == sorted(expected)
    for k, p in got.items():
        np.testing.assert_allclose(p.detach().numpy(), expected[k], rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("kind", ["mle", "reverse_kl"])
def test_sospf_training_steps_match_zuko_tpu(kind, monkeypatch):
    """One Adam step, then two more, fused on both sides: maximum likelihood
    on a batch with a batched context, or reverse KL on the ring energy
    through the IFT from the same base draws. The loss to 1e-8 and every
    updated parameter to 1e-8 after the first and the third step."""
    name = "sospf_context" if kind == "mle" else "sospf"
    jflow, tflow = _build(name)
    params, static = partition(jflow)
    _dispatch(monkeypatch, True)
    if kind == "mle":
        rng = np.random.default_rng(10)
        x, c = 1.5 * rng.standard_normal((ROWS, 3)), rng.standard_normal((ROWS, 2))
        jinit, jstep = jax_train.make_mle_step(static, lr=1e-3)
        tinit, tstep = make_mle_step(tflow, lr=1e-3)
        jargs, targs = (jnp.asarray(x), jnp.asarray(c)), (torch.as_tensor(x), torch.as_tensor(c))
    else:
        key, n = jax.random.PRNGKey(2), 32
        z = np.asarray(jax_fused._prep_sample(jflow, key, (n,), None)[4])
        monkeypatch.setattr(torch, "randn", lambda shape, **kw: torch.tensor(z).reshape(shape))
        jinit, jstep = jax_train.make_reverse_kl_step(
            static, zuko_tpu.data.ring_energy, n_samples=n, lr=1e-3)
        tinit, tstep = make_reverse_kl_step(tflow, zt.data.ring_energy, n_samples=n, lr=1e-3)
        jargs, targs = (key,), ()
    jstate, tstate = jinit(params), tinit()
    assert type(tflow(targs[1] if kind == "mle" else None)) is FusedDensityFlow
    for step in range(3):
        jstate, jloss = jstep(jstate, *jargs)
        tstate, tloss = tstep(tstate, *targs)
        assert tstate.step == step + 1
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=0, atol=1e-8)
        if step in (0, 2):
            _assert_same_parameters(tflow, jstate.params, atol=1e-8)


# ----------------------------------------------------------------- planner


@pytest.mark.parametrize("univ, K, widths, wide, slots", [
    # the flagships' shapes, and the narrow arrays' edges: T <= 95, L + 1 <=
    # 32 nodes, M + 5 <= 64 coefficients
    ("sosp", (3, 5), [6, 64, 64, 96], False, 0),
    ("sosp", (3, 31), [4, 64, 64, 376], False, 0),
    ("sosp", (3, 32), [4, 64, 64, 388], True, 4 + 4 + 128 + 97),
    ("sosp", (8, 16), [4, 64, 64, 516], True, 4 + 4 + 128 + 129),
    ("sosp", (1, 33), [4, 64, 64, 136], True, 4 + 4 + 128 + 34),
    ("bernstein", 17, [6, 64, 64, 102], False, 0),
    ("bernstein", 59, [4, 64, 64, 236], False, 0),
    ("bernstein", 60, [4, 64, 64, 240], True, 4 + 4 + 128 + 60 + 3 * 65),
    ("bernstein", 121, [4, 64, 64, 484], True, 4 + 4 + 128 + 121 + 3 * 126),
], ids=["sosp_flagship", "sosp_narrow_edge", "sosp_T97", "sosp_T129", "sosp_nodes33",
        "bernstein_flagship", "bernstein_narrow_edge", "bernstein_M60", "bernstein_M121"])
def test_plan_nsf_polynomial_tiers(univ, K, widths, wide, slots):
    """The planner picks the narrow tier while a feature's parameters, the
    Gauss-Legendre nodes and the Bernstein coefficients fit the thread's
    arrays, and otherwise the wide tier, whose workspace holds ``F + C + F
    + 2 max(widths) + T`` floats and three knot columns of ``M + 5`` (none
    for SOSP) a row, and whose descriptor holds the widths, passes, softclip
    bounds and (SOSP) the rule's nodes and weights."""
    plan = torch_fused.plan_nsf(widths, K, univ, 3, 1000)
    assert plan.wide == wide
    if wide:
        nodes = K[1] if univ == "sosp" else 0
        assert plan.slots == slots
        assert plan.desc_bytes == 4 * (len(widths) + 2 * 3 + 2 * nodes)
        assert plan.chunk_rows == 1024 and plan.workspace_bytes == 4 * slots * 1024


# ------------------------------------------------------------------ assets


FLAGSHIPS = {"sospf": ("SOSPF", {"degree": 4, "polynomials": 3}), "bpf": ("BPF", {"degree": 16})}


@pytest.mark.parametrize("name", list(FLAGSHIPS))
def test_flagship_assets_regenerate_from_zuko_tpu(name, monkeypatch):
    """``assets/<name>_flagship.npz`` is ``zuko_tpu``'s flagship
    (``transforms=3``, ``PRNGKey(0)``, the default 64x64 MADE) bit for bit
    and loads into the port one to one; SOSPF's ``assets/sospf_truth_f64.npz``
    holds 4,096 standard-normal rows (numpy seed 0, float32) and
    ``zuko_tpu``'s float64 unfused ``log_prob`` of them, whose first 64 rows
    regenerate to 1e-12 (BPF's truth is ``tools/bpf_truth_f64.npz``: see the
    next test). The port's plain float64 fused density agrees with
    ``zuko_tpu``'s on those rows to 1e-10."""
    family, kw = FLAGSHIPS[name]
    jflow = getattr(zuko_tpu.flows, family)(6, transforms=3, key=jax.random.PRNGKey(0), **kw)
    buffer = io.BytesIO()
    save_params(buffer, jflow)
    buffer.seek(0)
    with np.load(buffer) as fresh, np.load(ASSETS / f"{name}_flagship.npz") as committed:
        assert sorted(fresh.files) == sorted(committed.files)
        for k in fresh.files:
            np.testing.assert_array_equal(fresh[k], committed[k], err_msg=k)
        weights = {k: committed[k] for k in committed.files}
    tflow = load_params(getattr(zt, family)(6, transforms=3, device="cpu", **kw).double(),
                        weights)
    assert len(tflow.state_dict()) == len(weights)
    if name == "sospf":
        with np.load(ASSETS / "sospf_truth_f64.npz") as data:
            x, lp = data["x"], data["lp"]
        assert x.shape == (4096, 6) and x.dtype == np.float32 and lp.dtype == np.float64
        np.testing.assert_array_equal(
            x, np.random.default_rng(0).standard_normal((4096, 6)).astype(np.float32))
    else:
        with np.load(ROOT / "tools" / "bpf_truth_f64.npz") as data:
            x, lp = data["x"], data["lp"]
    x64 = jnp.asarray(x[:64], jnp.float64)
    _dispatch(monkeypatch, False)
    want = np.asarray(jax.jit(lambda x_: _f64(jflow)(None).log_prob(x_))(x64))
    if name == "sospf":
        np.testing.assert_allclose(want, lp[:64], rtol=0, atol=1e-12)
    _dispatch(monkeypatch, True)
    with torch.no_grad():
        got = tflow(None).log_prob(torch.as_tensor(np.asarray(x64))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


def test_bpf_flagship_plain_density_holds_the_committed_truth(monkeypatch):
    """The port's plain float64 density of the flagship BPF against every
    row of ``tools/bpf_truth_f64.npz``, no JAX: 1e-6. That file predates
    ``zuko_tpu``'s De Casteljau form of the polynomial, and ``zuko_tpu``'s
    own float64 ``log_prob`` differs from it by up to 6.2e-7 (median
    5.3e-8), as the port's does; the port holds ``zuko_tpu``'s to 1e-10
    (the test above)."""
    with np.load(ROOT / "tools" / "bpf_truth_f64.npz") as data:
        x, lp = data["x"], data["lp"]
    tflow = load_params(zt.BPF(6, transforms=3, degree=16, device="cpu").double(),
                        ASSETS / "bpf_flagship.npz")
    _dispatch(monkeypatch, True)
    with torch.no_grad():
        got = tflow(None).log_prob(torch.as_tensor(x, dtype=torch.float64)).numpy()
    assert np.abs(got - lp).max() < 1e-6
    assert np.median(np.abs(got - lp)) < 1e-7
