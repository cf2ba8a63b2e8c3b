r"""The port's differentiable fused sampling (``zuko_tpu_torch.ops.ift``) and
its inverted flow, against ``zuko_tpu`` and against autograd through the
port's own unfused inverse sweeps.

Both packages get the same ``zc`` (base draws beside the context), made
with numpy from a seed; everything runs in float64 on the CPU, where the
sampling kernel's wrapper takes its plain version and ``zuko_tpu`` its jnp
path. Tolerance 1e-9 for values and gradients: the nilpotent solves are
exact, so only roundoff over six sweeps of the spline inverse separates the
two.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_nsf import CASES, _contexts, _inputs, _pair
from test_torch_ops import _f64

import zuko_tpu
import zuko_tpu_torch as zt

from zuko_tpu.core import combine, named_parameters, partition
from zuko_tpu.ops import ift as jax_ift
from zuko_tpu.ops import nsf_fused as jax_fused
from zuko_tpu_torch.distributions import NormalizingFlow
from zuko_tpu_torch.lazy import Flow
from zuko_tpu_torch.ops import dispatch
from zuko_tpu_torch.ops import ift as torch_ift
from zuko_tpu_torch.ops import nsf_fused as torch_fused
from zuko_tpu_torch.serial import to_torch_name

torch.set_num_threads(1)


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


MODES = (False, True, "raw")


def _loss(out, mode, lib):
    """``mean(log q) + mean(sum x^2)``, the reverse-KL-shaped loss; without
    a log-density output its second term alone."""
    if not mode:
        return lib.mean(lib.sum(out**2, -1))
    return lib.mean(out[1]) + lib.mean(lib.sum(out[0] ** 2, -1))


@pytest.mark.parametrize("name", list(CASES))
def test_ift_matches_zuko_tpu(name, tmp_path):
    """Values and gradients (parameters by dotted name, and ``zc`` with its
    context columns) of the three modes from an identical ``zc``."""
    jflow, tflow, F, C = _pair(name, tmp_path)
    z, c = _inputs(F, C, seed=6, scale=1.0)
    zc = z if c is None else np.concatenate([z, c], axis=1)
    params, static = partition(jflow)

    def jrun(p, zc_):
        results = []
        for mode in MODES:
            def f(p, zc_, mode=mode):
                flat, layout, cfg = jax_fused._flatten_flow(combine(p, static))
                out = jax_ift._ift_op(
                    layout, F, C, cfg["bins"], float(cfg["bound"]), float(cfg["slope"]),
                    cfg["univ"], cfg["base"], mode, zc_, *flat,
                )
                return _loss(out, mode, jnp), out
            results.append(jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(p, zc_))
        return results

    expected = jax.jit(jrun)(_f64(params), jnp.asarray(zc))

    flat = torch_fused._flatten_flow(tflow)
    for mode, ((_, jout), (jgp, jgzc)) in zip(MODES, expected):
        tflow.zero_grad()
        tzc = torch.as_tensor(zc).requires_grad_(True)
        tout = torch_ift._ift(tzc, flat, F, mode)
        _loss(tout, mode, torch).backward()
        for t, j in zip(tout if mode else (tout,), jout if mode else (jout,)):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(tzc.grad.numpy(), np.asarray(jgzc), rtol=1e-9, atol=1e-9)
        jgrads = {to_torch_name(k): np.asarray(g) for k, g in named_parameters(jgp)}
        tgrads = {k: p.grad for k, p in tflow.named_parameters()}
        assert sorted(tgrads) == sorted(jgrads)
        for k, g in tgrads.items():
            np.testing.assert_allclose(
                g.numpy(), jgrads[k], rtol=1e-9, atol=1e-9, err_msg=f"{mode} {k}")


def _port_flow(name, dtype=torch.float64):
    cls, F, C, T = CASES[name]
    torch.manual_seed(0)
    flow = getattr(zt, cls)(F, C, transforms=T, hidden_features=(16, 16), device="cpu").to(dtype)
    c = torch.randn(5, C, dtype=dtype) if C else None
    return flow, c


def _rkl_grads(flow, c, fused, monkeypatch, n=16):
    monkeypatch.setenv("ZUKO_TPU_TORCH_FUSED_DISPATCH", "1" if fused else "0")
    flow.zero_grad()
    dist = flow(c)
    x, lq = dist.rsample_and_log_prob((n,), torch.Generator().manual_seed(1))
    _loss((x, lq), True, torch).backward()
    return dist, x.detach(), lq.detach(), [p.grad.clone() for p in flow.parameters()]


@pytest.mark.parametrize("name", list(CASES))
def test_ift_gradients_match_unfused_autograd_f64(name, monkeypatch):
    flow, c = _port_flow(name)
    fdist, fx, flq, fg = _rkl_grads(flow, c, True, monkeypatch)
    udist, ux, ulq, ug = _rkl_grads(flow, c, False, monkeypatch)
    assert isinstance(fdist, dispatch.FusedAutoregressiveFlow)
    assert type(udist) is NormalizingFlow
    torch.testing.assert_close(fx, ux, rtol=0, atol=1e-12)
    torch.testing.assert_close(flq, ulq, rtol=1e-9, atol=1e-9)
    for a, b in zip(fg, ug):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-9)


def test_ift_gradients_float32(monkeypatch):
    """In float32 the IFT gradients stay finite, non-zero and within 5e-5
    of autograd through the unfused sweeps."""
    flow, c = _port_flow("nsf", torch.float32)
    _, _, _, fg = _rkl_grads(flow, c, True, monkeypatch, n=64)
    _, _, _, ug = _rkl_grads(flow, c, False, monkeypatch, n=64)
    total = 0.0
    for a, b in zip(fg, ug):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, rtol=0, atol=5e-5)
        total += float(a.abs().sum())
    assert total > 1e-3


def test_rsample_returns_sample_values_and_only_it_carries_gradients(monkeypatch):
    monkeypatch.setenv("ZUKO_TPU_TORCH_FUSED_DISPATCH", "1")
    flow, c = _port_flow("nsf_context")
    dist = flow(c)
    draw = lambda fn: fn((7,), torch.Generator().manual_seed(2))  # noqa: E731
    x, rx = draw(dist.sample), draw(dist.rsample)
    (xl, lq), (rxl, rlq) = draw(dist.sample_and_log_prob), draw(dist.rsample_and_log_prob)
    assert x.shape == (7, 5, 3) and lq.shape == (7, 5)
    for a, b in ((x, rx), (x, xl), (x, rxl), (lq, rlq)):
        torch.testing.assert_close(a, b.detach(), rtol=0, atol=0)
    assert not x.requires_grad and not xl.requires_grad and not lq.requires_grad
    assert rx.requires_grad and rxl.requires_grad and rlq.requires_grad


@pytest.mark.parametrize("use", ["x", "log_q"])
def test_ift_backward_with_one_output_unused(use, monkeypatch):
    """Only ``x`` or only ``log q`` enters the loss: the other cotangent is
    ``None`` in the Function's backward."""
    flow, c = _port_flow("nsf")
    grads = []
    for fused in (True, False):
        monkeypatch.setenv("ZUKO_TPU_TORCH_FUSED_DISPATCH", "1" if fused else "0")
        flow.zero_grad()
        x, lq = flow(c).rsample_and_log_prob((16,), torch.Generator().manual_seed(3))
        ((x**2).sum(-1).mean() if use == "x" else lq.mean()).backward()
        grads.append([p.grad.clone() for p in flow.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-9)


def test_fused_rsample_goes_through_the_ift(monkeypatch):
    """The IFT is the one differentiable-sampling route of a fused flow; the
    unfused class, called on the same flow, is the reference."""
    monkeypatch.setenv("ZUKO_TPU_TORCH_FUSED_DISPATCH", "1")
    flow, c = _port_flow("nsf")
    calls = []
    real = dispatch.fused_nsf_rsample
    monkeypatch.setattr(dispatch, "fused_nsf_rsample",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    dist = flow(c)
    gen = torch.Generator().manual_seed(4)
    x = dist.rsample((8,), gen)
    xl, lq = dist.rsample_and_log_prob((8,), gen)
    assert len(calls) == 2 and x.requires_grad and lq.requires_grad
    gen = torch.Generator().manual_seed(4)
    ux = NormalizingFlow.rsample(dist, (8,), gen)
    uxl, ulq = NormalizingFlow.rsample_and_log_prob(dist, (8,), gen)
    assert len(calls) == 2  # the unfused sweeps do not come back here
    for a, b in ((x, ux), (xl, uxl), (lq, ulq)):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-9)


def test_pegged_row_contributes_zero():
    """A row whose ``x`` does not solve ``T(x) = z`` (here: corrupted by
    hand, since the closed-form inverses never fail) gets zero cotangent."""
    flow, _ = _port_flow("nsf")
    params, layout, cfg = torch_fused._flatten_flow(flow)
    st = (layout, *torch_fused._statics(cfg, 4))
    needs = [i % 3 != 2 for i in range(len(params))]
    zc = torch.randn(12, 4, dtype=torch.float64)
    x = torch_fused.nsf_sample(zc, params, *st).clone()
    x[0] += 0.5
    xbar, lbar = torch.randn(12, 4, dtype=torch.float64), torch.randn(12, dtype=torch.float64)
    ok = torch.ones(12, dtype=torch.float64)
    ok[0] = 0.0
    xm, lm = torch_ift._solve_consistency_mask(
        torch.cat([zc[:1] + 0.3, zc[1:]]), zc, xbar, lbar)
    torch.testing.assert_close(xm, xbar * ok[:, None], rtol=0, atol=0)
    torch.testing.assert_close(lm, (lbar * ok)[:, None], rtol=0, atol=0)

    dzc, dps = torch_ift._ift_bwd_math(zc, x, xbar, lbar, params, needs, *st)
    dzc0, dps0 = torch_ift._ift_bwd_math(
        zc, x, xbar * ok[:, None], lbar * ok, params, needs, *st)
    assert bool((dzc[0] == 0).all()) and bool((dzc[1:] != 0).any())
    torch.testing.assert_close(dzc, dzc0, rtol=0, atol=0)
    for a, b, need in zip(dps, dps0, needs):
        assert (a is None) == (not need)
        if need:
            torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------- inverted flow


@pytest.mark.parametrize("name", list(CASES))
def test_inverted_flow_matches_zuko_tpu(name, tmp_path, monkeypatch):
    monkeypatch.setenv("ZUKO_TPU_FUSED_DISPATCH", "1")
    monkeypatch.setenv("ZUKO_TPU_TORCH_FUSED_DISPATCH", "1")
    jflow, tflow, F, C = _pair(name, tmp_path)
    x, c = _inputs(F, C, seed=7, scale=1.5)
    jc, tc = _contexts(c)

    params, static = partition(zuko_tpu.flows.Flow(jflow.transform.inv, jflow.base))
    jdist = combine(_f64(params), static)(jc)
    tdist = Flow(tflow.transform.inv, tflow.base)(tc)
    assert type(jdist).__name__ == "FusedInvertedAutoregressiveFlow"
    assert isinstance(tdist, dispatch.FusedInvertedAutoregressiveFlow)

    # zuko_tpu's density and its draws with their log q, traced once under
    # jax.jit; the same base draws for both: zuko_tpu's, from its key
    key = jax.random.PRNGKey(3)

    def jrun(p, x_, c_):
        dist = combine(p, static)(c_)
        return dist.log_prob(x_), dist.sample_and_log_prob(key, (9,))

    jlp, (jx, jlq) = jax.jit(jrun)(_f64(params), jnp.asarray(x), jc)
    with torch.no_grad():
        lp = tdist.log_prob(torch.as_tensor(x))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-9, atol=1e-9)
    z = np.asarray(jdist.base.sample(key, (9,)))
    assert z.dtype == np.float64 and z.shape == (9,) + x.shape[: 1 if C else 0] + (F,)
    monkeypatch.setattr(torch, "randn", lambda *a, **k: torch.tensor(z))
    tx, tlq = tdist.sample_and_log_prob((9,))
    assert not tx.requires_grad
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(tlq.numpy(), np.asarray(jlq), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("name", list(CASES))
def test_inverted_flow_gradients_match_unfused(name, monkeypatch):
    """Both directions of the inverted flow, reverse KL through the apply
    and forward KL through the raw-mode solve, against the unfused path."""
    flow, c = _port_flow(name)
    inv = Flow(flow.transform.inv, flow.base)
    F = CASES[name][1]
    x = torch.randn((11,) + (() if c is None else c.shape[:1]) + (F,), dtype=torch.float64)
    results = []
    for mode in "10":
        monkeypatch.setenv("ZUKO_TPU_TORCH_FUSED_DISPATCH", mode)
        inv.zero_grad()
        dist = inv(c)
        s, lq = dist.rsample_and_log_prob((11,), torch.Generator().manual_seed(5))
        lp = dist.log_prob(x)
        (_loss((s, lq), True, torch) - lp.mean()).backward()
        results.append((type(dist), s.detach(), lq.detach(), lp.detach(),
                        [p.grad.clone() for p in flow.parameters()]))
    assert results[0][0] is dispatch.FusedInvertedAutoregressiveFlow
    assert results[1][0] is NormalizingFlow
    for a, b in zip(results[0][1:4], results[1][1:4]):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-9)
    for a, b in zip(results[0][4], results[1][4]):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-9)


def test_inverted_flow_of_unrepresentable_structure_stays_unfused(monkeypatch):
    monkeypatch.setenv("ZUKO_TPU_TORCH_FUSED_DISPATCH", "1")
    torch.manual_seed(0)
    flow = zt.NSF(4, 0, transforms=2, hidden_features=(16, 16), residual=True, device="cpu")
    inv = Flow(flow.transform.inv, flow.base)
    assert inv.transform.inv is flow.transform
    dist = inv(None)
    assert type(dist) is NormalizingFlow
    x, lq = dist.rsample_and_log_prob((3,))
    assert x.shape == (3, 4) and lq.requires_grad
