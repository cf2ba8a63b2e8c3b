r"""Parity of the port's neural circular spline flow (``zuko_tpu_torch.flows.NCSF``,
the ``crqs`` mode of the whole-flow NSF kernels' plain versions, the box
base and what they are built from) with ``zuko_tpu`` on the CPU.

Both packages build the same model: ``zuko_tpu`` from a PRNG key, the port
from its ``zuko_tpu.serial.save_params`` checkpoint through ``load_params``.
Inputs and base draws are made with numpy from a seed (uniform on the
circle) and handed to both. Everything runs in float64, where the port's
kernel wrappers take their plain versions and ``zuko_tpu``'s fused entry
points their jnp math; the circular spline's inverse is closed-form, so the
samples agree to roundoff. Samples are compared on the circle, ``|(a - b +
pi) mod 2 pi - pi|``: a draw at the seam may come back 2 pi apart and still
be the same angle. Each ``zuko_tpu`` flow is built once per module.
"""

import functools
import io
import math

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zuko_tpu
import zuko_tpu_torch as zt

from zuko_tpu import distributions as jax_distributions
from zuko_tpu import transforms as jax_transforms
from zuko_tpu.core import combine, named_parameters, partition
from zuko_tpu.ops import nsf_fused as jax_fused
from zuko_tpu.serial import save_params
from zuko_tpu_torch.distributions import BoxUniform, DiagNormal, NormalizingFlow
from zuko_tpu_torch.lazy import Flow, UnconditionalDistribution
from zuko_tpu_torch.ops import _common
from zuko_tpu_torch.ops import nsf_fused as torch_fused
from zuko_tpu_torch.ops.dispatch import (
    FusedAutoregressiveFlow,
    FusedInvertedAutoregressiveFlow,
)
from zuko_tpu_torch.ops.nsf_fused import FusedStructureError
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


CONTEXT = {"ncsf": 0, "ncsf_context": 2}
ROWS = 16


@functools.lru_cache(maxsize=None)
def _pair(name):
    """The same small NCSF in both packages (F = 3, two layers, 4 bins, a
    16x16 MADE), the port's in float64 on the CPU; once per module."""
    C = CONTEXT[name]
    kw = dict(transforms=2, bins=4, hidden_features=(16, 16))
    jflow = _f64(zuko_tpu.flows.NCSF(3, C, key=jax.random.PRNGKey(0), **kw))
    tflow = _carry(jflow, zt.NCSF(3, C, device="cpu", **kw))
    return jflow, tflow, 3, C


def _circle(a, b):
    """The distance of two angles on the circle."""
    return np.abs(np.remainder(np.asarray(a) - np.asarray(b) + math.pi, 2 * math.pi) - math.pi)


def _inputs(C, seed=0, batched=True):
    """Angles on ``[-pi, pi)``, a few of them a turn off, and a context."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-math.pi, math.pi, (ROWS, 3))
    x[:2] += 2 * math.pi * np.array([[1.0], [-1.0]])
    c = rng.standard_normal((ROWS, C) if batched else (C,)) if C else None
    return x, c


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.as_tensor(a)


# ---------------------------------------------------------- building blocks


def test_circular_shift_matches_zuko_tpu():
    """``(x mod 2B) - B`` and its zero log-Jacobian, forward and inverse,
    at angles in and past ``[-B, B)``: 1e-12; twice is a whole turn."""
    x = np.array([-7.0, -math.pi, -1.0, 0.0, 2.0, math.pi - 1e-9, 9.5])
    jt = jax_transforms.CircularShiftTransform(bound=math.pi)
    tt = zt.transforms.CircularShiftTransform(bound=math.pi)
    ty, tl = tt.call_and_ladj(torch.as_tensor(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jt(jnp.asarray(x))), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tt.inverse(ty).numpy(), np.asarray(jt.inverse(jt(jnp.asarray(x)))),
                               rtol=0, atol=1e-12)
    assert (tl == 0).all() and (tt.inverse_and_ladj(ty)[1] == 0).all()
    assert _circle(tt.inverse(ty).numpy(), x).max() < 1e-12


def test_box_uniform_matches_zuko_tpu():
    """``BoxUniform``'s log-density inside the box, on its bounds (both
    included) and outside (``-inf``), for one box and a batch of them, and
    its samples' shapes and range from an explicit generator; ``expand``
    batches it."""
    lo, hi = np.array([-1.0, 0.0, 2.0]), np.array([1.0, 0.5, 6.0])
    jd = jax_distributions.BoxUniform(jnp.asarray(lo), jnp.asarray(hi))
    td = BoxUniform(torch.as_tensor(lo), torch.as_tensor(hi))
    x = np.array([[0.0, 0.25, 3.0], [-1.0, 0.5, 6.0], [1.0001, 0.1, 3.0], [0.0, -0.1, 7.0]])
    want = np.asarray(jd.log_prob(jnp.asarray(x)))
    got = td.log_prob(torch.as_tensor(x)).numpy()
    assert np.isinf(want[2:]).all() and np.isinf(got[2:]).all() and (got[2:] < 0).all()
    np.testing.assert_allclose(got[:2], want[:2], rtol=0, atol=1e-12)
    np.testing.assert_allclose(got[:2], -np.log(hi - lo).sum(), rtol=0, atol=1e-12)
    g = torch.Generator().manual_seed(0)
    s = td.sample((5, 4), generator=g)
    assert s.shape == (5, 4, 3) and td.event_shape == (3,) and td.batch_shape == ()
    assert bool(((s >= td.lower) & (s <= td.upper)).all())
    batched = td.expand((7,))
    assert batched.batch_shape == (7,) and batched.sample((2,)).shape == (2, 7, 3)
    assert batched.log_prob(torch.zeros(7, 3)).shape == (7,)
    s2 = td.sample((5, 4), generator=torch.Generator().manual_seed(0))
    assert torch.equal(s, s2)


# ------------------------------------------------------------------ flows


@pytest.mark.parametrize("name", list(CONTEXT))
def test_unfused_log_prob_matches_zuko_tpu(name, monkeypatch):
    """The unfused NCSF (a circular shift and a spline on ``[-pi, pi]`` per
    feature, the box base), dispatch off on both sides: 1e-10, angles a
    turn off included."""
    jflow, tflow, F, C = _pair(name)
    x, c = _inputs(C)
    _dispatch(monkeypatch, False)
    tdist = tflow(_t(c))
    assert type(tdist) is NormalizingFlow
    with torch.no_grad():
        got = tdist.log_prob(torch.as_tensor(x)).numpy()
    want = jax.jit(lambda x_, c_: jflow(c_).log_prob(x_))(jnp.asarray(x), _j(c))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("name, batched", [("ncsf", True), ("ncsf_context", False),
                                           ("ncsf_context", True)],
                         ids=["ncsf", "one_context", "batched_context"])
def test_density_and_apply_match_zuko_tpu(name, batched, monkeypatch):
    """K1's plain version (the box base's ``-F log(2 pi + 2e-5)``) against
    ``zuko_tpu``'s ``fused_nsf_log_prob``, and K2's (``nsf_apply``) against
    ``fused_nsf_apply``: 1e-10."""
    jflow, tflow, F, C = _pair(name)
    x, c = _inputs(C, seed=1, batched=batched)
    _dispatch(monkeypatch, True)
    tdist = tflow(_t(c))
    assert type(tdist) is FusedAutoregressiveFlow
    with torch.no_grad():
        got = tdist.log_prob(torch.as_tensor(x)).numpy()
        ty, tl = torch_fused.fused_nsf_apply(tdist._flat, torch.as_tensor(x), _t(c))
    jlp, (jy, jl) = jax.jit(lambda x_, c_: (jax_fused.fused_nsf_log_prob(jflow, x_, c_),
                                            jax_fused.fused_nsf_apply(jflow, x_, c_)))(
        jnp.asarray(x), _j(c))
    np.testing.assert_allclose(got, np.asarray(jlp), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("name", list(CONTEXT))
def test_sample_math_matches_zuko_tpu(name):
    """K3's plain version from the same draws, uniform on the box, against
    ``zuko_tpu``'s ``_sample_math_T`` with log q, in all three modes: ``x``
    (every mode runs the same solve) on the circle, log q from the box, and
    the bare sum of ladjs against ``zuko_tpu``'s log q less the box's term;
    1e-9."""
    jflow, tflow, F, C = _pair(name)
    rng = np.random.default_rng(5)
    z = rng.uniform(-math.pi - 1e-5, math.pi + 1e-5, (ROWS, F))
    c = rng.standard_normal((ROWS, C)) if C else None
    fp, layout, cfg = jax_fused._flatten_flow(jflow)
    params, tlayout, tcfg = torch_fused._flatten_flow(tflow)
    assert tcfg["base"] == cfg["base"] and tcfg["bound"] == math.pi
    zc = torch.as_tensor(z if c is None else np.concatenate([z, c], axis=1))
    jx, jlq = jax.jit(lambda zT, cT: jax_fused._sample_math_T(
        zT, fp, layout, F, cfg["bins"], cfg["bound"], cfg["slope"], cT, want_log_prob=True,
        univ=cfg["univ"], base=cfg["base"]))(
            jnp.asarray(z).T, None if c is None else jnp.asarray(c).T)
    jx, jlq = np.asarray(jx).T, np.asarray(jlq)[0]
    # zuko_tpu's raw sum is its log q less the box's -F log(hi - lo)
    lo, hi = cfg["base"][1:]
    jraw = jlq + F * np.log(hi - lo)
    args = (params, tlayout, *torch_fused._statics(tcfg, F))
    for mode in (False, True, "raw"):
        got = torch_fused.nsf_sample(zc, *args, mode)
        x = got[0] if mode else got
        assert _circle(x.numpy(), jx).max() < 1e-9
        if mode:
            want = jlq if mode is True else jraw
            np.testing.assert_allclose(got[1].numpy(), want, rtol=0, atol=1e-9)


def test_sampling_through_the_public_api(monkeypatch):
    """``sample`` and ``sample_and_log_prob`` of the fused NCSF draw the box
    from the generator (``lo + (hi - lo) U``) and match the plain sampler
    on those draws; the log q of a sample is the density at it; the
    inverted flow serves and evaluates too."""
    _, tflow, F, _ = _pair("ncsf")
    _dispatch(monkeypatch, True)
    dist = tflow(None)
    g = torch.Generator().manual_seed(3)
    x = dist.sample((ROWS,), generator=g)
    xl, lq = dist.sample_and_log_prob((ROWS,), generator=torch.Generator().manual_seed(3))
    u = torch.rand((ROWS, F), generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    z = -math.pi - 1e-5 + (2 * math.pi + 2e-5) * u
    assert torch.equal(x, xl) and x.shape == (ROWS, F)
    params, layout, cfg = dist._flat
    with torch.no_grad():
        plain = torch_fused._sample_math(z, params, layout, *torch_fused._statics(cfg, F))
        np.testing.assert_allclose(x.numpy(), plain.numpy(), rtol=0, atol=1e-12)
        np.testing.assert_allclose(lq.numpy(), dist.log_prob(x).numpy(), rtol=0, atol=1e-9)
    inverted = Flow(tflow.transform.inv, tflow.base)
    idist = inverted(None)
    assert type(idist) is FusedInvertedAutoregressiveFlow
    y, ly = idist.sample_and_log_prob((ROWS,), generator=g)
    with torch.no_grad():
        np.testing.assert_allclose(idist.log_prob(y).numpy(), ly.numpy(), rtol=0, atol=1e-9)


# ------------------------------------------------ extraction and dispatch


def test_extraction_takes_the_constant_box_only(monkeypatch):
    """NCSF dispatches to :class:`FusedAutoregressiveFlow` with the base
    ``("box", -pi - 1e-5, pi + 1e-5)`` and counts its launches under the
    ``crqs`` names; a box that is not constant per feature, a normal base, a
    trainable box or mixed univariates raise :class:`FusedStructureError`
    and keep the unfused path."""
    _, tflow, F, _ = _pair("ncsf")
    _dispatch(monkeypatch, True)
    dist = tflow(None)
    assert type(dist) is FusedAutoregressiveFlow
    params, layout, cfg = dist._flat
    assert cfg["univ"] == "crqs" and cfg["bins"] == 4 and cfg["bound"] == math.pi
    assert cfg["base"] == ("box", -math.pi - 1e-5, math.pi + 1e-5)
    assert [torch_fused._counter(n, "crqs") for n in (
        "nsf_density", "nsf_apply", "nsf_sample", "nsf_sample_log_prob", "nsf_sample_raw")] == [
        "nsf_density_crqs", "nsf_apply_crqs", "nsf_sample_crqs", "nsf_sample_crqs_log_prob",
        "nsf_sample_crqs_raw"]
    assert all(f"nsf_sample_crqs{s}" in _common.WHOLE_FLOW for s in ("", "_log_prob", "_raw"))

    def variant(base):
        torch.manual_seed(0)
        flow = zt.NCSF(F, transforms=2, bins=4, hidden_features=(16, 16), device="cpu")
        flow.base = base
        return flow

    ragged = variant(UnconditionalDistribution(
        BoxUniform, torch.tensor([-3.0, -3.0, -2.0]), torch.full((F,), 3.0), buffer=True))
    normal = variant(UnconditionalDistribution(
        DiagNormal, torch.zeros(F), torch.ones(F), buffer=True))
    trainable = variant(UnconditionalDistribution(
        BoxUniform, torch.full((F,), -3.0), torch.full((F,), 3.0)))
    mixed = variant(tflow.base)
    mixed.transform.transforms[1] = zt.NSF(F, transforms=1, bins=4, hidden_features=(16, 16),
                                          device="cpu").transform.transforms[0]
    for flow, match in ((ragged, "per-feature-constant"), (normal, "BoxUniform"),
                        (trainable, "trainable"), (mixed, "share a univariate config")):
        with pytest.raises(FusedStructureError, match=match):
            torch_fused.extract_nsf_params(flow)
        assert type(flow(None)) is NormalizingFlow


# --------------------------------------------------------------- gradients


def test_density_gradients_match_zuko_tpu(monkeypatch):
    """The gradient of the mean fused log-density to every parameter, the
    angles and a batched context against ``zuko_tpu``'s: 1e-9."""
    jflow, tflow, F, C = _pair("ncsf_context")
    x, c = _inputs(C, seed=7)
    params, static = partition(jflow)

    def jloss(p, x_, c_):
        return jnp.mean(jax_fused.fused_nsf_log_prob(combine(p, static), x_, c_))

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(params, jnp.asarray(x), jnp.asarray(c))
    _dispatch(monkeypatch, True)
    tflow.zero_grad()
    tx, tc = (torch.as_tensor(v).requires_grad_(True) for v in (x, c))
    tflow(tc).log_prob(tx).mean().backward()
    want = {to_torch_name(k): np.asarray(g) for k, g in named_parameters(jg[0])}
    for k, p in tflow.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k], rtol=1e-9, atol=1e-9, err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[1]), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(jg[2]), rtol=1e-9, atol=1e-9)


def test_ift_gradients_match_zuko_tpu(monkeypatch):
    """``rsample_and_log_prob`` through the NSF tier of the IFT from the box
    draws ``zuko_tpu`` makes from its key (the box's flat density gives its
    log-density no cotangent): the samples on the circle to 1e-9, the loss
    and its gradients to every parameter to 1e-8, against ``zuko_tpu``'s
    ``fused_nsf_rsample``."""
    jflow, tflow, F, _ = _pair("ncsf")
    key, shape = jax.random.PRNGKey(4), (ROWS,)
    params, static = partition(jflow)

    def jloss(p):
        x, lq = combine(p, static)(None).rsample_and_log_prob(key, shape)
        return jnp.mean(lq) + jnp.mean(jnp.sum(jnp.sin(x), -1)), x

    _dispatch(monkeypatch, True)
    assert type(jflow(None)).__name__ == "FusedAutoregressiveFlow"
    (jvalue, jx), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    u = np.asarray(jax.random.uniform(key, shape + (F,), jnp.float64))
    monkeypatch.setattr(torch, "rand", lambda shape, **kw: torch.tensor(u).reshape(shape))

    tflow.zero_grad()
    x, lq = tflow(None).rsample_and_log_prob(shape)
    assert _circle(x.detach().numpy(), np.asarray(jx)).max() < 1e-9
    loss = lq.mean() + torch.sin(x).sum(dim=-1).mean()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jvalue), rtol=0, atol=1e-8)
    want = {to_torch_name(k): np.asarray(g) for k, g in named_parameters(jgrads)}
    got = {k: p.grad.numpy() for k, p in tflow.named_parameters()}
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-8, atol=1e-8, err_msg=k)
    assert max(np.abs(g).max() for g in got.values()) > 1e-3


# ------------------------------------------------------------------ assets


def test_flagship_assets_regenerate_from_zuko_tpu(monkeypatch):
    """``assets/ncsf_flagship.npz`` is ``zuko_tpu``'s ``NCSF(6,
    transforms=3, bins=8, key=PRNGKey(0))`` bit for bit (its box base's
    buffers included) and loads into the port one to one;
    ``assets/ncsf_truth_f64.npz`` holds 4,096 angles uniform on ``[-pi,
    pi)`` (numpy seed 0, float32) and ``zuko_tpu``'s float64 unfused
    ``log_prob`` of them, whose first 64 rows regenerate to 1e-12, and which
    the port's plain fused float64 density reproduces to 1e-10."""
    jflow = zuko_tpu.flows.NCSF(6, transforms=3, bins=8, key=jax.random.PRNGKey(0))
    buffer = io.BytesIO()
    save_params(buffer, jflow)
    buffer.seek(0)
    with np.load(buffer) as fresh, np.load(ASSETS / "ncsf_flagship.npz") as committed:
        assert sorted(fresh.files) == sorted(committed.files)
        for k in fresh.files:
            np.testing.assert_array_equal(fresh[k], committed[k], err_msg=k)
        weights = {k: committed[k] for k in committed.files}
    tflow = load_params(zt.NCSF(6, transforms=3, bins=8, device="cpu").double(), weights)
    assert len(tflow.state_dict()) == len(weights)
    with np.load(ASSETS / "ncsf_truth_f64.npz") as data:
        x, lp = data["x"], data["lp"]
    assert x.shape == (4096, 6) and x.dtype == np.float32 and lp.dtype == np.float64
    np.testing.assert_array_equal(x, np.random.default_rng(0).uniform(
        -math.pi, math.pi, (4096, 6)).astype(np.float32))
    x64 = x[:64].astype(np.float64)
    _dispatch(monkeypatch, False)
    want = jax.jit(lambda x_: _f64(jflow)(None).log_prob(x_))(jnp.asarray(x64))
    np.testing.assert_allclose(np.asarray(want), lp[:64], rtol=0, atol=1e-12)
    _dispatch(monkeypatch, True)
    with torch.no_grad():
        got = tflow(None).log_prob(torch.as_tensor(x64)).numpy()
    np.testing.assert_allclose(got, lp[:64], rtol=0, atol=1e-10)
