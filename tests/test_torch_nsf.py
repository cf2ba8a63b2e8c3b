r"""Parity of the PyTorch port (``zuko_tpu_torch``) with ``zuko_tpu`` on the
flagship path: NSF/MAF density, sampling from a fixed z, and the weight
bridge.

Both packages build the same model: ``zuko_tpu`` from a PRNG key, the port
from the ``zuko_tpu.serial.save_params`` checkpoint. Inputs and base draws
are made with numpy from a seed and handed to both sides. Everything runs in
float64 on the CPU (the conftest enables x64), so the closed-form paths
agree to roundoff: the tolerances below are 1e-10 for the density and 1e-9
for the sampler (six sweeps of the spline inverse per layer).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zuko_tpu
import zuko_tpu_torch as zt

from zuko_tpu.ops import nsf_fused as jax_fused
from zuko_tpu.serial import save_params
from zuko_tpu_torch.ops import nsf_fused as torch_fused
from zuko_tpu_torch.ops.dispatch import FusedAutoregressiveFlow
from zuko_tpu_torch.serial import load_params, to_torch_name

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


ROOT = Path(__file__).resolve().parents[1]
HIDDEN = (16, 16)
BATCH = 32

# name -> (flow class name, features, context, transforms)
CASES = {
    "nsf": ("NSF", 4, 0, 2),
    "maf": ("MAF", 5, 0, 3),
    "nsf_context": ("NSF", 3, 4, 2),
}


def _pair(name, tmp_path):
    """The same flow in both packages; the port's in float64 on the CPU."""
    cls, F, C, T = CASES[name]
    jflow = getattr(zuko_tpu, cls)(
        F, C, transforms=T, hidden_features=HIDDEN, key=jax.random.PRNGKey(0)
    )
    path = tmp_path / "params.npz"
    save_params(path, jflow)
    tflow = getattr(zt, cls)(
        F, C, transforms=T, hidden_features=HIDDEN, device="cpu"
    ).double()
    load_params(tflow, path)
    return jflow, tflow, F, C


def _inputs(F, C, seed=0, scale=2.5):
    """x (wide enough that some features leave the spline's [-5, 5]) and a
    batched context, or None."""
    rng = np.random.default_rng(seed)
    x = scale * rng.standard_normal((BATCH, F))
    c = rng.standard_normal((BATCH, C)) if C else None
    return x, c


def _contexts(c):
    if c is None:
        return None, None
    return jnp.asarray(c), torch.as_tensor(c)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("name", list(CASES))
def test_density_matches_zuko_tpu(name, fused, tmp_path, monkeypatch):
    monkeypatch.setenv("ZUKO_TPU_FUSED_DISPATCH", "1" if fused else "0")
    monkeypatch.setenv("ZUKO_TPU_TORCH_FUSED_DISPATCH", "1" if fused else "0")
    jflow, tflow, F, C = _pair(name, tmp_path)
    x, c = _inputs(F, C)
    jc, tc = _contexts(c)

    jdist, tdist = jflow(jc), tflow(tc)
    assert (type(jdist).__name__ == "FusedAutoregressiveFlow") == fused
    assert isinstance(tdist, FusedAutoregressiveFlow) == fused

    expected = np.asarray(jdist.log_prob(jnp.asarray(x)))
    with torch.no_grad():
        got = tdist.log_prob(torch.as_tensor(x)).numpy()
    assert got.shape == (BATCH,)
    np.testing.assert_allclose(got, expected, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("want_log_prob", [False, True], ids=["x", "x_logq"])
@pytest.mark.parametrize("name", list(CASES))
def test_sample_math_matches_sample_core(name, want_log_prob, tmp_path):
    """The port's plain sampler against ``_sample_core``'s CPU branch
    (``nsf_fused.py:1585-1594``) on the same base draws and context."""
    jflow, tflow, F, C = _pair(name, tmp_path)
    z, c = _inputs(F, C, seed=1, scale=1.0)
    zc = z if c is None else np.concatenate([z, c], axis=1)

    flat, layout, cfg = jax_fused._flatten_flow(jflow)
    expected = jax_fused._sample_core(
        layout, F, C, cfg["bins"], cfg["bound"], cfg["slope"], cfg["univ"],
        cfg["base"], want_log_prob, jnp.asarray(zc), list(flat),
    )
    params, tlayout, tcfg = torch_fused._flatten_flow(tflow)
    with torch.no_grad():
        got = torch_fused._sample_math(
            torch.as_tensor(zc), params, tlayout, F, tcfg["bins"], tcfg["bound"],
            tcfg["slope"], tcfg["univ"], want_log_prob,
        )
    if not want_log_prob:
        expected, got = (expected,), (got,)
    for e, g in zip(expected, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("name", ["nsf", "maf"])
def test_inverse_transform_matches_zuko_tpu(name, tmp_path, monkeypatch):
    """Sampling from a fixed z at flow level: the unfused inverse transform
    and its ladj."""
    monkeypatch.setenv("ZUKO_TPU_FUSED_DISPATCH", "0")
    monkeypatch.setenv("ZUKO_TPU_TORCH_FUSED_DISPATCH", "0")
    jflow, tflow, F, _ = _pair(name, tmp_path)
    z, _ = _inputs(F, 0, seed=2, scale=1.0)
    jx, jladj = jflow(None).transform.inverse_and_ladj(jnp.asarray(z))
    with torch.no_grad():
        tx, tladj = tflow(None).transform.inverse_and_ladj(torch.as_tensor(z))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(tladj.numpy(), np.asarray(jladj), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("kwargs", [
    {"passes": 2, "order": [2, 0, 3, 1]},
    {"adjacency": np.array([
        [1, 0, 0, 0, 1, 0],
        [1, 1, 0, 0, 0, 1],
        [0, 1, 1, 0, 1, 1],
        [1, 0, 0, 1, 0, 0],
    ], dtype=bool)},
], ids=["passes_order", "adjacency"])
def test_made_transform_matches_zuko_tpu(kwargs, tmp_path):
    """The MADE conditioner's masks (``passes`` grouping of a custom order,
    or a custom adjacency with context columns): the same weights give the
    same transform, forward and inverse."""
    jt = zuko_tpu.flows.MaskedAutoregressiveTransform(
        4, 2, hidden_features=HIDDEN, key=jax.random.PRNGKey(0), **kwargs
    )
    save_params(tmp_path / "t.npz", jt)
    tt = zt.flows.MaskedAutoregressiveTransform(
        4, 2, hidden_features=HIDDEN, device="cpu", **kwargs
    ).double()
    load_params(tt, tmp_path / "t.npz")
    assert tt.passes == jt.passes
    x, c = _inputs(4, 2, seed=3, scale=1.0)
    jy, jladj = jt(jnp.asarray(c)).call_and_ladj(jnp.asarray(x))
    with torch.no_grad():
        transform = tt(torch.as_tensor(c))
        ty, tladj = transform.call_and_ladj(torch.as_tensor(x))
        tx = transform.inverse(ty)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(tladj.numpy(), np.asarray(jladj), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(tx.numpy(), x, rtol=0, atol=1e-9)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_sample_shapes_batched_context(fused, monkeypatch):
    """``sample_shape + batch + event`` for a batched context; both paths
    draw the same base samples from the same generator, so they agree."""
    torch.manual_seed(0)
    flow = zt.NSF(3, 4, transforms=2, hidden_features=HIDDEN, device="cpu").double()
    c = torch.randn(6, 4, dtype=torch.float64)

    def draw(mode):
        monkeypatch.setenv("ZUKO_TPU_TORCH_FUSED_DISPATCH", mode)
        dist = flow(c)
        x = dist.sample((5,), generator=torch.Generator().manual_seed(3))
        xl, lq = dist.sample_and_log_prob((5,), generator=torch.Generator().manual_seed(3))
        return x, xl, lq, dist.log_prob(x)

    x, xl, lq, lp = draw("1" if fused else "0")
    assert x.shape == xl.shape == (5, 6, 3)
    assert lq.shape == lp.shape == (5, 6)
    torch.testing.assert_close(x, xl, rtol=0, atol=0)
    torch.testing.assert_close(lq, lp, rtol=1e-9, atol=1e-9)
    other = draw("0" if fused else "1")
    for a, b in zip((x, xl, lq, lp), other):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)


def test_fused_density_gradients_match_unfused(monkeypatch):
    torch.manual_seed(0)
    flow = zt.NSF(3, 4, transforms=2, hidden_features=HIDDEN, device="cpu").double()
    x = 2.0 * torch.randn(BATCH, 3, dtype=torch.float64)
    c = torch.randn(BATCH, 4, dtype=torch.float64)
    grads = []
    for mode in "01":
        monkeypatch.setenv("ZUKO_TPU_TORCH_FUSED_DISPATCH", mode)
        flow.zero_grad()
        flow(c).log_prob(x).mean().backward()
        grads.append([p.grad.clone() for p in flow.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)


def test_bridge_maps_every_key_once(tmp_path):
    jflow, tflow, _, _ = _pair("nsf", tmp_path)
    keys = list(np.load(tmp_path / "params.npz").files)
    mapped = [to_torch_name(k) for k in keys]
    assert sorted(mapped) == sorted(tflow.state_dict())
    assert len(set(mapped)) == len(keys)
    assert "base.args.0" in keys and "base._0" in mapped


@pytest.mark.parametrize("change", ["missing", "unexpected"])
def test_bridge_raises_on_unmatched_keys(change, tmp_path):
    _, tflow, _, _ = _pair("nsf", tmp_path)
    data = dict(np.load(tmp_path / "params.npz"))
    if change == "missing":
        del data["transform.transforms.0.hyper.layers.0.bias"]
    else:
        data["transform.transforms.9.hyper.layers.0.bias"] = np.zeros(3)
    with pytest.raises(KeyError):
        load_params(tflow, data)


def test_flagship_asset_is_zuko_tpu_nsf_key0(tmp_path):
    """The committed flagship parameters are ``NSF(6, 0, transforms=3,
    key=PRNGKey(0))`` of ``zuko_tpu``, saved with ``save_params``."""
    path = tmp_path / "flagship.npz"
    save_params(path, zuko_tpu.NSF(6, 0, transforms=3, key=jax.random.PRNGKey(0)))
    fresh = np.load(path)
    committed = np.load(ROOT / "zuko_tpu_torch" / "assets" / "nsf_flagship.npz")
    assert sorted(fresh.files) == sorted(committed.files)
    for k in fresh.files:
        np.testing.assert_array_equal(committed[k], fresh[k])


def test_flagship_density_matches_f64_truth(monkeypatch):
    """The port's flagship density in float64, fused plain path, against
    ``tools/nsf_truth_f64.npz`` (the model matches it to 2.7e-6)."""
    monkeypatch.setenv("ZUKO_TPU_TORCH_FUSED_DISPATCH", "1")
    flow = zt.NSF(6, 0, transforms=3, device="cpu").double()
    load_params(flow, ROOT / "zuko_tpu_torch" / "assets" / "nsf_flagship.npz")
    truth = np.load(ROOT / "tools" / "nsf_truth_f64.npz")
    with torch.no_grad():
        lp = flow(None).log_prob(torch.as_tensor(truth["x"], dtype=torch.float64))
    np.testing.assert_allclose(lp.numpy(), truth["lp"], rtol=0, atol=1e-5)
