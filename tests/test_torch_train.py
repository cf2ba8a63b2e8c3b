r"""The port's training harness (``zuko_tpu_torch.parallel``) against
``zuko_tpu.parallel``: a training step as a whole, down to the updated parameters.

Both packages start from the same weights (``save_params`` ->
``load_params``) in float64 on the CPU, with the fused dispatch forced on in
both, so the steps run the fused plain math and the IFT backward. The same
batch (numpy, from a seed) or the same base draws (``zuko_tpu``'s, from its
key, handed to the port in place of ``torch.randn``) go through one step of
each: losses agree to 1e-10 (MLE) / 1e-9 (reverse KL), every updated
parameter to 1e-8 (Adam divides the gradient by its own magnitude, which
carries the gradients' 1e-9 through at about lr times their relative
error).
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
from zuko_tpu.ops import nsf_fused as jax_fused
from zuko_tpu.parallel import train as jax_train
from zuko_tpu.serial import save_params
from zuko_tpu_torch.lazy import Flow
from zuko_tpu_torch.ops import dispatch
from zuko_tpu_torch.parallel import TrainState, make_mle_step, make_reverse_kl_step, train_mle
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



@pytest.fixture
def fused(monkeypatch):
    monkeypatch.setenv("ZUKO_TPU_FUSED_DISPATCH", "1")
    monkeypatch.setenv("ZUKO_TPU_TORCH_FUSED_DISPATCH", "1")


def _assert_same_parameters(tflow, jparams, atol):
    expected = {to_torch_name(k): np.asarray(v) for k, v in named_parameters(jparams)}
    got = dict(tflow.named_parameters())
    assert sorted(got) == sorted(expected)
    for k, p in got.items():
        np.testing.assert_allclose(p.detach().numpy(), expected[k], rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_mle_steps_match_zuko_tpu(name, tmp_path, fused):
    """One step, and three in a row on the same batch."""
    jflow, tflow, F, C = _pair(name, tmp_path)
    x, c = _inputs(F, C, seed=8, scale=1.5)
    jc, tc = _contexts(c)

    params, static = partition(jflow)
    jinit, jstep = jax_train.make_mle_step(static, lr=1e-3)
    jstate = jinit(_f64(params))
    tinit, tstep = make_mle_step(tflow, lr=1e-3)
    tstate = tinit()
    assert isinstance(tstate, TrainState) and tstate.flow is tflow and tstate.step == 0

    for step in range(3):
        jstate, jloss = jstep(jstate, jnp.asarray(x), jc)
        tstate, tloss = tstep(tstate, torch.as_tensor(x), tc)
        assert tstate.step == step + 1 and not tloss.requires_grad
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-10, atol=1e-10)
        if step in (0, 2):
            _assert_same_parameters(tflow, jstate.params, atol=1e-8)
    moved = max(float((p - q).detach().abs().max()) for p, q in zip(
        tflow.parameters(), _pair(name, tmp_path)[1].parameters()))
    assert moved > 1e-3  # three Adam steps of 1e-3 each


def _pair_2d(tmp_path):
    """An NSF over two features, as the ring energy wants, in both packages."""
    kwargs = dict(transforms=2, hidden_features=(16, 16))
    jflow = zuko_tpu.NSF(2, 0, key=jax.random.PRNGKey(1), **kwargs)
    save_params(tmp_path / "nsf2.npz", jflow)
    tflow = load_params(zt.NSF(2, 0, device="cpu", **kwargs).double(), tmp_path / "nsf2.npz")
    return jflow, tflow


@pytest.mark.parametrize("inverted", [False, True], ids=["as_built", "inverted"])
def test_reverse_kl_step_matches_zuko_tpu(inverted, tmp_path, fused, monkeypatch):
    jflow, tflow = _pair_2d(tmp_path)
    if inverted:
        jflow = zuko_tpu.flows.Flow(jflow.transform.inv, jflow.base)
        tmodel = Flow(tflow.transform.inv, tflow.base)
    else:
        tmodel = tflow
    params, static = partition(jflow)
    params = _f64(params)
    key, n = jax.random.PRNGKey(2), 48

    # the base draws zuko_tpu will make from `key`, for the port
    jdist = combine(params, static)(None)
    if inverted:
        z = jdist.base.sample(key, (n,))
    else:
        z = jax_fused._prep_sample(combine(params, static), key, (n,), None)[4]
    z = np.array(z)
    assert z.shape == (n, 2) and z.dtype == np.float64
    monkeypatch.setattr(torch, "randn", lambda *a, **k: torch.tensor(z))

    jinit, jstep = jax_train.make_reverse_kl_step(
        static, zuko_tpu.data.ring_energy, n_samples=n, lr=1e-3)
    jstate, jloss = jstep(jinit(params), key)
    tinit, tstep = make_reverse_kl_step(tmodel, zt.data.ring_energy, n_samples=n, lr=1e-3)
    tdist = tmodel(None)
    assert isinstance(tdist, dispatch.FusedInvertedAutoregressiveFlow if inverted
                      else dispatch.FusedAutoregressiveFlow)
    tstate, tloss = tstep(tinit())
    assert tstate.step == 1
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-9, atol=1e-9)
    _assert_same_parameters(tmodel, jstate.params, atol=1e-8)


def test_two_moons_and_ring_energy_match_zuko_tpu():
    for a, b in zip(zt.data.two_moons(512, seed=0), zuko_tpu.data.two_moons(512, seed=0)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    x = np.random.default_rng(0).standard_normal((5, 7, 2))
    np.testing.assert_allclose(
        zt.data.ring_energy(torch.as_tensor(x)).numpy(),
        np.asarray(zuko_tpu.data.ring_energy(jnp.asarray(x))), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("conditional", [False, True], ids=["plain", "conditional"])
def test_train_mle_two_moons(conditional):
    """``tests/test_train.py``'s MLE tests mirrored; the shuffles differ, so
    this holds the behaviour, not the values."""
    x, y = zt.data.two_moons(512, seed=0)
    torch.manual_seed(0)
    flow = zt.MAF(2, int(conditional), transforms=3, device="cpu")
    before = {k: v.clone() for k, v in flow.state_dict().items()}
    context = y[:, None] if conditional else None
    seen = []
    trained, losses = train_mle(
        flow, x, context=context, epochs=3, batch_size=64, lr=1e-2,
        generator=torch.Generator().manual_seed(0), callback=seen.append,
    )
    assert len(losses) == 3 and np.isfinite(losses).all()
    # the loss falls by more than 0.3, from the first step's to the last
    # epoch's mean (between the epochs' means the fall hangs on the shuffle:
    # an epoch is 8 steps, and most of the fall happens inside the first)
    assert losses[-1] < seen[0]["loss"] - 0.3 and losses[-1] < losses[0], (seen[0], losses)
    assert trained is not flow
    for k, v in flow.state_dict().items():  # the caller's flow is unchanged
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    assert any((a != b).any() for a, b in zip(trained.parameters(), flow.parameters()))
    assert len(seen) == 3 * (512 // 64)
    assert [m["step"] for m in seen] == list(range(1, len(seen) + 1))
    assert [m["epoch"] for m in seen] == [i // 8 for i in range(len(seen))]
    for m in seen:
        assert set(m) == {"step", "epoch", "loss", "grad_norm", "examples_per_s"}
        assert np.isfinite(m["loss"]) and m["grad_norm"] > 0 and m["examples_per_s"] > 0
    np.testing.assert_allclose(np.mean([m["loss"] for m in seen[-8:]]), losses[-1], rtol=1e-5)
    with torch.no_grad():
        c = None if context is None else torch.as_tensor(context)
        assert bool(torch.isfinite(trained(c).log_prob(torch.as_tensor(x))).all())


def test_train_mle_drops_the_partial_batch_and_reports_the_gradient_norm():
    torch.manual_seed(0)
    flow = zt.MAF(2, transforms=1, hidden_features=(8,), device="cpu").double()
    x = np.random.default_rng(0).standard_normal((70, 2))
    seen = []
    trained, losses = train_mle(flow, x, epochs=1, batch_size=32, lr=0.0,
                                generator=torch.Generator().manual_seed(0),
                                callback=seen.append)
    assert len(seen) == 2 and len(losses) == 1  # 70 // 32 steps, 6 rows dropped
    # lr = 0 leaves the weights alone, so the norms can be recomputed
    perm = torch.randperm(70, generator=torch.Generator().manual_seed(0))[:64].reshape(2, 32)
    for m, idx in zip(seen, perm):
        flow.zero_grad()
        loss = -flow(None).log_prob(torch.as_tensor(x)[idx]).mean()
        loss.backward()
        norm = torch.sqrt(sum((p.grad**2).sum() for p in flow.parameters()))
        np.testing.assert_allclose(m["loss"], float(loss.detach()), rtol=1e-12)
        np.testing.assert_allclose(m["grad_norm"], float(norm), rtol=1e-12)


def test_mesh_is_a_later_slice():
    torch.manual_seed(0)
    flow = zt.MAF(2, transforms=1, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        train_mle(flow, np.zeros((8, 2), np.float32), mesh=object())
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        make_reverse_kl_step(flow, zt.data.ring_energy, mesh=object())


def test_bridge_loads_an_inverted_flow(tmp_path):
    """``zuko_tpu``'s inverted flow saves under ``transform.transform...``;
    the port's ``LazyInverse`` holds its inner transform under the same
    name, so the bridge needs no further rename, and the un-inverted flow,
    which shares the parameters, receives the weights too."""
    jflow, _ = _pair_2d(tmp_path)
    path = tmp_path / "inverted.npz"
    save_params(path, zuko_tpu.flows.Flow(jflow.transform.inv, jflow.base))
    saved = np.load(path)
    assert "transform.transform.transforms.0.hyper.layers.0.weight" in saved.files

    torch.manual_seed(0)
    tflow = zt.NSF(2, 0, transforms=2, hidden_features=(16, 16), device="cpu")
    inv = load_params(Flow(tflow.transform.inv, tflow.base), path)
    state = inv.state_dict()
    assert sorted(state) == sorted(to_torch_name(k) for k in saved.files)
    for k in saved.files:
        np.testing.assert_array_equal(state[to_torch_name(k)].numpy(), saved[k])
    np.testing.assert_array_equal(
        tflow.transform.transforms[0].hyper.layers[0].weight.detach().numpy(),
        saved["transform.transform.transforms.0.hyper.layers.0.weight"])


# ------------------------------------------------ tutorial anchors (slow)


@pytest.mark.slow
@pytest.mark.parametrize("conditional, anchor", [(False, 1.0958), (True, 0.3749)],
                         ids=["plain", "conditional"])
def test_forward_kl_tutorial_anchor(conditional, anchor):
    """NSF on two-moons, 8 epochs of Adam at 1e-3 (``examples/forward_kl.py``):
    the final-epoch NLL lands on the reference tutorial's (its own
    epoch-to-epoch deviation is 0.1)."""
    x, y = zt.data.two_moons(16384, seed=0)
    torch.manual_seed(0)
    flow = zt.NSF(2, int(conditional), transforms=3, device="cpu")
    _, losses = train_mle(
        flow, x, context=y[:, None] if conditional else None, epochs=8, batch_size=64,
        lr=1e-3, generator=torch.Generator().manual_seed(0),
    )
    assert abs(losses[-1] - anchor) < 0.15, losses


@pytest.mark.slow
def test_reverse_kl_tutorial_anchor(fused):
    """Inverted NSF on the ring energy, 8 epochs of 256 steps of 256 samples
    (``examples/reverse_kl.py``): the last epoch's mean loss lands on the
    reference tutorial's -1.5888 (deviation 0.018)."""
    torch.manual_seed(0)
    flow = zt.NSF(2, 0, transforms=3, device="cpu")
    inv = Flow(flow.transform.inv, flow.base)
    init_fn, step_fn = make_reverse_kl_step(inv, zt.data.ring_energy, n_samples=256, lr=1e-3)
    state, gen = init_fn(), torch.Generator().manual_seed(0)
    losses = []
    for _ in range(8 * 256):
        state, loss = step_fn(state, gen)
        losses.append(float(loss))
    assert abs(np.mean(losses[-256:]) - (-1.5888)) < 0.1, np.mean(losses[-256:])
