r"""Parity of the port's kernel modules with ``zuko_tpu`` on the CPU: the
forward apply (``nsf_apply``), the masked linear layer and the element-wise
spline. Each kernel's plain PyTorch version is held against the JAX
function it stands for (which takes its jnp path on the CPU) on inputs made
with numpy from a seed, in float64: values to 1e-10 (apply) or 1e-12 (the
two per-op functions, a handful of operations each), gradients to 1e-9 /
1e-10. The backward math of the ``autograd.Function``s, which only a CUDA
tensor reaches, is tested as plain functions against autograd.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_nsf import CASES, _contexts, _inputs, _pair

from zuko_tpu.core import combine, named_parameters, partition
from zuko_tpu.ops import masked_linear as jax_ml
from zuko_tpu.ops import nsf_fused as jax_fused
from zuko_tpu.ops import rqs as jax_rqs
from zuko_tpu_torch.ops import masked_linear as torch_ml
from zuko_tpu_torch.ops import nsf_fused as torch_fused
from zuko_tpu_torch.ops import rqs as torch_rqs
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



def _f64(params):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating) else a,
        params,
    )


# ------------------------------------------------------------- K2: apply


@pytest.mark.parametrize("name", list(CASES))
def test_apply_matches_zuko_tpu(name, tmp_path):
    jflow, tflow, F, C = _pair(name, tmp_path)
    u, c = _inputs(F, C, seed=4)
    jc, tc = _contexts(c)
    rng = np.random.default_rng(5)
    a, b = rng.standard_normal(u.shape), rng.standard_normal(u.shape[0])

    params, static = partition(jflow)
    params = _f64(params)

    def jloss(p, uu):
        y, l = jax_fused.fused_nsf_apply(combine(p, static), uu, jc)
        return jnp.sum(y * a) + jnp.sum(l * b), (y, l)

    (_, (jy, jl)), (jgp, jgu) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(u)
    )

    tu = torch.as_tensor(u).requires_grad_(True)
    ty, tl = torch_fused.fused_nsf_apply(torch_fused._flatten_flow(tflow), tu, tc)
    (torch.sum(ty * torch.as_tensor(a)) + torch.sum(tl * torch.as_tensor(b))).backward()

    assert ty.shape == u.shape and tl.shape == u.shape[:1]
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(tu.grad.numpy(), np.asarray(jgu), rtol=1e-9, atol=1e-9)
    tgrads = {k: p.grad for k, p in tflow.named_parameters()}
    jgrads = {to_torch_name(k): np.asarray(g) for k, g in named_parameters(jgp)}
    assert sorted(tgrads) == sorted(jgrads)
    for k, g in tgrads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[k], rtol=1e-9, atol=1e-9, err_msg=k)


def test_apply_is_the_sampler_inverse():
    """``nsf_apply`` at the raw-mode sampler's output returns the target,
    and the two bare ladj sums agree."""
    torch.manual_seed(0)
    import zuko_tpu_torch as zt

    flow = zt.NSF(4, 2, transforms=2, hidden_features=(16, 16), device="cpu").double()
    params, layout, cfg = torch_fused._flatten_flow(flow)
    st = torch_fused._statics(cfg, 4)
    zc = torch.randn(32, 6, dtype=torch.float64)
    with torch.no_grad():
        u, ladj = torch_fused.nsf_sample(zc, params, layout, *st, want_log_prob="raw")
        y, ladj2 = torch_fused.nsf_apply(torch.cat([u, zc[:, 4:]], dim=1), params, layout, *st)
    torch.testing.assert_close(y, zc[:, :4], rtol=0, atol=1e-9)
    torch.testing.assert_close(ladj, ladj2, rtol=0, atol=1e-9)


# ------------------------------------------------------ K4: masked linear

# leading batch dimensions and ragged sizes: nothing a multiple of anything
ML_SHAPES = [((7,), 5, 3), ((3, 11), 13, 9), ((), 6, 4), ((70,), 17, 67)]


def _ml_inputs(lead, in_f, out_f, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(lead + (in_f,))
    w = rng.standard_normal((out_f, in_f))
    m = (rng.random((out_f, in_f)) < 0.6).astype(np.float64)
    b = rng.standard_normal(out_f)
    g = rng.standard_normal(lead + (out_f,))
    return x, w, m, b, g


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("lead, in_f, out_f", ML_SHAPES)
def test_masked_linear_matches_zuko_tpu(lead, in_f, out_f, bias):
    x, w, m, b, g = _ml_inputs(lead, in_f, out_f)

    def jf(x, w, b):
        return jax_ml.masked_linear(x, w, jnp.asarray(m), b if bias else None)

    jy, pull = jax.vjp(jf, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    jdx, jdw, jdb = pull(jnp.asarray(g))

    tx, tw, tb = (torch.as_tensor(v).requires_grad_(True) for v in (x, w, b))
    ty = torch_ml.masked_linear(tx, tw, torch.as_tensor(m), tb if bias else None)
    ty.backward(torch.as_tensor(g))

    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), rtol=1e-10, atol=1e-10)
    if bias:
        np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jdb), rtol=1e-10, atol=1e-10)

    # the Function's backward, as a plain function, against that autograd
    dx, dw, db = torch_ml._masked_linear_bwd(
        torch.as_tensor(g), tx.detach(), tw.detach(), torch.as_tensor(m), bias
    )
    torch.testing.assert_close(dx, tx.grad, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(dw, tw.grad, rtol=1e-12, atol=1e-12)
    assert (db is None) == (not bias)
    if bias:
        torch.testing.assert_close(db, tb.grad, rtol=1e-12, atol=1e-12)
    assert bool((dw[torch.as_tensor(m) == 0] == 0).all())  # masked entries stay put


# ------------------------------------------------------------- K5: spline


def _rqs_inputs(shape, knot_batch, K, seed=0):
    """Knots on [-3, 3] and points on about [-5, 5], so some fall outside
    the spline's domain on either side."""
    rng = np.random.default_rng(seed)

    def knots():
        w = rng.random(knot_batch + (K,)) + 0.1
        cs = np.cumsum(w / w.sum(-1, keepdims=True), axis=-1)
        return 3.0 * (2 * np.concatenate([np.zeros(knot_batch + (1,)), cs], axis=-1) - 1)

    hs, vs = knots(), knots()
    ds = np.exp(0.5 * rng.standard_normal(knot_batch + (K + 1,)))
    x = 5.0 * (2 * rng.random(shape) - 1)
    x.reshape(-1)[:2] = [-3.0, 3.0]  # the domain's edges themselves
    return x, hs, vs, ds


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("shape, knot_batch, K", [
    ((37,), (37,), 8),        # one row of knots per element
    ((5, 7, 3), (7, 3), 5),   # leading batch dimensions broadcast
    ((11,), (), 1),           # one set of knots for all, a single bin
])
def test_rqs_matches_zuko_tpu(shape, knot_batch, K, inverse):
    x, hs, vs, ds = _rqs_inputs(shape, knot_batch, K)
    rng = np.random.default_rng(1)
    ga, gb = rng.standard_normal(shape), rng.standard_normal(shape)
    jfn = jax_rqs.rqs_inverse if inverse else jax_rqs.rqs_forward
    tfn = torch_rqs.rqs_inverse if inverse else torch_rqs.rqs_forward

    (jout, jladj), pull = jax.vjp(jfn, *(jnp.asarray(v) for v in (x, hs, vs, ds)))
    jgrads = pull((jnp.asarray(ga), jnp.asarray(gb)))

    tins = [torch.as_tensor(v).requires_grad_(True) for v in (x, hs, vs, ds)]
    tout, tladj = tfn(*tins)
    cot = (torch.as_tensor(ga), torch.as_tensor(gb))
    tgrads = torch.autograd.grad((tout, tladj), tins, cot)

    outside = (x <= -3.0) | (x > 3.0)
    assert outside.any() and not outside.all()
    np.testing.assert_array_equal(tout.detach().numpy()[outside], x[outside])
    np.testing.assert_array_equal(tladj.detach().numpy()[outside], 0.0)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tladj.detach().numpy(), np.asarray(jladj), rtol=1e-12, atol=1e-12)
    for tg, jg in zip(tgrads, jgrads):
        assert tg.shape == jg.shape
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-10, atol=1e-10)

    # the Function's backward, as a plain function, against that autograd
    needs = (True, False, True, True)
    got = torch_rqs._rqs_bwd(cot, [t.detach() for t in tins], inverse, needs)
    assert got[1] is None
    for g, tg, need in zip(got, tgrads, needs):
        if need:
            torch.testing.assert_close(g, tg, rtol=1e-12, atol=1e-12)


def test_rqs_round_trip_and_inverse_ladj():
    x, hs, vs, ds = (torch.as_tensor(v) for v in _rqs_inputs((64,), (64,), 8, seed=2))
    y, ladj = torch_rqs.rqs_forward(x, hs, vs, ds)
    back, ladj_inv = torch_rqs.rqs_inverse(y, hs, vs, ds)
    torch.testing.assert_close(back, x, rtol=0, atol=1e-10)
    torch.testing.assert_close(ladj_inv, -ladj, rtol=0, atol=1e-9)


def test_rqs_transform_matches_its_op():
    """``MonotonicRQSTransform``'s own arithmetic (the default path) and the
    op's plain version are the same function."""
    from zuko_tpu_torch.transforms import MonotonicRQSTransform

    rng = np.random.default_rng(3)
    t = MonotonicRQSTransform(*(torch.as_tensor(rng.standard_normal((9, 4, n)))
                                for n in (8, 8, 7)))
    x = torch.as_tensor(4.0 * rng.standard_normal((9, 4)))
    knots = (t.horizontal, t.vertical, t.derivatives)
    for own, op in ((t.call_and_ladj, torch_rqs.rqs_forward),
                    (t.inverse_and_ladj, torch_rqs.rqs_inverse)):
        for a, b in zip(own(x), op(x, *knots)):
            torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
