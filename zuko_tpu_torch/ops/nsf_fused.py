r"""Whole-flow NSF/MAF density and sampling: plain PyTorch versions and the
CUDA kernels that replace the TPU kernels.

Counterpart of ``zuko_tpu/ops/nsf_fused.py``. Three kernels, all in
``csrc/nsf_fused.cu``:

* ``nsf_density`` replaces ``_fused_impl`` (:1793, ``pallas_call`` at :1842):
  the whole-flow autoregressive ``log_prob`` — every MADE hyper pass, every
  univariate forward and its log-Jacobian, and the standard-normal base
  term — in one launch, with no intermediate in device memory.
* ``nsf_sample`` replaces ``_sample_core`` (:1575, ``pallas_call`` at :1658):
  the whole autoregressive inversion (layers in reverse, ``min(passes, F)``
  Jacobi sweeps each, closed-form univariate inverses) and optionally
  ``log q`` at the returned point, or (raw mode) the bare sum of the forward
  log-Jacobians there.
* ``nsf_apply`` replaces ``_apply_impl`` (:2134, ``pallas_call`` at :2183):
  the forward map ``T(u)`` of the whole flow and the bare sum of its
  log-Jacobians, no base term. An inverted flow samples through it.

Each wrapper takes the plain version for a tensor that lies on the CPU, and
launches its kernel (or raises) for a CUDA tensor. ``LAUNCHES`` counts the
kernel launches, one per call that reaches a kernel.

The TPU kernels' layout choices are not carried over: the batch is
row-major ``(n, F + C)`` and the hyper-net's last layer keeps the MADE's
feature-major output order ``[f * T + t]`` (``T = 3K - 1`` for the spline,
2 for the affine), which suits a kernel that handles one feature's ``T``
parameters at a time. Everything runs in full float32; there is no
counterpart of the TPU's compensated logs or bf16 weight splits.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..distributions import DiagNormal
from ..flows.autoregressive import MaskedAutoregressiveTransform
from ..lazy import LazyComposedTransform, UnconditionalDistribution
from ..nn import Activation, MaskedLinear
from ..transforms import MonotonicAffineTransform, MonotonicRQSTransform
from ._common import LAUNCHES, check_cuda_f32, reset_launches

__all__ = [
    "FusedStructureError",
    "LAUNCHES",
    "extract_nsf_params",
    "fused_nsf_apply",
    "fused_nsf_log_prob",
    "fused_nsf_sample",
    "nsf_apply",
    "nsf_density",
    "nsf_sample",
    "reset_launches",
]

# Limits of the kernels (mirrored in csrc/nsf_fused.cu): the widest hyper
# layer, including the F + C inputs; the spline bins; linears per hyper-net;
# autoregressive layers per flow.
_MAX_WIDTH = 256
_MAX_BINS = 32
_MAX_LINEAR = 8
_MAX_LAYERS = 64
_UNIV_CODE = {"affine": 0, "rqs": 1}


class FusedStructureError(ValueError):
    """The flow's structure cannot be represented by the fused kernels.

    :func:`zuko_tpu_torch.ops.dispatch.maybe_fused_flow` catches it and the
    flow keeps the unfused transform path; direct calls surface it."""


# ------------------------------------------------------------- extraction


def _univ_config(univariate, shapes):
    """Resolve the univariate callable (possibly a ``functools.partial``
    chain) to ``(kind, K, bound, slope)``."""
    func, kw = univariate, {}
    while isinstance(func, functools.partial):
        if func.args:
            raise FusedStructureError(
                f"fused kernels do not support positional partial args ({func})"
            )
        kw = {**func.keywords, **kw}
        func = func.func

    shapes = tuple(tuple(s) for s in shapes)
    if func is MonotonicRQSTransform:
        K = shapes[0][0] if len(shapes) == 3 and shapes[0] else 0
        if K < 1 or shapes != ((K,), (K,), (K - 1,)):
            raise FusedStructureError(f"unexpected RQS shapes {shapes}")
        if set(kw) - {"bound", "slope"}:
            raise FusedStructureError(f"unsupported RQS kwargs {set(kw)}")
        return "rqs", K, float(kw.get("bound", 5.0)), float(kw.get("slope", 1e-3))
    if func is MonotonicAffineTransform:
        if shapes != ((), ()):
            raise FusedStructureError(f"unexpected affine shapes {shapes}")
        if set(kw) - {"slope"}:
            raise FusedStructureError(f"unsupported affine kwargs {set(kw)}")
        return "affine", 0, 5.0, float(kw.get("slope", 1e-3))
    # circular splines, SOSP and Bernstein polynomials come with their
    # flows' slices of the port
    raise FusedStructureError(
        f"fused kernels support RQS and affine univariates, got {func}"
    )


def _is_relu(fn) -> bool:
    return fn is torch.relu or fn is torch.nn.functional.relu


def _extract_mlp_linears(hyper):
    """Require a plain ``[MaskedLinear, ReLU]* MaskedLinear`` stack with
    biases and return its linears; residual blocks, other activations and
    bias-free layers raise :class:`FusedStructureError`."""
    lins = []
    expect_linear = True
    for layer in hyper.layers:
        if expect_linear:
            if type(layer) is not MaskedLinear:
                raise FusedStructureError(
                    "fused kernels support plain MaskedLinear stacks;"
                    f" hyper-net contains {type(layer).__name__}"
                )
            if layer.bias is None:
                raise FusedStructureError("fused kernels require biased layers")
            lins.append(layer)
        elif not (isinstance(layer, Activation) and _is_relu(layer.fn)):
            raise FusedStructureError(
                "fused kernels support ReLU hyper-net activations only"
            )
        expect_linear = not expect_linear
    if expect_linear or not lins:
        raise FusedStructureError("hyper-net must end with a linear layer")
    return lins


def _require_standard_base(flow, features):
    """Require a constant standard-normal ``DiagNormal`` base: the kernels
    hardcode the N(0, I) density."""
    base = getattr(flow, "base", None)
    if not isinstance(base, UnconditionalDistribution) or base.f is not DiagNormal:
        raise FusedStructureError(
            "fused kernels require an UnconditionalDistribution(DiagNormal)"
            f" base, got {type(base).__name__}"
        )
    if base.kwargs or len(base.args) != 2:
        raise FusedStructureError("fused kernels support DiagNormal(loc, scale) only")
    loc, scale = base.args
    if not (torch.is_tensor(loc) and torch.is_tensor(scale)):
        raise FusedStructureError("base loc/scale must be tensors")
    if loc.requires_grad or scale.requires_grad:
        raise FusedStructureError(
            "base loc/scale are trainable; fused kernels support constant"
            " standard-normal bases only"
        )
    if loc.shape != (features,) or scale.shape != (features,):
        raise FusedStructureError(
            f"base loc/scale must have shape ({features},),"
            f" got {tuple(loc.shape)}/{tuple(scale.shape)}"
        )
    if not (bool(torch.all(loc == 0)) and bool(torch.all(scale == 1))):
        raise FusedStructureError("fused kernels assume a standard-normal base")


def _univ_size(univ, K):
    return 3 * K - 1 if univ == "rqs" else 2


def extract_nsf_params(flow):
    """Pull the per-layer (weights, biases, masks, passes) out of an NSF/MAF
    flow module, strictly verifying the supported structure (plain ReLU MADE
    hyper-nets of one shape, RQS or affine univariates of one configuration,
    a standard DiagNormal base). Anything else raises
    :class:`FusedStructureError`. Returns ``(layers, cfg)`` with
    ``cfg = {bins, univ, bound, slope}``."""
    if not isinstance(getattr(flow, "transform", None), LazyComposedTransform):
        raise FusedStructureError(
            "fused kernels require a LazyComposedTransform flow, got"
            f" {type(getattr(flow, 'transform', None)).__name__}"
        )
    layers, cfg, shapes = [], None, None
    for t in flow.transform.transforms:
        # softclip interleaves (SOSPF) come with that flow's slice
        if type(t) is not MaskedAutoregressiveTransform:
            raise FusedStructureError(
                "fused AR kernels support MaskedAutoregressiveTransform layers"
                f" only, got {type(t).__name__}"
            )
        conf = _univ_config(t.univariate, t.shapes)
        if cfg is not None and conf != cfg:
            raise FusedStructureError(
                f"layers must share a univariate config: {cfg} vs {conf}"
            )
        cfg = conf
        lins = _extract_mlp_linears(t.hyper)
        lin_shapes = [tuple(l.weight.shape) for l in lins]
        if shapes is not None and lin_shapes != shapes:
            raise FusedStructureError(
                f"layers must share hyper-net shapes: {shapes} vs {lin_shapes}"
            )
        shapes = lin_shapes
        layers.append({
            "weights": [l.weight for l in lins],
            "biases": [l.bias for l in lins],
            "masks": [l.mask for l in lins],
            "passes": int(t.passes),
        })
    if cfg is None:
        raise FusedStructureError("flow has no transform layers")

    univ, K, bound, slope = cfg
    _require_standard_base(flow, shapes[-1][0] // _univ_size(univ, K))
    return layers, {"bins": K, "univ": univ, "bound": bound, "slope": slope}


def _flatten_flow(flow):
    """``(params, layout, cfg)``: ``params`` is the flat list
    ``[W, b, M, ...]`` over every AR layer's linears, ``layout`` one
    ``(n_linear, passes)`` entry per layer (counterpart of
    ``nsf_fused._flatten_flow`` :1473, without its param-major permutation)."""
    layers, cfg = extract_nsf_params(flow)
    params, layout = [], []
    for layer in layers:
        layout.append((len(layer["weights"]), layer["passes"]))
        for W, b, M in zip(layer["weights"], layer["biases"], layer["masks"]):
            params += [W, b, M]
    return params, tuple(layout), cfg


def _split_layers(params, layout):
    """``[(ps, passes), ...]`` per AR layer, ``ps = [W, b, M, ...]``."""
    out, idx = [], 0
    for n_lin, passes in layout:
        out.append((params[idx : idx + 3 * n_lin], passes))
        idx += 3 * n_lin
    return out


# ------------------------------------------------------------ plain versions


def _hyper(xc, ps):
    """Masked hyper-MLP: ``(n, F + C) -> (n, F * T)``, feature-major."""
    h = xc
    n_lin = len(ps) // 3
    for i in range(n_lin):
        W, b, M = ps[3 * i : 3 * i + 3]
        h = torch.addmm(b, h, (M * W).T)
        if i < n_lin - 1:
            h = torch.relu(h)
    return h


class _PlainRQS(MonotonicRQSTransform):
    """The spline with its own arithmetic on any device: what the plain
    versions compute and the Functions' backward passes differentiate, on the
    GPU too, where the transform itself launches the ``rqs`` kernel."""

    call_and_ladj = MonotonicRQSTransform._forward_math
    inverse_and_ladj = MonotonicRQSTransform._inverse_math


def _univariate(h, F, K, bound, slope, univ):
    phi = h.reshape(h.shape[0], F, -1)
    if univ == "rqs":
        return _PlainRQS(
            phi[..., :K], phi[..., K : 2 * K], phi[..., 2 * K :],
            bound=bound, slope=slope,
        )
    return MonotonicAffineTransform(phi[..., 0], phi[..., 1], slope=slope)


def _univ_forward(x, h, F, K, bound, slope, univ):
    """One layer's univariate forward from its hyper outputs ``h (n, F *
    T)``: ``(y (n, F), ladj (n, F))``, the log-Jacobian per element
    (counterpart of ``_univ_forward_F`` :823). Feature ``f`` of ``y``
    depends on ``x[:, f]`` and on ``h[:, f * T : (f + 1) * T]`` only."""
    return _univariate(h, F, K, bound, slope, univ).call_and_ladj(x)


def _full_math(xc, params, layout, F, K, bound, slope, univ, raw=False):
    """Plain version of the density kernel (counterpart of ``_full_math_T``
    :1268): ``xc (n, F + C) -> log_prob (n,)``. With ``raw`` it is the plain
    version of the apply kernel instead: ``(y (n, F), sum_ladj (n,))``, the
    transformed points and the bare sum of log-Jacobians, no base term."""
    x, c = xc[:, :F], xc[:, F:]
    acc = 0.0
    for ps, _ in _split_layers(params, layout):
        h = _hyper(torch.cat([x, c], dim=1), ps)
        x, ladj = _univ_forward(x, h, F, K, bound, slope, univ)
        acc = acc + ladj
    if raw:
        return x, torch.sum(acc, dim=1)
    return torch.sum(acc - 0.5 * x**2, dim=1) - 0.5 * F * math.log(2 * math.pi)


def _sample_math(zc, params, layout, F, K, bound, slope, univ,
                 want_log_prob=False):
    """Plain version of the sampling kernel (counterpart of
    ``_sample_math_T`` :1348): ``zc (n, F + C)`` base draws (+ context) ->
    ``x (n, F)``, and ``log q (n,) = base(z) + sum of forward ladjs`` with
    ``want_log_prob``; with ``want_log_prob="raw"`` the sum starts at zero
    instead of ``base(z)``: the bare sum of forward ladjs at ``x``. Layers
    run in reverse, each with ``min(passes, F)`` Jacobi sweeps: every sweep
    evaluates the hyper-net on the whole current iterate, then inverts every
    feature."""
    y, c = zc[:, :F], zc[:, F:]
    if want_log_prob == "raw":
        acc = torch.zeros_like(y[:, 0])
    elif want_log_prob:
        acc = -0.5 * torch.sum(y**2, dim=1) - 0.5 * F * math.log(2 * math.pi)
    for ps, passes in reversed(_split_layers(params, layout)):
        x = torch.zeros_like(y)
        for _ in range(min(passes, F)):
            h = _hyper(torch.cat([x, c], dim=1), ps)
            x = _univariate(h, F, K, bound, slope, univ).inverse(y)
        if want_log_prob:
            h = _hyper(torch.cat([x, c], dim=1), ps)
            _, ladj = _univ_forward(x, h, F, K, bound, slope, univ)
            acc = acc + ladj.sum(dim=1)
        y = x
    return (y, acc) if want_log_prob else y


# ---------------------------------------------------------- CUDA launches


def _pack_weights(params, layout, F, C, K, univ):
    """Validate the shapes against the kernels' limits and pack, per AR
    layer, ``[M⊙W_0, b_0, M⊙W_1, b_1, ...]`` into one contiguous buffer (the
    mask is multiplied in once per call, as ``_presplit_params``' "mask"
    mode does). Returns ``(packed, widths, passes, layer_floats)``."""
    layers = _split_layers(params, layout)
    first = layers[0][0]
    widths = [first[0].shape[1]] + [first[3 * i].shape[0] for i in range(len(first) // 3)]
    T = _univ_size(univ, K)
    if widths[0] != F + C or widths[-1] != F * T:
        raise ValueError(f"hyper-net widths {widths} do not match F={F}, C={C}, T={T}")
    if max(widths[:-1]) > _MAX_WIDTH or F > _MAX_WIDTH:
        raise ValueError(f"the kernels take hyper-net widths <= {_MAX_WIDTH}, got {widths}")
    if K > _MAX_BINS:
        raise ValueError(f"the kernels take at most {_MAX_BINS} bins, got {K}")
    if len(widths) - 1 > _MAX_LINEAR or len(layers) > _MAX_LAYERS:
        raise ValueError(
            f"the kernels take <= {_MAX_LINEAR} linears per hyper-net and"
            f" <= {_MAX_LAYERS} layers"
        )
    chunks = []
    for ps, _ in layers:
        for i in range(len(ps) // 3):
            W, b, M = ps[3 * i : 3 * i + 3]
            chunks += [(M * W).reshape(-1), b]
    packed = torch.cat(chunks).detach().contiguous()
    layer_floats = packed.numel() // len(layers)
    return packed, widths, [p for _, p in layers], layer_floats


def _launch(fn, counter, xc, outs, params, layout, F, K, bound, slope, univ):
    """Common launch path of the kernels: check, pack, call the C entry
    point with the input, the output pointers ``outs`` and the packed
    weights on the current stream, raise on a CUDA error, count."""
    from ._build import check_launch, load_library

    if xc.dim() != 2 or not xc.is_contiguous():
        raise ValueError(f"{counter}: expected a contiguous (n, F + C) tensor")
    check_cuda_f32(counter, [xc, *params])
    C = xc.shape[1] - F
    packed, widths, passes, layer_floats = _pack_weights(params, layout, F, C, K, univ)
    lib = load_library("nsf_fused")
    smem = 4 * layer_floats
    limit = lib.nsf_max_shared_bytes(xc.device.index)
    if smem > limit:
        raise ValueError(
            f"{counter}: one layer's weights take {smem} bytes of shared"
            f" memory, the card allows {limit}"
        )
    c_widths = (ctypes.c_int * len(widths))(*widths)
    c_passes = (ctypes.c_int * len(passes))(*passes)
    with torch.cuda.device(xc.device):
        rc = getattr(lib, fn)(
            xc.data_ptr(), *outs, packed.data_ptr(),
            ctypes.addressof(c_widths), ctypes.addressof(c_passes),
            len(widths) - 1, len(passes), F, C, K, _UNIV_CODE[univ],
            bound, math.log(slope), xc.shape[0],
            torch.cuda.current_stream().cuda_stream,
        )
    check_launch(counter, lib, "nsf_fused", rc)
    LAUNCHES[counter] += 1


def _density_kernel(xc, params, layout, F, K, bound, slope, univ):
    out = torch.empty(xc.shape[0], device=xc.device, dtype=torch.float32)
    _launch("nsf_density_f32", "nsf_density", xc, [out.data_ptr()],
            params, layout, F, K, bound, slope, univ)
    return out


def _apply_kernel(xc, params, layout, F, K, bound, slope, univ):
    y = torch.empty(xc.shape[0], F, device=xc.device, dtype=torch.float32)
    ladj = torch.empty(xc.shape[0], device=xc.device, dtype=torch.float32)
    _launch("nsf_apply_f32", "nsf_apply", xc, [y.data_ptr(), ladj.data_ptr()],
            params, layout, F, K, bound, slope, univ)
    return y, ladj


def _plain_backward(ctx, cotangents, raw):
    """Backward of the density and apply Functions: recompute the plain
    version (``_full_math``) on the saved inputs and differentiate it, as
    ``_fused_bwd`` (:1746) and ``_apply_bwd`` (:2083) do. There is no
    backward kernel. Returns the gradients of ``(xc, statics, *params)``."""
    xc, *params = ctx.saved_tensors
    needs = ctx.needs_input_grad
    with torch.enable_grad():
        xc_ = xc.detach().requires_grad_(needs[0])
        ps = [p.detach().requires_grad_(needs[2 + i]) for i, p in enumerate(params)]
        out = _full_math(xc_, ps, *ctx.statics, raw=raw)
        wrt = [t for t in [xc_, *ps] if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wrt, cotangents, allow_unused=True))
    dx = next(grads) if needs[0] else None
    return (dx, None, *(next(grads) if p.requires_grad else None for p in ps))


class _DensityFunction(torch.autograd.Function):
    """Kernel forward, plain backward (:func:`_plain_backward`)."""

    @staticmethod
    def forward(ctx, xc, statics, *params):
        ctx.statics = statics
        ctx.save_for_backward(xc, *params)
        return _density_kernel(xc, params, *statics)

    @staticmethod
    def backward(ctx, g):
        return _plain_backward(ctx, g, raw=False)


class _ApplyFunction(torch.autograd.Function):
    """Kernel forward, plain backward (:func:`_plain_backward`); counterpart
    of ``_apply_op`` (:2072)."""

    @staticmethod
    def forward(ctx, xc, statics, *params):
        ctx.statics = statics
        ctx.save_for_backward(xc, *params)
        return _apply_kernel(xc, params, *statics)

    @staticmethod
    def backward(ctx, gy, gl):
        return _plain_backward(ctx, (gy, gl), raw=True)


def nsf_density(xc, params, layout, F, K, bound, slope, univ):
    r"""Whole-flow log-density ``xc (n, F + C) -> (n,)``: the ``nsf_density``
    kernel for a CUDA tensor (differentiable through its
    ``autograd.Function``), the plain version for a CPU tensor."""
    if not xc.is_cuda:
        return _full_math(xc, params, layout, F, K, bound, slope, univ)
    return _DensityFunction.apply(
        xc.contiguous(), (layout, F, K, bound, slope, univ), *params
    )


def nsf_apply(xc, params, layout, F, K, bound, slope, univ):
    r"""Whole-flow forward map ``xc (n, F + C) -> (T(x) (n, F), sum_ladj
    (n,))``, no base term: the ``nsf_apply`` kernel for a CUDA tensor
    (differentiable through its ``autograd.Function``), the plain version
    for a CPU tensor."""
    if not xc.is_cuda:
        return _full_math(xc, params, layout, F, K, bound, slope, univ, raw=True)
    return _ApplyFunction.apply(
        xc.contiguous(), (layout, F, K, bound, slope, univ), *params
    )


# C entry point and launch counter of each sampling mode (``want_log_prob``)
_SAMPLE_MODES = {
    False: ("nsf_sample_f32", "nsf_sample"),
    True: ("nsf_sample_f32", "nsf_sample_log_prob"),
    "raw": ("nsf_sample_raw_f32", "nsf_sample_raw"),
}


def nsf_sample(zc, params, layout, F, K, bound, slope, univ, want_log_prob=False):
    r"""Whole-flow inversion ``zc (n, F + C) -> x (n, F)``, and with
    ``want_log_prob`` also ``log q (n,)`` or (``"raw"``) the bare sum of the
    forward log-Jacobians at ``x``: the ``nsf_sample`` kernel for a CUDA
    tensor, the plain version for a CPU tensor. Not differentiable; the
    differentiable form is :mod:`zuko_tpu_torch.ops.ift`."""
    if not zc.is_cuda:
        with torch.no_grad():
            return _sample_math(zc, params, layout, F, K, bound, slope, univ,
                                want_log_prob)
    fn, counter = _SAMPLE_MODES[want_log_prob]
    zc = zc.contiguous()
    x = torch.empty(zc.shape[0], F, device=zc.device, dtype=torch.float32)
    lq = torch.empty(zc.shape[0], device=zc.device, dtype=torch.float32) \
        if want_log_prob else None
    _launch(
        fn, counter, zc, [x.data_ptr(), None if lq is None else lq.data_ptr()],
        params, layout, F, K, bound, slope, univ,
    )
    return (x, lq) if want_log_prob else x


# ------------------------------------------------------------ flow level


def _statics(cfg, F):
    return F, cfg["bins"], cfg["bound"], cfg["slope"], cfg["univ"]


def _with_context(x, c):
    """``(batch, xc (n, F + C))``: ``x (*, F)`` beside its context ``c (*,
    C)``, broadcast against each other's batch and flattened to rows."""
    F = x.shape[-1]
    if c is None:
        return x.shape[:-1], x.reshape(-1, F)
    batch = torch.broadcast_shapes(x.shape[:-1], c.shape[:-1])
    xc = torch.cat(
        [x.expand(batch + (F,)), c.to(x.dtype).expand(batch + c.shape[-1:])], dim=-1
    )
    return batch, xc.reshape(-1, xc.shape[-1])


def fused_nsf_log_prob(flat, x, c=None):
    r"""``flow(c).log_prob(x)`` for an NSF/MAF through :func:`nsf_density`,
    with ``flat = _flatten_flow(flow)``. A batched context broadcasts against
    the batch of ``x``."""
    params, layout, cfg = flat
    batch, xc = _with_context(x, c)
    return nsf_density(xc, params, layout, *_statics(cfg, x.shape[-1])).reshape(batch)


def fused_nsf_apply(flat, u, c=None):
    r"""Forward-apply the flow's transform through :func:`nsf_apply`:
    ``(T(u), sum of forward ladjs at u)``, with ``flat =
    _flatten_flow(flow)`` (counterpart of ``fused_nsf_apply`` :2212). It is
    the sampling direction of an inverted flow ``Flow(flow.transform.inv,
    flow.base)``: ``sample' = T(z')``, ``log q' = base(z') - sum_ladj``.
    Differentiable."""
    params, layout, cfg = flat
    F = u.shape[-1]
    batch, uc = _with_context(u, c)
    y, ladj = nsf_apply(uc, params, layout, *_statics(cfg, F))
    return y.reshape(batch + (F,)), ladj.reshape(batch)


def fused_nsf_sample(flat, sample_shape=(), c=None, generator=None,
                     want_log_prob=False):
    r"""Draw ``sample_shape + batch + (F,)`` samples (and ``log q`` with
    ``want_log_prob``) through :func:`nsf_sample`, with ``flat =
    _flatten_flow(flow)``. The standard-normal base draws come from
    ``torch.randn(..., generator=generator)``, so a caller can hand the
    same draws to the plain version."""
    shape, zc = _base_draws(flat, sample_shape, c, generator)
    params, layout, cfg = flat
    out = nsf_sample(zc, params, layout, *_statics(cfg, shape[-1]), want_log_prob)
    if want_log_prob:
        x, lq = out
        return x.reshape(shape), lq.reshape(shape[:-1])
    return out.reshape(shape)


def _base_draws(flat, sample_shape, c, generator):
    """The sampling preamble (counterpart of ``_prep_sample`` :1503):
    ``(shape, zc)`` with ``shape = sample_shape + batch + (F,)`` and ``zc
    (n, F + C)`` the standard-normal draws beside the broadcast context."""
    W0 = flat[0][0]
    C = 0 if c is None else c.shape[-1]
    F = W0.shape[1] - C
    cbatch = () if c is None else tuple(c.shape[:-1])
    shape = tuple(sample_shape) + cbatch + (F,)
    z = torch.randn(shape, generator=generator, device=W0.device, dtype=W0.dtype)
    zc = z.reshape(-1, F)
    if c is not None:
        cf = c.to(z.dtype).expand(tuple(sample_shape) + cbatch + (C,))
        zc = torch.cat([zc, cf.reshape(-1, C)], dim=-1)
    return shape, zc
