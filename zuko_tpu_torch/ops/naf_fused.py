r"""Whole-flow neural autoregressive flow (NAF) density and sampling: plain
PyTorch versions and the CUDA kernels that replace the TPU kernels.

Counterpart of ``zuko_tpu/ops/naf_fused.py``, for the monotone-network (MNN)
univariate. Two kernels, both in ``csrc/naf_fused.cu``:

* ``naf_density`` replaces ``_naf_density_impl`` (:904, ``pallas_call`` at
  :949): the whole-flow ``log_prob``. Per autoregressive layer, the MADE pass
  gives every feature its signal; the monotone network's first layer is
  split into its signal part (computed once, "hoisted") and its ``x``
  column; one evaluation of the network and of its derivative ``g`` gives
  the feature's output and its log-Jacobian ``log g``. Softclips between the
  layers and the standard-normal base term close the sum.
* ``naf_sample`` replaces ``_naf_sample_core`` (:1054, ``pallas_call`` at
  :1128): the whole inversion, stages in reverse. A softclip inverts in
  closed form; an autoregressive layer by ``min(passes, F)`` sweeps, each a
  MADE pass on the current iterate and, per feature, a bracketed bisection
  followed by Newton steps on the monotone network. The first sweep bisects
  ``[-10, 10]`` 10 times; the later ones start from the previous sweep's
  root (a bracket of radius 0.0625 checked by two evaluations, the full
  bracket for the rows where it does not hold the root) and bisect 3 times.
  Three Newton steps follow, each clamped to ``[-10, 10]``. With
  ``want_log_prob`` it also returns ``log q`` at the returned point.

Each wrapper takes the plain version for a tensor that lies on the CPU, and
launches its kernel (or raises) for a CUDA tensor. ``LAUNCHES`` counts the
kernel launches under ``naf_density``, ``naf_sample`` and
``naf_sample_log_prob``.

A flow is handed to them flat: per autoregressive stage the MADE's masked
weights ``M ⊙ W`` and biases, then the monotone network's positive weights
``|W|`` of shape ``(F, out, in)`` and biases ``(F, out)``; ``layout`` names
the stages. Both products are taken once per ``flow(c)``, outside the
kernels, and stay in the autograd graph of the flow's parameters. The TPU
kernels' workarounds are not carried over: no tile arithmetic, no bf16
product splits, no compensated logs, and no route by width to another path.
The UMNN univariate (UNAF) is not ported yet.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as Fn

from ._common import LAUNCHES, PlainBackward, check_cuda_f32
from .nsf_fused import (
    FusedStructureError,
    _base_draws,
    _extract_mlp_linears,
    _require_standard_base,
    _with_context,
)

__all__ = [
    "extract_naf_params",
    "fused_naf_log_prob",
    "fused_naf_sample",
    "naf_density",
    "naf_sample",
]

# Limits of the kernels (mirrored in csrc/naf_fused.cu): features, signal
# size, monotone-network and MADE widths (the MADE's F + C inputs included,
# its F * S outputs excluded: they are computed a feature at a time), linears
# per network, and autoregressive layers and softclips together.
_MAX_FEATURES = 64
_MAX_SIGNAL = 64
_MAX_MONO_WIDTH = 128
_MAX_MADE_WIDTH = 256
_MAX_LINEAR = 8
_MAX_STAGES = 64

# The solve of ``MonotonicTransform`` (bound 10) as the TPU sampler runs it:
# a coarse bisection to 2e-2 (10 halvings of [-10, 10]), then Newton steps,
# whose derivative is floored; later sweeps bracket the previous root.
_BOUND = 10.0
_N_COARSE = math.ceil(math.log2(2 * _BOUND / 2e-2))
_WARM_R = 0.0625
_N_WARM = math.ceil(math.log2(2 * _WARM_R / 2e-2))
_N_NEWTON = 3
_DF_FLOOR = 1e-12


# ------------------------------------------------------------- extraction


def _extract_monotone_net(net, features, signal):
    """Require ``[MonotonicLinear, TwoWayELU(alpha=1)]* MonotonicLinear``,
    biased, stacked over ``features``, mapping ``1 + signal`` inputs to one
    output with at least one hidden layer of even width (the TwoWayELU
    halves); return its linears."""
    from ..nn import MonotonicLinear, TwoWayELU

    lins, expect_linear = [], True
    for layer in net.layers:
        if expect_linear:
            if type(layer) is not MonotonicLinear:
                raise FusedStructureError(
                    f"fused NAF kernels expect MonotonicLinear stacks, got {type(layer).__name__}"
                )
            if layer.bias is None or layer.weight.dim() != 3:
                raise FusedStructureError("the monotone net must be biased and stacked per feature")
            lins.append(layer)
        elif type(layer) is not TwoWayELU or layer.alpha != 1.0:
            raise FusedStructureError(
                f"fused NAF kernels expect TwoWayELU(alpha=1) activations, got {layer}"
            )
        expect_linear = not expect_linear
    if expect_linear or len(lins) < 2:
        raise FusedStructureError(
            "the monotone net must end with a linear and have a hidden layer"
            " (its first layer is hoisted per sweep)"
        )
    if any(tuple(l.weight.shape[::2]) != (features, l.in_features) for l in lins):
        raise FusedStructureError("the monotone net must be stacked over the features")
    if lins[0].in_features != 1 + signal or lins[-1].out_features != 1:
        raise FusedStructureError(f"the monotone net must map {1 + signal} inputs to 1")
    if any(l.out_features % 2 for l in lins[:-1]):
        raise FusedStructureError("TwoWayELU needs even hidden widths")
    return lins


def extract_naf_params(flow):
    """Validate a NAF structure and pull its parameters out (counterpart of
    ``extract_naf_params`` :131, MNN stages only): masked autoregressive
    layers with an :class:`~zuko_tpu_torch.flows.neural.MNN` univariate,
    unconditional ``SoftclipTransform`` interleaves, plain ReLU MADE
    hyper-networks and a standard ``DiagNormal`` base. Returns ``(stages,
    {"signal": S, "features": F})`` with stages ``("softclip", bound)`` or
    ``("ar", {made_w, made_b, made_m, mono_w, mono_b, passes})``. Anything
    else raises :class:`FusedStructureError`."""
    from ..flows.autoregressive import MaskedAutoregressiveTransform
    from ..flows.neural import MNN
    from ..lazy import LazyComposedTransform, UnconditionalTransform
    from ..transforms import SoftclipTransform

    if not isinstance(getattr(flow, "transform", None), LazyComposedTransform):
        raise FusedStructureError(
            "fused NAF kernels require a LazyComposedTransform flow, got"
            f" {type(getattr(flow, 'transform', None)).__name__}"
        )
    stages, S, F = [], None, None
    for t in flow.transform.transforms:
        if isinstance(t, UnconditionalTransform):
            if t.f is not SoftclipTransform or t.args or set(t.kwargs) - {"bound"}:
                raise FusedStructureError(
                    f"fused NAF kernels support SoftclipTransform interleaves only, got {t.f}"
                )
            stages.append(("softclip", float(t.kwargs.get("bound", 1.0))))
            continue
        if type(t) is not MaskedAutoregressiveTransform:
            raise FusedStructureError(
                "fused NAF kernels support MaskedAutoregressiveTransform layers only,"
                f" got {type(t).__name__}"
            )
        if not isinstance(t.univariate, MNN):
            raise FusedStructureError(
                "fused NAF kernels take MNN univariates; the UMNN univariate (UNAF)"
                f" is not ported yet, got {type(t.univariate).__name__}"
            )
        if len(t.shapes) != 1 or len(t.shapes[0]) != 1:
            raise FusedStructureError(f"unexpected MNN shapes {t.shapes}")
        if S is not None and t.shapes[0][0] != S:
            raise FusedStructureError("layers must share the signal size")
        S = t.shapes[0][0]
        made = _extract_mlp_linears(t.hyper)
        net = t.univariate.network
        F = net.layers[0].weight.shape[0] if F is None else F
        mono = _extract_monotone_net(net, F, S)
        stages.append(("ar", {
            "made_w": [l.weight for l in made],
            "made_b": [l.bias for l in made],
            "made_m": [l.mask for l in made],
            "mono_w": [l.weight for l in mono],
            "mono_b": [l.bias for l in mono],
            "passes": int(t.passes),
        }))
    if F is None:
        raise FusedStructureError("flow has no autoregressive layers")
    _require_standard_base(flow, F)
    return stages, {"signal": S, "features": F}


def _flatten_naf(flow):
    """``(params, layout, F, S)`` (counterpart of ``_stage_layout`` :745):
    per autoregressive stage the flat list holds ``[M⊙W, b]`` per MADE
    linear, then ``|W|`` per monotone linear, then their biases; ``layout``
    has one ``("softclip", bound)`` or ``("ar", n_made, n_mono, passes)``
    entry per stage. The products are taken here, once per ``flow(c)``, so
    the gradients to ``W`` are autograd's own."""
    stages, cfg = extract_naf_params(flow)
    params, layout = [], []
    for kind, st in stages:
        if kind == "softclip":
            layout.append((kind, st))
            continue
        for W, b, M in zip(st["made_w"], st["made_b"], st["made_m"]):
            params += [M * W, b]
        params += [W.abs() for W in st["mono_w"]] + list(st["mono_b"])
        layout.append(("ar", len(st["made_w"]), len(st["mono_w"]), st["passes"]))
    return params, tuple(layout), cfg["features"], cfg["signal"]


def _stages(params, layout):
    """``(entry, made, mono_w, mono_b)`` per stage from the flat list
    (the three lists empty for a softclip)."""
    idx = 0
    for entry in layout:
        if entry[0] == "softclip":
            yield entry, [], [], []
            continue
        _, n_made, n_mono, _ = entry
        made = list(params[idx : idx + 2 * n_made])
        mono = list(params[idx + 2 * n_made : idx + 2 * n_made + 2 * n_mono])
        idx += 2 * (n_made + n_mono)
        yield entry, made, mono[:n_mono], mono[n_mono:]


# ------------------------------------------------------------ plain versions


def _made(xc, made):
    """The masked hyper-network on rows: ``(n, F + C) -> (n, F * S)``,
    feature-major (feature ``f``'s signal is ``[f * S, (f + 1) * S)``)."""
    h = xc
    for i in range(0, len(made), 2):
        h = torch.addmm(made[i + 1], h, made[i].T)
        if i < len(made) - 2:
            h = torch.relu(h)
    return h


def _two_way_elu(z, grad=False):
    """TwoWayELU on the last dimension and, with ``grad``, its derivative:
    ``elu'(z) = exp(min(z, 0))`` on the first half, ``elu'(-z)`` on the
    second (written without a ``where``, whose untaken ``exp`` branch would
    poison the gradient)."""
    a, b = torch.chunk(z, 2, dim=-1)
    v = torch.cat([Fn.elu(a), -Fn.elu(-b)], dim=-1)
    if not grad:
        return v
    return v, torch.cat([torch.exp(a.clamp(max=0)), torch.exp((-b).clamp(max=0))], dim=-1)


def _hoist(h, mono_w, mono_b, F, S):
    """The first monotone layer's signal part (counterpart of
    ``_hoist_first_layer`` :305): ``pre1 (n, F, H1) = W1[:, :, 1:] · s +
    b1``, constant through a sweep's solve, and the ``x`` column ``w1x (F,
    H1)``."""
    sig = h.reshape(h.shape[0], F, S)
    W1 = mono_w[0]
    return torch.einsum("fks,nfs->nfk", W1[..., 1:], sig) + mono_b[0], W1[..., 0]


def _mono(x, pre1, w1x, mono_w, mono_b, grad=False):
    """Every feature's monotone network at ``x (n, F)`` from the hoisted
    first layer: ``f(x) (n, F)`` and, with ``grad``, ``f'(x) (n, F)`` by
    forward mode (counterparts of ``_mono_eval_hoisted`` :322 and
    ``_mono_vg_hoisted`` :350). ``f' > 0``: positive weights, positive
    activation slopes."""
    z = pre1 + w1x * x[..., None]
    if grad:
        u, d = _two_way_elu(z, True)
        du = d * w1x
    else:
        u = _two_way_elu(z)
    for W, b in zip(mono_w[1:-1], mono_b[1:-1]):
        z = torch.einsum("fij,nfj->nfi", W, u) + b
        if grad:
            dz = torch.einsum("fij,nfj->nfi", W, du)
            u, d = _two_way_elu(z, True)
            du = d * dz
        else:
            u = _two_way_elu(z)
    wL = mono_w[-1][:, 0]
    value = torch.einsum("fj,nfj->nf", wL, u) + mono_b[-1][:, 0]
    return (value, torch.einsum("fj,nfj->nf", wL, du)) if grad else value


def _mono_layer(x, h, mono_w, mono_b, F, S):
    """An autoregressive layer's univariates at fixed hyper outputs ``h``:
    ``(y (n, F), ladj (n, F))``, ``ladj = log f'``. Feature ``f`` of ``y``
    reads ``x[:, f]`` and its signal in ``h`` only."""
    pre1, w1x = _hoist(h, mono_w, mono_b, F, S)
    y, g = _mono(x, pre1, w1x, mono_w, mono_b, grad=True)
    return y, torch.log(g)


def _softclip(x, bound):
    """``(x / (1 + |x / B|), -2 log1p(|x / B|))`` per element."""
    q = (x / bound).abs()
    return x / (1 + q), -2 * torch.log1p(q)


def _naf_density_math(xc, params, layout, F, S):
    """Plain version of the density kernel (counterpart of
    ``_naf_density_math_T`` :657): ``xc (n, F + C) -> log_prob (n,)``."""
    x, c = xc[:, :F], xc[:, F:]
    acc = 0.0
    for entry, made, mono_w, mono_b in _stages(params, layout):
        if entry[0] == "softclip":
            x, ladj = _softclip(x, entry[1])
        else:
            x, ladj = _mono_layer(x, _made(torch.cat([x, c], dim=1), made), mono_w, mono_b, F, S)
        acc = acc + ladj.sum(dim=1)
    return acc - 0.5 * (x**2).sum(dim=1) - 0.5 * F * math.log(2 * math.pi)


def _ar_inverse(y, c, made, mono_w, mono_b, passes, F, S):
    """Invert one autoregressive layer (counterpart of
    ``_ar_inverse_sweeps_T`` :492, its warm-started default): ``min(passes,
    F)`` Jacobi sweeps, each a MADE pass on the current iterate, then per
    feature a bisection and Newton steps on the monotone network."""
    x = torch.zeros_like(y)
    for sweep in range(min(passes, F)):
        pre1, w1x = _hoist(_made(torch.cat([x, c], dim=1), made), mono_w, mono_b, F, S)

        def f(t):
            return _mono(t, pre1, w1x, mono_w, mono_b)

        full_lo, full_hi = torch.full_like(y, -_BOUND), torch.full_like(y, _BOUND)
        if sweep == 0:
            lo, hi, n_bisect = full_lo, full_hi, _N_COARSE
        else:
            # the previous root brackets this sweep's where f says it does;
            # the other rows start again from the full bracket
            lo, hi = x - _WARM_R, x + _WARM_R
            ok = (f(lo) < y) & (y < f(hi))
            lo, hi, n_bisect = torch.where(ok, lo, full_lo), torch.where(ok, hi, full_hi), _N_WARM
        for _ in range(n_bisect):
            mid = 0.5 * (lo + hi)
            right = f(mid) < y
            lo, hi = torch.where(right, mid, lo), torch.where(right, hi, mid)
        x = 0.5 * (lo + hi)
        for _ in range(_N_NEWTON):
            value, g = _mono(x, pre1, w1x, mono_w, mono_b, grad=True)
            x = (x - (value - y) / g.clamp(min=_DF_FLOOR)).clamp(-_BOUND, _BOUND)
    return x


def _naf_sample_math(zc, params, layout, F, S, want_log_prob=False):
    """Plain version of the sampling kernel (counterpart of
    ``_naf_sample_math_T`` :706): ``zc (n, F + C)`` base draws (+ context)
    -> ``x (n, F)``, and with ``want_log_prob`` also ``log q (n,)``: the
    base density of ``z`` plus every stage's forward log-Jacobian at its
    solved input."""
    y, c = zc[:, :F], zc[:, F:]
    if want_log_prob:
        acc = -0.5 * (y**2).sum(dim=1) - 0.5 * F * math.log(2 * math.pi)
    for entry, made, mono_w, mono_b in reversed(list(_stages(params, layout))):
        if entry[0] == "softclip":
            x = y / (1 - (y / entry[1]).abs())
            if want_log_prob:
                acc = acc + _softclip(x, entry[1])[1].sum(dim=1)
        else:
            x = _ar_inverse(y, c, made, mono_w, mono_b, entry[3], F, S)
            if want_log_prob:
                h = _made(torch.cat([x, c], dim=1), made)
                acc = acc + _mono_layer(x, h, mono_w, mono_b, F, S)[1].sum(dim=1)
        y = x
    return (y, acc) if want_log_prob else y


# ---------------------------------------------------------- CUDA launches


def _check_limits(params, layout, F, C, S):
    """Raise ``ValueError`` for a flow the kernels do not take; return the
    MADE's and the monotone nets' widths."""
    widths = [
        ([made[0].shape[1]] + [W.shape[0] for W in made[0::2]],
         [mono_w[0].shape[2]] + [W.shape[1] for W in mono_w])
        for entry, made, mono_w, _ in _stages(params, layout) if entry[0] == "ar"
    ]
    made_w, mono_w = widths[0]
    if any(w != widths[0] for w in widths):
        raise ValueError("the kernels take autoregressive layers of one shape only")
    if (
        F > _MAX_FEATURES or S > _MAX_SIGNAL or made_w[0] != F + C
        or max(made_w[:-1]) > _MAX_MADE_WIDTH or max(mono_w[1:-1]) > _MAX_MONO_WIDTH
        or max(len(made_w), len(mono_w)) - 1 > _MAX_LINEAR or len(layout) > _MAX_STAGES
    ):
        raise ValueError(
            f"the kernels take <= {_MAX_FEATURES} features, a signal of <= {_MAX_SIGNAL},"
            f" MADE widths <= {_MAX_MADE_WIDTH} (inputs included), monotone widths <="
            f" {_MAX_MONO_WIDTH}, <= {_MAX_LINEAR} linears a network and <= {_MAX_STAGES}"
            f" stages; got F = {F}, S = {S}, MADE {made_w}, monotone {mono_w},"
            f" {len(layout)} stages"
        )
    return made_w, mono_w


def _launch(fn, counter, xc, outs, params, layout, F, S):
    """Common launch path of the two kernels: check, pack every stage's
    parameters into one buffer (a softclip holds none), describe the stages
    by kind, passes, bound and offset, call the C entry point on the current
    stream, raise on a CUDA error, count."""
    from ._build import check_launch, load_library

    if xc.dim() != 2 or not xc.is_contiguous() or xc.shape[1] < F:
        raise ValueError(f"{counter}: expected a contiguous (n, F + C) tensor, F = {F}")
    made_w, mono_w = _check_limits(params, layout, F, xc.shape[1] - F, S)
    check_cuda_f32(counter, [xc, *params])
    chunks, table, floats = [], [], 0
    for entry, made, mw, mb in _stages(params, layout):
        if entry[0] == "softclip":
            table.append((0, 0, entry[1], 0))
            continue
        # each linear's weights, then its bias
        ordered = made + [t for pair in zip(mw, mb) for t in pair]
        chunks += [t.detach().reshape(-1) for t in ordered]
        table.append((1, entry[3], 0.0, floats))
        floats += sum(t.numel() for t in ordered)
    packed = torch.cat(chunks)
    ctypes_of = (ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_longlong)
    columns = [(ctype * len(table))(*column) for ctype, column in zip(ctypes_of, zip(*table))]
    c_made = (ctypes.c_int * len(made_w))(*made_w)
    c_mono = (ctypes.c_int * len(mono_w))(*mono_w)

    lib = load_library("naf_fused")
    with torch.cuda.device(xc.device):
        rc = getattr(lib, fn)(
            xc.data_ptr(), *outs, packed.data_ptr(),
            *(ctypes.addressof(column) for column in columns), len(table),
            ctypes.addressof(c_made), len(made_w) - 1, ctypes.addressof(c_mono), len(mono_w) - 1,
            F, xc.shape[1] - F, S, xc.shape[0], torch.cuda.current_stream().cuda_stream,
        )
    check_launch(counter, lib, "naf_fused", rc)
    LAUNCHES[counter] += 1


def _density_kernel(xc, params, layout, F, S):
    out = torch.empty(xc.shape[0], device=xc.device, dtype=torch.float32)
    _launch("naf_density_f32", "naf_density", xc, [out.data_ptr()], params, layout, F, S)
    return out


def naf_density(xc, params, layout, F, S):
    r"""Whole-flow NAF log-density ``xc (n, F + C) -> (n,)``: the
    ``naf_density`` kernel for a CUDA tensor (differentiable through
    :class:`~._common.PlainBackward`, the backward of ``_naf_density_bwd``
    :855, without its TPU row chunking), the plain version for a CPU
    tensor."""
    if not xc.is_cuda:
        return _naf_density_math(xc, params, layout, F, S)
    return PlainBackward.apply(
        xc.contiguous(), _density_kernel, _naf_density_math, (layout, F, S), *params)


def naf_sample(zc, params, layout, F, S, want_log_prob=False):
    r"""Whole-flow NAF inversion ``zc (n, F + C) -> x (n, F)``, and with
    ``want_log_prob`` also ``log q (n,)``: the ``naf_sample`` kernel for a
    CUDA tensor, the plain version for a CPU tensor. Not differentiable; the
    differentiable form is :mod:`zuko_tpu_torch.ops.ift`."""
    if not zc.is_cuda:
        with torch.no_grad():
            return _naf_sample_math(zc, params, layout, F, S, want_log_prob)
    zc = zc.contiguous()
    x = torch.empty(zc.shape[0], F, device=zc.device, dtype=torch.float32)
    lq = torch.empty(zc.shape[0], device=zc.device, dtype=torch.float32) \
        if want_log_prob else None
    _launch(
        "naf_sample_f32", "naf_sample_log_prob" if want_log_prob else "naf_sample", zc,
        [x.data_ptr(), None if lq is None else lq.data_ptr()], params, layout, F, S,
    )
    return (x, lq) if want_log_prob else x


# ------------------------------------------------------------ flow level


def fused_naf_log_prob(flat, x, c=None):
    r"""``flow(c).log_prob(x)`` for a NAF through :func:`naf_density`, with
    ``flat = _flatten_naf(flow)`` (counterpart of ``fused_naf_log_prob``
    :971). A batched context broadcasts against the batch of ``x``."""
    params, layout, F, S = flat
    if x.shape[-1] != F:
        raise FusedStructureError(f"x has {x.shape[-1]} features, flow has {F}")
    batch, xc = _with_context(x, c)
    return naf_density(xc, params, layout, F, S).reshape(batch)


def fused_naf_sample(flat, sample_shape=(), c=None, generator=None, want_log_prob=False):
    r"""Draw ``sample_shape + cbatch + (F,)`` samples (and ``log q`` with
    ``want_log_prob``) through :func:`naf_sample`, with ``flat =
    _flatten_naf(flow)`` (counterpart of ``fused_naf_sample`` :1000). Not
    differentiable: :func:`zuko_tpu_torch.ops.ift.fused_naf_rsample` is. The
    draws are those of :func:`..nsf_fused._base_draws` (counterpart of
    ``_prep_naf_sample`` :1025): the flat list starts with the first MADE
    linear, as an NSF's does."""
    shape, zc = _base_draws(flat, sample_shape, c, generator)
    params, layout, F, S = flat
    out = naf_sample(zc, params, layout, F, S, want_log_prob)
    if want_log_prob:
        x, lq = out
        return x.reshape(shape), lq.reshape(shape[:-1])
    return out.reshape(shape)
