r"""Whole-flow Gaussianization-flow (GF) density and sampling: plain PyTorch
versions and the CUDA kernels that replace the TPU kernels.

Counterpart of ``zuko_tpu/ops/gf_fused.py``. Two kernels, both in
``csrc/gf_fused.cu``:

* ``gf_density`` replaces ``_gf_impl`` (:540, ``pallas_call`` at :562): the
  whole-flow GF ``log_prob`` — every element-wise gaussianization layer
  :math:`y = \sqrt 2\,\mathrm{erfinv}\big(\tfrac{1-\epsilon}{K}\sum_i
  \mathrm{erf}((s_i x + b_i)/\sqrt 2)\big)` with its analytic log-sum-exp
  log-Jacobian, every rotation between the layers and the standard-normal
  base term — in one launch.
* ``gf_sample`` replaces ``_gf_sample_core`` (:616, ``pallas_call`` at :657):
  the whole inversion, layers in reverse, each gaussianization layer by 29
  even subdivisions of :math:`[-10, 10]` per feature compared in erf space,
  and optionally ``log q`` at the returned point.

Each wrapper takes the plain version for a tensor that lies on the CPU, and
launches its kernel (or raises) for a CUDA tensor. :func:`plan_gf` chooses
the kernels' tier from the flow's shape: the narrow tier within its limits,
the wide tier (a row's values in a workspace in device memory) beyond them.
The sampler's narrow tier is tiled (a block a tile of rows, one thread a
(row, feature) pair, the pair's mixture in registers) where every
gaussianization layer has the same number of components, at most
:data:`_GF_REGS`: ``plan_gf(..., sample=True)`` returns its
:class:`~zuko_tpu_torch.ops.nsf_fused.TilePlan`.
``LAUNCHES`` counts the kernel launches under ``gf_density``, ``gf_sample``
and ``gf_sample_log_prob``, the wide tier's under ``<name>_wide``.

A flow is handed to them flat: ``params`` lists, stage by stage, a layer's
``shift`` and log-scales ``raw`` — ``(F, K)`` each, or ``(n, F, K)`` each
when a batched context gives every row its own — and a rotation's matrix
``R``; ``layout`` names the stages. The TPU kernels' layout choices are not
carried over: rows are row-major, per-row parameters stay where the
hyper-network wrote them (no column blocks appended to the data), and
``erf`` / ``erfinv`` are the library's, not polynomial stand-ins.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..transforms import GaussianizationTransform, RotationTransform
from ..utils import bisection, unpack
from ._common import (
    LAUNCHES,
    PlainBackward,
    check_cuda_f32,
    narrow_plan,
    wide_plan,
    workspace,
)
from .nsf_fused import FusedStructureError, TilePlan, _require_standard_base

__all__ = [
    "extract_gf_params",
    "fused_gf_log_prob",
    "fused_gf_sample",
    "gf_density",
    "gf_sample",
    "plan_gf",
]

# The narrow tier's limits (mirrored in csrc/gf_fused.cu): features, mixture
# components, and gaussianization layers and rotations together. Beyond any
# of them the wide tier takes the flow.
_MAX_FEATURES = 64
_MAX_COMPONENTS = 32
_MAX_STAGES = 64
_KIND_CODE = {"gauss": 0, "gaussb": 1, "rot": 2}
# The tiled sampler (``gf_sample_tiled`` in csrc/gf_fused.cu): the most
# components a pair holds in registers, and the rows of its tile
_GF_REGS = 16
_GF_TILE = 128

# The bracket and the step count of the sampling bisection: those of
# ``MonotonicTransform`` (bound 10, eps 1e-6) with its margin of 4 steps. Even
# subdivisions, not Newton: on the plateaus of a saturated erf mixture a
# clipped Newton step leaves log q 10 nats from the density at the same point
# (``zuko_tpu/ops/gf_fused.py:378-386``).
_GF_BOUND = 10.0
_GF_N_ITER = int(math.ceil(math.log2(2 * _GF_BOUND / 1e-6))) + 4


# ------------------------------------------------------------- extraction


def extract_gf_params(flow, c=None, built=None):
    """Validate a GF structure and pull its parameters out.

    Returns ``(stages, features)``, the stages in forward order as ``("gauss",
    shift (F, K), raw (F, K))``, ``("gaussb", shift (*B, F, K), raw (*B, F,
    K))`` or ``("rot", A (F, F))``, ``raw`` the log-scales. A conditional
    layer's hyper-network runs here, outside the kernels (its outputs do not
    depend on ``x``); under a batched context its per-row outputs are marked
    ``gaussb``, and are views of the hyper-network's output. A caller that
    holds ``built = flow.transform(c)`` hands it in, and the layers'
    parameters are read from it instead of running the hyper-networks a
    second time. Anything else raises :class:`FusedStructureError`."""
    from ..flows.gaussianization import ElementWiseTransform
    from ..lazy import LazyComposedTransform, UnconditionalTransform

    if not isinstance(getattr(flow, "transform", None), LazyComposedTransform):
        raise FusedStructureError(
            "fused GF kernels require a Flow with a LazyComposedTransform"
        )
    stages, features = [], None
    for i, t in enumerate(flow.transform.transforms):
        if isinstance(t, UnconditionalTransform):
            if t.f is not RotationTransform or t.kwargs or len(t.args) != 1:
                raise FusedStructureError(
                    f"fused GF kernels support RotationTransform interleaves only, got {t.f}"
                )
            A = t.args[0]
            if A.dim() != 2 or A.shape[0] != A.shape[1]:
                raise FusedStructureError(f"rotation A must be square, got {tuple(A.shape)}")
            stages.append(("rot", A))
            continue
        if type(t) is not ElementWiseTransform:
            raise FusedStructureError(
                "fused GF kernels support ElementWiseTransform and rotation"
                f" layers only, got {type(t).__name__}"
            )
        if t.univariate is not GaussianizationTransform:
            raise FusedStructureError(
                "fused GF kernels support GaussianizationTransform univariates"
                f" only, got {t.univariate}"
            )
        if (
            len(t.shapes) != 2 or t.shapes[0] != t.shapes[1]
            or len(t.shapes[0]) != 1 or t.shapes[0][0] < 1
        ):
            raise FusedStructureError(f"unexpected GF shapes {t.shapes}")
        if t.hyper is not None:
            if c is None:
                raise FusedStructureError("conditional GF called without context")
            batched = c.dim() > 1
            if built is None:
                phi = t.hyper(c)
                shift, raw = unpack(phi.reshape(phi.shape[:-1] + (-1, t.total)), t.shapes)
            else:
                shift, raw = built.transforms[i].base.shift, built.transforms[i].base.log_scale
        else:
            batched = False
            shift, raw = t.phi
        if features is None:
            features = shift.shape[-2]
        if tuple(shift.shape[-2:]) != (features, t.shapes[0][0]):
            raise FusedStructureError(f"inconsistent GF layer shapes: {tuple(shift.shape)}")
        stages.append(("gaussb" if batched else "gauss", shift, raw))

    if features is None:
        raise FusedStructureError("flow has no gaussianization layers")
    for kind, *tensors in stages:
        if kind == "rot" and tuple(tensors[0].shape) != (features, features):
            raise FusedStructureError(
                f"rotation shape {tuple(tensors[0].shape)} != ({features}, {features})"
            )
    _require_standard_base(flow, features)
    return stages, features


def _flatten_gf(flow, c=None, built=None):
    """``(params, layout, F, cbatch)``: the stages' tensors in one flat list
    (``shift, raw`` per layer, ``R`` per rotation), ``layout`` one ``("gauss",
    K)`` / ``("gaussb", K)`` / ``("rot",)`` entry per stage, and ``cbatch``
    the batch shape of the per-row parameters (``()`` without any).
    ``R = matrix_exp(A - Aᵀ)`` is computed here (or was, by ``built =
    flow.transform(c)``), outside the ``autograd.Function``s, so the gradient
    to ``A`` is autograd's own."""
    stages, features = extract_gf_params(flow, c, built)
    params, layout, cbatch = [], [], ()
    for i, (kind, *tensors) in enumerate(stages):
        if kind == "rot":
            params.append(RotationTransform(tensors[0]).R if built is None
                          else built.transforms[i].R)
            layout.append(("rot",))
        else:
            params += tensors
            layout.append((kind, tensors[0].shape[-1]))
            if kind == "gaussb":
                cbatch = tuple(tensors[0].shape[:-2])
    return params, tuple(layout), features, cbatch


def _stages(params, layout):
    """``(kind, tensors)`` per stage from the flat list."""
    idx = 0
    for entry in layout:
        width = 1 if entry[0] == "rot" else 2
        yield entry[0], params[idx : idx + width]
        idx += width


# ------------------------------------------------------------ plain versions


def _gauss_forward(x, shift, raw):
    """One gaussianization layer on rows: ``x (n, F)``, ``shift`` and ``raw``
    ``(F, K)`` or ``(n, F, K)`` -> ``(y (n, F), ladj (n, F))`` (counterpart of
    ``_gauss_forward_F`` :316): the transform's own analytic form."""
    return GaussianizationTransform(shift, raw).call_and_ladj(x)


def _gauss_inverse(y, shift, raw):
    """Solve ``f(x) = y`` by bisection in erf space (counterpart of
    ``_gauss_inverse_F`` :391): ``f(x) = y`` iff ``m(x) = erf(y / sqrt 2)``,
    and erf is monotone, so comparing the mixture mean with that target takes
    the decisions of a bisection on ``f`` without an ``erfinv`` per step."""
    scale = torch.exp(raw)
    shrink = (1 - GaussianizationTransform.EPS) / raw.shape[-1]

    def mean(x):
        z = x[..., None] * scale + shift
        return torch.erf(z / math.sqrt(2)).sum(dim=-1) * shrink

    target = torch.erf(y / math.sqrt(2))
    return bisection(mean, target, -_GF_BOUND, _GF_BOUND, n=_GF_N_ITER)


def _gf_math(x, params, layout, F):
    """Plain version of the density kernel (counterpart of ``_gf_math_T``
    :361): ``x (n, F) -> log_prob (n,)``."""
    acc = 0.0
    for kind, tensors in _stages(params, layout):
        if kind == "rot":
            x = x @ tensors[0].T
        else:
            x, ladj = _gauss_forward(x, *tensors)
            acc = acc + ladj.sum(dim=1)
    return acc - 0.5 * (x**2).sum(dim=1) - 0.5 * F * math.log(2 * math.pi)


def _gf_sample_math(z, params, layout, F, want_log_prob=False):
    """Plain version of the sampling kernel (counterpart of
    ``_gf_sample_math_T`` :416): base draws ``z (n, F) -> x (n, F)``, and
    with ``want_log_prob`` also ``log q (n,)``, the base density of ``z``
    plus every layer's forward log-Jacobian at its solved ``x``."""
    y = z
    if want_log_prob:
        acc = -0.5 * (z**2).sum(dim=1) - 0.5 * F * math.log(2 * math.pi)
    for kind, tensors in reversed(list(_stages(params, layout))):
        if kind == "rot":
            y = y @ tensors[0]  # Rᵀ y: the orthogonal inverse
        else:
            y = _gauss_inverse(y, *tensors)
            if want_log_prob:
                acc = acc + _gauss_forward(y, *tensors)[1].sum(dim=1)
    return (y, acc) if want_log_prob else y


# ---------------------------------------------------------- CUDA launches


def _tile_floats(F, R):
    """Floats of shared memory of the tiled sampler's tile of ``R`` rows
    (``tile_plan`` in ``csrc/gf_fused.cu``): the values, a rotation's output
    and the ladjs, ``[F][R]`` each, and the rotation ``[F][F]``."""
    return 3 * F * R + F * F


def plan_gf(layout, F, rows, sample=False):
    """The tier of the GF kernels for a flow of this shape (what the
    wrappers launch, from the shapes alone): the narrow tier within its
    limits, else the wide tier with a workspace of ``2 F`` floats a row (the
    two arrays a row's values ping-pong between) and a descriptor buffer of
    48 bytes a stage (``Stage`` in ``csrc/gf_fused.cu``). With ``sample``, a
    flow within the narrow limits whose gaussianization layers all have the
    same ``K <= _GF_REGS`` components plans the tiled sampler: a
    :class:`TilePlan` of ``_GF_TILE`` rows and its shared memory
    (``tiled_components`` and ``tile_plan`` in the source)."""
    Ks = {entry[1] for entry in layout if entry[0] != "rot"}
    K = max(Ks, default=0)
    if F <= _MAX_FEATURES and K <= _MAX_COMPONENTS and len(layout) <= _MAX_STAGES:
        if sample and len(Ks) == 1 and K <= _GF_REGS:
            return TilePlan(*narrow_plan(rows), _GF_TILE, 4 * _tile_floats(F, _GF_TILE))
        return narrow_plan(rows)
    return wide_plan(2 * F, rows, 48 * len(layout))


def _launch(fn, counter, x, outs, params, layout, F):
    """Common launch path of the two kernels: check, plan the tier, pack the
    stages without per-row parameters into one buffer (a layer as
    ``[F][3][K]``: shift, ``exp(raw)``, raw; a rotation as ``R``), describe
    the others by pointer and strides, call the C entry point on the current
    stream (the sampler's with the tile of its plan, 0 where it is not
    tiled), raise on a CUDA error, count (the wide tier under
    ``<counter>_wide``)."""
    from ._build import check_launch, load_library

    if x.dim() != 2 or x.shape[1] != F or not x.is_contiguous():
        raise ValueError(f"{counter}: expected a contiguous (n, {F}) tensor")
    check_cuda_f32(counter, [x, *params])
    n = x.shape[0]
    sample = fn == "gf_sample_f32"
    plan = plan_gf(layout, F, n, sample)
    # one row per stage: kind, K, offset in `packed`, and for per-row
    # parameters the two pointers with their row and feature strides
    table, chunks, floats = [], [], 0
    keep = []  # contiguous copies, alive until the launch is queued
    for kind, tensors in _stages(params, layout):
        entry = [_KIND_CODE[kind], 0, floats, None, None, 0, 0]
        if kind == "rot":
            (R,) = tensors
            if tuple(R.shape) != (F, F):
                raise ValueError(f"{counter}: rotation of shape {tuple(R.shape)}, F = {F}")
            chunks.append(R.detach().reshape(-1))
        else:
            shift, raw = (t.detach() for t in tensors)
            K = entry[1] = shift.shape[-1]
            batch = (n,) if kind == "gaussb" else ()
            if tuple(shift.shape) != batch + (F, K) or raw.shape != shift.shape:
                raise ValueError(
                    f"{counter}: layer parameters of shape {tuple(shift.shape)},"
                    f" expected {batch + (F, K)}"
                )
            if kind == "gauss":
                chunks.append(torch.stack([shift, torch.exp(raw), raw], dim=1).reshape(-1))
            else:
                if shift.stride(2) != 1 or raw.stride() != shift.stride():
                    shift, raw = shift.contiguous(), raw.contiguous()
                    keep += [shift, raw]
                entry[3:] = [shift.data_ptr(), raw.data_ptr(), shift.stride(0), shift.stride(1)]
        if kind != "gaussb":
            floats += chunks[-1].numel()
        table.append(entry)
    packed = torch.cat(chunks) if chunks else x.new_zeros(1)
    ctypes_of = (ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int)
    columns = [(ctype * len(table))(*column) for ctype, column in zip(ctypes_of, zip(*table))]

    work, desc = workspace(plan, x.device)

    lib = load_library("gf_fused")
    with torch.cuda.device(x.device):
        rc = getattr(lib, fn)(
            x.data_ptr(), *outs, packed.data_ptr(),
            *(ctypes.addressof(column) for column in columns), len(table), F, n, int(plan.wide),
            None if work is None else work.data_ptr(), 0 if work is None else work.numel(),
            plan.chunk_rows, None if desc is None else desc.data_ptr(), plan.desc_bytes,
            torch.cuda.current_stream().cuda_stream,
            *((getattr(plan, "tile_rows", 0),) if sample else ()),
        )
    check_launch(counter, lib, "gf_fused", rc)
    LAUNCHES[counter + ("_wide" if plan.wide else "")] += 1


def _density_kernel(x, params, layout, F):
    out = torch.empty(x.shape[0], device=x.device, dtype=torch.float32)
    _launch("gf_density_f32", "gf_density", x, [out.data_ptr()], params, layout, F)
    return out


def gf_density(x, params, layout, F):
    r"""Whole-flow GF log-density ``x (n, F) -> (n,)``: the ``gf_density``
    kernel for a CUDA tensor (differentiable through
    :class:`~._common.PlainBackward`, the backward of ``_gf_bwd`` :497), the
    plain version for a CPU tensor."""
    if not x.is_cuda:
        return _gf_math(x, params, layout, F)
    return PlainBackward.apply(x.contiguous(), _density_kernel, _gf_math, (layout, F), *params)


def gf_sample(z, params, layout, F, want_log_prob=False):
    r"""Whole-flow GF inversion ``z (n, F) -> x (n, F)``, and with
    ``want_log_prob`` also ``log q (n,)``: the ``gf_sample`` kernel for a CUDA
    tensor, the plain version for a CPU tensor. Not differentiable; the
    differentiable form is :mod:`zuko_tpu_torch.ops.ift`."""
    if not z.is_cuda:
        with torch.no_grad():
            return _gf_sample_math(z, params, layout, F, want_log_prob)
    z = z.contiguous()
    x = torch.empty(z.shape[0], F, device=z.device, dtype=torch.float32)
    lq = torch.empty(z.shape[0], device=z.device, dtype=torch.float32) \
        if want_log_prob else None
    _launch(
        "gf_sample_f32", "gf_sample_log_prob" if want_log_prob else "gf_sample", z,
        [x.data_ptr(), None if lq is None else lq.data_ptr()], params, layout, F,
    )
    return (x, lq) if want_log_prob else x


# ------------------------------------------------------------ flow level


def _rows(t, batch, event):
    """``t (*, *event)`` broadcast to ``batch`` and flattened to rows; a view
    where no broadcasting is needed."""
    return t.expand(batch + t.shape[t.dim() - event :]).reshape((-1,) + t.shape[t.dim() - event :])


def _row_params(params, layout, batch):
    """The flat list with every per-row parameter as ``(n, F, K)`` rows of
    ``batch``."""
    out = []
    for kind, tensors in _stages(params, layout):
        out += [_rows(t, batch, 2) for t in tensors] if kind == "gaussb" else tensors
    return out


def fused_gf_log_prob(flat, x):
    r"""``flow(c).log_prob(x)`` for a GF through :func:`gf_density`, with
    ``flat = _flatten_gf(flow, c)`` (counterpart of ``fused_gf_log_prob``
    :468). Under a batched context the batch of ``x`` broadcasts against the
    context's."""
    params, layout, F, cbatch = flat
    if x.shape[-1] != F:
        raise FusedStructureError(f"x has {x.shape[-1]} features, flow has {F}")
    batch = torch.broadcast_shapes(x.shape[:-1], cbatch)
    out = gf_density(_rows(x, batch, 1), _row_params(params, layout, batch), layout, F)
    return out.reshape(batch)


def _gf_prep_sample(flat, sample_shape, generator):
    """The sampling preamble (counterpart of ``_gf_prep_sample`` :576):
    ``(shape, z (n, F), params)`` with ``shape = sample_shape + cbatch +
    (F,)`` — a batched context's batch dimensions come after the draw shape —
    ``z`` the standard-normal draws from ``torch.randn(...,
    generator=generator)`` and ``params`` the per-row parameters broadcast
    over the draws."""
    params, layout, F, cbatch = flat
    shape = tuple(sample_shape) + cbatch + (F,)
    z = torch.randn(shape, generator=generator, device=params[0].device, dtype=params[0].dtype)
    return shape, z.reshape(-1, F), _row_params(params, layout, shape[:-1])


def fused_gf_sample(flat, sample_shape=(), generator=None, want_log_prob=False):
    r"""Draw ``sample_shape + cbatch + (F,)`` samples (and ``log q`` with
    ``want_log_prob``) through :func:`gf_sample`, with ``flat =
    _flatten_gf(flow, c)`` (counterpart of ``fused_gf_sample`` :598). Not
    differentiable: :func:`zuko_tpu_torch.ops.ift.fused_gf_rsample` is."""
    shape, z, params = _gf_prep_sample(flat, sample_shape, generator)
    out = gf_sample(z, params, flat[1], flat[2], want_log_prob)
    if want_log_prob:
        x, lq = out
        return x.reshape(shape), lq.reshape(shape[:-1])
    return out.reshape(shape)
