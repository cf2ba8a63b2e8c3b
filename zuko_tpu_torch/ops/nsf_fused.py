r"""Whole-flow NSF/MAF density and sampling: plain PyTorch versions and the
CUDA kernels that replace the TPU kernels.

Counterpart of ``zuko_tpu/ops/nsf_fused.py``. Three kernels, all in
``csrc/nsf_fused.cu``:

* ``nsf_density`` replaces ``_fused_impl`` (:1793, ``pallas_call`` at :1842):
  the whole-flow autoregressive ``log_prob`` — every MADE hyper pass, every
  univariate forward and its log-Jacobian, the softclips between the layers
  and the base term — in one launch, with no intermediate in device memory.
* ``nsf_sample`` replaces ``_sample_core`` (:1575, ``pallas_call`` at :1658):
  the whole autoregressive inversion (layers in reverse, ``min(passes, F)``
  Jacobi sweeps each; closed-form inverses for the affine map and the
  splines, a bisection and Newton solve for the polynomials) and optionally
  ``log q`` at the returned point, or (raw mode) the bare sum of the forward
  log-Jacobians there.
* ``nsf_apply`` replaces ``_apply_impl`` (:2134, ``pallas_call`` at :2183):
  the forward map ``T(u)`` of the whole flow and the bare sum of its
  log-Jacobians, no base term. An inverted flow samples through it.

Each wrapper takes the plain version for a tensor that lies on the CPU, and
launches its kernel (or raises) for a CUDA tensor. :func:`plan_nsf` chooses
the kernels' tier from the flow's shape: the narrow tier within its limits,
the wide tier (weights through the read-only cache, a row's state in a
workspace in device memory) beyond them. The sampler's narrow tier for
the closed-form univariates (affine and RQS), the circular spline and the
polynomials of at most :data:`_POLY_REGS` coefficients (Bernstein ``M +
5``, sum of squares ``P (L + 1)`` of at most :data:`_SOSP_NODES` nodes) is
tiled: a block a tile of rows, planned with :class:`TilePlan`; a larger
polynomial samples through the per-thread narrow kernel. So are the
density and apply of the same univariates (``nsf_density_tiled``); the
larger polynomials' stay per-thread. ``LAUNCHES`` counts the kernel
launches, one per call that reaches a kernel, the wide tier's under
``<name>_wide``.

Five univariates (``univ``), one flow's layers sharing one: ``affine``
(MAF), ``rqs`` (NSF), ``crqs`` (NCSF: the spline on ``(x mod 2π) - π``),
``sosp`` (SOSPF: a sum-of-squares polynomial integrated by ``L + 1``
Gauss-Legendre nodes, plus a shift) and ``bernstein`` (BPF: a bounds-pinned
Bernstein polynomial by De Casteljau). The base is a standard normal
(``("normal",)``) or, for NCSF, a constant box (``("box", lo, hi)``). The
launch counts of the three new modes carry the mode in their names:
``nsf_density_<mode>``, ``nsf_apply_<mode>``, ``nsf_sample_<mode>``,
``nsf_sample_<mode>_log_prob`` and ``nsf_sample_<mode>_raw``.

The polynomials' inverse is ``zuko_tpu``'s (``_poly_inverse_F`` :849), with
its warm-started later sweeps as the default: no switch. The first sweep
bisects ``[-B, B]`` ``ceil(log2(2B / 1e-3))`` times on the exact forward;
later sweeps bracket the previous sweep's root by ``_POLY_WARM_R`` (checked
by two evaluations; a row whose root left the bracket takes ``[-B, B]``) and
bisect ``ceil(log2(2r / 1e-3))`` times. Four Newton steps follow, each by the
forward's own derivative and clipped to ``[-B, B]``; a Bernstein polynomial's
targets beyond its ends take the closed form of its linear extension.

The TPU kernels' layout choices are not carried over: the batch is
row-major ``(n, F + C)`` and the hyper-net's last layer keeps the MADE's
feature-major output order ``[f * T + t]`` (``T = 3K - 1`` for the splines,
``P (L + 1) + 1`` for the sum-of-squares polynomial, ``M`` for the Bernstein
one, 2 for the affine), which suits a kernel that handles one feature's
``T`` parameters at a time. Everything runs in full float32; there is no
counterpart of the TPU's compensated logs or bf16 weight splits.
"""

from __future__ import annotations

import ctypes
import functools
import math

from typing import NamedTuple

import numpy as np
import torch

from ..distributions import BoxUniform, DiagNormal
from ..flows.autoregressive import MaskedAutoregressiveTransform
from ..lazy import LazyComposedTransform, UnconditionalDistribution, UnconditionalTransform
from ..nn import Activation, MaskedLinear
from ..transforms import (
    BoundedBernsteinTransform,
    MonotonicAffineTransform,
    MonotonicRQSTransform,
    SoftclipTransform,
)
from ._common import (
    LAUNCHES,
    check_cuda_f32,
    narrow_plan,
    reset_launches,
    wide_plan,
    workspace,
)

__all__ = [
    "FusedStructureError",
    "LAUNCHES",
    "TilePlan",
    "density_tile_rows",
    "extract_nsf_params",
    "fused_nsf_apply",
    "fused_nsf_log_prob",
    "fused_nsf_sample",
    "nsf_apply",
    "nsf_density",
    "nsf_sample",
    "plan_nsf",
    "reset_launches",
    "sample_tile_rows",
]

# The narrow tier's limits (mirrored in csrc/nsf_fused.cu): the widest hyper
# layer, including the F + C inputs; the spline bins; a feature's raw
# parameters (the thread's array of them); the Bernstein coefficients (M + 5
# De Casteljau entries) and the Gauss-Legendre nodes; linears per hyper-net;
# autoregressive layers per flow; and one layer's weights in a block's shared
# memory (the card's opt-in limit). Beyond any of them the wide tier takes the
# flow.
_MAX_WIDTH = 256
_MAX_BINS = 32
_MAX_T = 3 * _MAX_BINS - 1
_MAX_THETA = 64
# a polynomial's coefficients in the tiled sampler's registers (kPolyRegs):
# the Bernstein polynomial's M + 5, the sum of squares' P (L + 1), whose L + 1
# Gauss-Legendre nodes the kernel unrolls up to kSospNodes
_POLY_REGS = 24
_SOSP_NODES = 8
_MAX_NODES = 32
_MAX_LINEAR = 8
_MAX_LAYERS = 64
_SMEM_OPTIN = 232448  # bytes an H100 block may opt into
_UNIV_CODE = {"affine": 0, "rqs": 1, "crqs": 2, "sosp": 3, "bernstein": 4}
_NORMAL = ("normal",)
# the polynomial inverse (``_poly_inverse_F`` :849, ``_POLY_WARM_R`` :987):
# bisection to 1e-3, the warm sweeps' bracket radius, Newton steps
_POLY_XTOL = 1e-3
_POLY_WARM_R = 0.0625
_POLY_NEWTON = 4


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

    from ..flows.polynomial import ShiftedSOSPTransform
    from ..flows.spline import CircularRQSTransform

    shapes = tuple(tuple(s) for s in shapes)
    if func is MonotonicRQSTransform or func is CircularRQSTransform:
        K = shapes[0][0] if len(shapes) == 3 and shapes[0] else 0
        if K < 1 or shapes != ((K,), (K,), (K - 1,)):
            raise FusedStructureError(f"unexpected RQS shapes {shapes}")
        if func is CircularRQSTransform:
            # a circular shift, then the spline on [-pi, pi]
            if set(kw) - {"slope"}:
                raise FusedStructureError(f"unsupported NCSF kwargs {set(kw) - {'slope'}}")
            return "crqs", K, math.pi, float(kw.get("slope", 1e-3))
        if set(kw) - {"bound", "slope"}:
            raise FusedStructureError(f"unsupported RQS kwargs {set(kw)}")
        return "rqs", K, float(kw.get("bound", 5.0)), float(kw.get("slope", 1e-3))
    if func is MonotonicAffineTransform:
        if shapes != ((), ()):
            raise FusedStructureError(f"unexpected affine shapes {shapes}")
        if set(kw) - {"slope"}:
            raise FusedStructureError(f"unsupported affine kwargs {set(kw)}")
        return "affine", 0, 5.0, float(kw.get("slope", 1e-3))
    if func is ShiftedSOSPTransform:
        # K is the pair (polynomials, degree + 1); the bound is the
        # MonotonicTransform domain's
        if len(shapes) != 2 or len(shapes[0]) != 2 or shapes[1] != () or not all(shapes[0]):
            raise FusedStructureError(f"unexpected SOSP shapes {shapes}")
        if set(kw) - {"slope"}:
            raise FusedStructureError(f"unsupported SOSP kwargs {set(kw) - {'slope'}}")
        return "sosp", tuple(shapes[0]), 10.0, float(kw.get("slope", 1e-3))
    if func is BoundedBernsteinTransform:
        # K is the raw coefficient count M
        if len(shapes) != 1 or len(shapes[0]) != 1 or shapes[0][0] < 1:
            raise FusedStructureError(f"unexpected Bernstein shapes {shapes}")
        if kw:
            raise FusedStructureError(f"unsupported Bernstein kwargs {set(kw)}")
        return "bernstein", shapes[0][0], 5.0, 1e-3
    raise FusedStructureError(
        f"fused kernels support RQS, circular RQS, affine, SOSP and Bernstein univariates,"
        f" got {func}"
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


def _base_config(flow, features, univ):
    """The base as the kernels take it (counterpart of ``_base_config``
    :232): ``("normal",)`` for a standard ``DiagNormal``, ``("box", lo,
    hi)`` for the constant ``BoxUniform`` of a circular spline flow.
    Anything else raises :class:`FusedStructureError`."""
    if univ != "crqs":
        _require_standard_base(flow, features)
        return _NORMAL
    base = getattr(flow, "base", None)
    if not isinstance(base, UnconditionalDistribution) or base.f is not BoxUniform:
        raise FusedStructureError(
            "fused circular-spline kernels require an UnconditionalDistribution(BoxUniform)"
            f" base, got {type(base).__name__}"
        )
    if base.kwargs or len(base.args) != 2:
        raise FusedStructureError("fused kernels support BoxUniform(lower, upper) bases only")
    lo, hi = base.args
    if not (torch.is_tensor(lo) and torch.is_tensor(hi)):
        raise FusedStructureError("base bounds must be tensors")
    if lo.requires_grad or hi.requires_grad:
        raise FusedStructureError(
            "base bounds are trainable; fused kernels support constant boxes only")
    if lo.shape != (features,) or hi.shape != (features,):
        raise FusedStructureError(
            f"base bounds must have shape ({features},), got"
            f" {tuple(lo.shape)}/{tuple(hi.shape)}"
        )
    if bool(lo.min() != lo.max()) or bool(hi.min() != hi.max()):
        raise FusedStructureError("fused kernels support per-feature-constant boxes only")
    return ("box", float(lo[0]), float(hi[0]))


def _univ_size(univ, K):
    """``T``, the raw parameters of one feature (counterpart of
    ``_univ_size`` :1338)."""
    if univ in ("rqs", "crqs"):
        return 3 * K - 1
    if univ == "sosp":
        return K[0] * K[1] + 1  # (polynomials, degree + 1) coefficients and the shift
    if univ == "bernstein":
        return K
    return 2


def _softclip_entry(t):
    """``("softclip", B)`` of an unconditional ``SoftclipTransform(bound=B)``
    interleave, else :class:`FusedStructureError`."""
    if t.f is not SoftclipTransform or t.args or set(t.kwargs) - {"bound"}:
        raise FusedStructureError(
            f"fused AR kernels support SoftclipTransform(bound=...) interleaves only, got {t.f}"
        )
    return ("softclip", float(t.kwargs.get("bound", 1.0)))


def extract_nsf_params(flow):
    """Pull the per-layer (weights, biases, masks, passes) out of an
    autoregressive flow module (NSF, MAF, NCSF, SOSPF, BPF), strictly
    verifying the supported structure: plain ReLU MADE hyper-nets of one
    shape, univariates of one configuration, ``SoftclipTransform``
    interleaves each right after an autoregressive layer, and a standard
    ``DiagNormal`` base (a constant ``BoxUniform`` one for NCSF). Anything
    else raises :class:`FusedStructureError`. Returns ``(layers, cfg)``:
    ``layers`` holds a dict per autoregressive layer and ``("softclip", B)``
    per interleave, ``cfg = {bins, univ, bound, slope, base}``."""
    if not isinstance(getattr(flow, "transform", None), LazyComposedTransform):
        raise FusedStructureError(
            "fused kernels require a LazyComposedTransform flow, got"
            f" {type(getattr(flow, 'transform', None)).__name__}"
        )
    layers, cfg, shapes = [], None, None
    for t in flow.transform.transforms:
        if isinstance(t, UnconditionalTransform):
            # the kernels apply a softclip as the tail of the layer before it
            if not layers or not isinstance(layers[-1], dict):
                raise FusedStructureError(
                    "fused AR kernels take a softclip only right after an autoregressive layer")
            layers.append(_softclip_entry(t))
            continue
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
    base = _base_config(flow, shapes[-1][0] // _univ_size(univ, K), univ)
    return layers, {"bins": K, "univ": univ, "bound": bound, "slope": slope, "base": base}


def _flatten_flow(flow):
    """``(params, layout, cfg)``: ``params`` is the flat list
    ``[W, b, M, ...]`` over every AR layer's linears, ``layout`` one
    ``(n_linear, passes)`` entry per AR layer and ``("softclip", B)`` per
    interleave (counterpart of ``nsf_fused._flatten_flow`` :1473, without its
    param-major permutation)."""
    layers, cfg = extract_nsf_params(flow)
    params, layout = [], []
    for layer in layers:
        if not isinstance(layer, dict):
            layout.append(layer)
            continue
        layout.append((len(layer["weights"]), layer["passes"]))
        for W, b, M in zip(layer["weights"], layer["biases"], layer["masks"]):
            params += [W, b, M]
    return params, tuple(layout), cfg


def _stages(params, layout):
    """``[(ps, passes) | ("softclip", B), ...]`` in the flow's order, ``ps =
    [W, b, M, ...]`` an AR layer's linears."""
    out, idx = [], 0
    for entry in layout:
        if entry[0] == "softclip":
            out.append(entry)
            continue
        n_lin, passes = entry
        out.append((params[idx : idx + 3 * n_lin], passes))
        idx += 3 * n_lin
    return out


def _split_layers(params, layout):
    """``[(ps, passes), ...]`` per AR layer, ``ps = [W, b, M, ...]``."""
    return [st for st in _stages(params, layout) if st[0] != "softclip"]


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


def _circular_wrap(x, B):
    """``(x mod 2B) - B``: the circular shift, ladj 0, its own inverse on the
    circle."""
    return torch.remainder(x, 2 * B) - B


def _spline(phi, K, bound, slope):
    return _PlainRQS(
        phi[..., :K], phi[..., K : 2 * K], phi[..., 2 * K :], bound=bound, slope=slope)


def _sosp_forward(x, phi, PL, bound, slope, ladj=True):
    """The shifted sum-of-squares polynomial of every feature (counterpart
    of ``_sosp_forward_F`` :728): ``g(v) = mean_k (1 + p_k(v / B))^2 +
    slope`` with ``p_k`` of degree ``L`` by Horner's rule, integrated from 0
    to ``x`` exactly by the ``(L + 1)``-point Gauss-Legendre rule, plus the
    shift; the log-Jacobian is ``log g(x)``. ``phi (n, F, P (L + 1) + 1)``:
    coefficient ``(k, l)`` at ``k (L + 1) + l``, the shift last."""
    P, L1 = PL
    a = phi[..., : P * L1].reshape(phi.shape[:-1] + (P, L1))

    def g(v):
        u = (v / bound)[..., None]
        p = a[..., L1 - 1]
        for l in range(L1 - 2, -1, -1):
            p = p * u + a[..., l]
        return torch.sum((1 + p) ** 2, dim=-1) / P + slope

    nodes, weights = np.polynomial.legendre.leggauss(L1)
    quad = 0.0
    for t, w in zip(nodes.tolist(), weights.tolist()):
        quad = quad + w * g(x * (0.5 * (t + 1.0)))
    y = 0.5 * x * quad + phi[..., P * L1]
    return y, (torch.log(g(x)) if ladj else None)


def _decasteljau(theta, u):
    """The Bezier sum of ``theta (..., N)`` at ``u (...)`` by repeated lerps."""
    u = u[..., None]
    while theta.shape[-1] > 1:
        theta = theta[..., :-1] + u * (theta[..., 1:] - theta[..., :-1])
    return theta[..., 0]


def _bernstein_theta(phi, B):
    """The ``M + 5`` increasing coefficients of the bounds-pinned Bernstein
    polynomial from its ``M`` raw ones: ``-B``, two steps of ``d = 2B / (M +
    4)``, the softmax scaled to ``2B - 4d`` and two steps of ``d``,
    cumsummed."""
    M = phi.shape[-1]
    d = (2 * B) / (M + 4)
    run = torch.cumsum(torch.softmax(phi, dim=-1), dim=-1)
    ones = torch.ones_like(phi[..., :1])
    return torch.cat([
        -B * ones, (-B + d) * ones, (-B + 2 * d) * ones,
        (-B + 2 * d) + (2 * B - 4 * d) * run, (B - d) * ones, B * ones,
    ], dim=-1)


def _bernstein_forward(x, phi, B, ladj=True, eps=1e-6):
    """The bounds-pinned Bernstein polynomial of every feature (counterpart
    of ``_bernstein_forward_F`` :764) on ``u = (x + B) / 2B``, De Casteljau
    for the value and for its derivative (of the coefficients' differences
    times the order); the line of slope 1 through ``(+-B, +-B)`` outside
    ``[eps, 1 - eps]``, with log-Jacobian 0 there."""
    theta = _bernstein_theta(phi, B)
    u = (x + B) / (2 * B)
    lower, upper = u <= eps, u >= 1 - eps
    extrap = lower | upper
    u_safe = torch.where(extrap, 0.5, u)
    y = _decasteljau(theta, u_safe)
    y = torch.where(lower, 2 * B * (u - eps) - B, y)
    y = torch.where(upper, 2 * B * (u - 1 + eps) + B, y)
    if not ladj:
        return y, None
    order = theta.shape[-1] - 1
    dy = _decasteljau(order * (theta[..., 1:] - theta[..., :-1]), u_safe)
    return y, torch.where(extrap, 0.0, torch.log(dy) - math.log(2 * B))


def _univ_forward(x, h, F, K, bound, slope, univ, ladj=True):
    """One layer's univariate forward from its hyper outputs ``h (n, F *
    T)``: ``(y (n, F), ladj (n, F))``, the log-Jacobian per element
    (counterpart of ``_univ_forward_F`` :823; without ``ladj`` the
    polynomials skip it and return ``None``). Feature ``f`` of ``y`` depends
    on ``x[:, f]`` and on ``h[:, f * T : (f + 1) * T]`` only."""
    phi = h.reshape(h.shape[0], F, -1)
    if univ == "rqs":
        return _spline(phi, K, bound, slope).call_and_ladj(x)
    if univ == "crqs":
        return _spline(phi, K, bound, slope).call_and_ladj(_circular_wrap(x, bound))
    if univ == "sosp":
        return _sosp_forward(x, phi, K, bound, slope, ladj)
    if univ == "bernstein":
        return _bernstein_forward(x, phi, bound, ladj)
    return MonotonicAffineTransform(phi[..., 0], phi[..., 1], slope=slope).call_and_ladj(x)


def _poly_inverse(y, h, F, K, bound, slope, univ, x0=None):
    """The polynomials' inverse (counterpart of ``_poly_inverse_F`` :849):
    bisection on the exact forward, cold on ``[-B, B]`` or (``x0``, a later
    sweep) warm around the previous root with the full bracket for the rows
    it does not hold; then Newton steps with the forward's own derivative
    ``exp(ladj)``, each clipped to ``[-B, B]``; a Bernstein target beyond
    the ends by the closed form of the linear extension."""
    def fwd(x, ladj=True):
        return _univ_forward(x, h, F, K, bound, slope, univ, ladj)

    full_lo, full_hi = torch.full_like(y, -bound), torch.full_like(y, bound)
    if x0 is None:
        lo, hi = full_lo, full_hi
        n_iters = math.ceil(math.log2(2 * bound / _POLY_XTOL))
    else:
        lo0 = torch.clamp(x0 - _POLY_WARM_R, -bound, bound)
        hi0 = torch.clamp(x0 + _POLY_WARM_R, -bound, bound)
        ok = (fwd(lo0, False)[0] < y) & (y < fwd(hi0, False)[0])
        lo, hi = torch.where(ok, lo0, full_lo), torch.where(ok, hi0, full_hi)
        n_iters = math.ceil(math.log2(2 * _POLY_WARM_R / _POLY_XTOL))
    for _ in range(n_iters):
        mid = 0.5 * (lo + hi)
        right = fwd(mid, False)[0] < y
        lo, hi = torch.where(right, mid, lo), torch.where(right, hi, mid)
    x = 0.5 * (lo + hi)
    for _ in range(_POLY_NEWTON):
        fv, ladj = fwd(x)
        x = torch.clamp(x - (fv - y) * torch.exp(-ladj), -bound, bound)
    if univ == "bernstein":
        f_hi, ladj_hi = fwd(full_hi)
        f_lo, ladj_lo = fwd(full_lo)
        x = torch.where(y > f_hi, bound + (y - f_hi) * torch.exp(-ladj_hi), x)
        x = torch.where(y < f_lo, -bound + (y - f_lo) * torch.exp(-ladj_lo), x)
    return x


def _univ_inverse(y, h, F, K, bound, slope, univ, x0=None):
    """One layer's univariate inverse at fixed hyper outputs (counterpart of
    ``_univ_inverse_F`` :910); ``x0`` warm-starts a polynomial's solve."""
    if univ in ("sosp", "bernstein"):
        return _poly_inverse(y, h, F, K, bound, slope, univ, x0)
    phi = h.reshape(h.shape[0], F, -1)
    if univ == "rqs":
        return _spline(phi, K, bound, slope).inverse(y)
    if univ == "crqs":
        return _circular_wrap(_spline(phi, K, bound, slope).inverse(y), bound)
    return MonotonicAffineTransform(phi[..., 0], phi[..., 1], slope=slope).inverse(y)


def _softclip(x, B):
    """``(x / (1 + |x / B|), -2 log1p(|x / B|))`` per element."""
    q = (x / B).abs()
    return x / (1 + q), -2 * torch.log1p(q)


def _base_log_prob(z, base):
    """The base's log-density of rows ``z (n, F)`` (counterpart of
    ``_base_log_prob_T`` :1246): standard normal, or the constant box, ``-F
    log(hi - lo)`` inside (bounds included) and ``-inf`` outside."""
    F = z.shape[1]
    if base[0] == "normal":
        return -0.5 * torch.sum(z**2, dim=1) - 0.5 * F * math.log(2 * math.pi)
    _, lo, hi = base
    inside = ((z >= lo) & (z <= hi)).all(dim=1)
    return torch.full_like(z[:, 0], -F * math.log(hi - lo)).masked_fill(~inside, -math.inf)


def _full_math(xc, params, layout, F, K, bound, slope, univ, base=_NORMAL, raw=False):
    """Plain version of the density kernel (counterpart of ``_full_math_T``
    :1268): ``xc (n, F + C) -> log_prob (n,)``. With ``raw`` it is the plain
    version of the apply kernel instead: ``(y (n, F), sum_ladj (n,))``, the
    transformed points and the bare sum of log-Jacobians, no base term."""
    x, c = xc[:, :F], xc[:, F:]
    acc = 0.0
    for stage in _stages(params, layout):
        if stage[0] == "softclip":
            x, ladj = _softclip(x, stage[1])
        else:
            h = _hyper(torch.cat([x, c], dim=1), stage[0])
            x, ladj = _univ_forward(x, h, F, K, bound, slope, univ)
        acc = acc + ladj
    if raw:
        return x, torch.sum(acc, dim=1)
    if base[0] == "normal":
        return torch.sum(acc - 0.5 * x**2, dim=1) - 0.5 * F * math.log(2 * math.pi)
    return torch.sum(acc, dim=1) + _base_log_prob(x, base)


def _sample_math(zc, params, layout, F, K, bound, slope, univ, base=_NORMAL,
                 want_log_prob=False):
    """Plain version of the sampling kernel (counterpart of
    ``_sample_math_T`` :1348): ``zc (n, F + C)`` base draws (+ context) ->
    ``x (n, F)``, and ``log q (n,) = base(z) + sum of forward ladjs`` with
    ``want_log_prob``; with ``want_log_prob="raw"`` the sum starts at zero
    instead of ``base(z)``: the bare sum of forward ladjs at ``x``. Stages
    run in reverse: a softclip inverts in closed form; an AR layer by
    ``min(passes, F)`` Jacobi sweeps, every sweep evaluating the hyper-net
    on the whole current iterate, then inverting every feature (a
    polynomial's later sweeps warm-started at the previous iterate)."""
    y, c = zc[:, :F], zc[:, F:]
    if want_log_prob == "raw":
        acc = torch.zeros_like(y[:, 0])
    elif want_log_prob:
        acc = _base_log_prob(y, base)
    poly = univ in ("sosp", "bernstein")
    for stage in reversed(_stages(params, layout)):
        if stage[0] == "softclip":
            x = y / (1 - (y / stage[1]).abs())
            if want_log_prob:
                acc = acc + _softclip(x, stage[1])[1].sum(dim=1)
            y = x
            continue
        ps, passes = stage
        x = torch.zeros_like(y)
        for sweep in range(min(passes, F)):
            h = _hyper(torch.cat([x, c], dim=1), ps)
            x = _univ_inverse(y, h, F, K, bound, slope, univ, x if poly and sweep else None)
        if want_log_prob:
            h = _hyper(torch.cat([x, c], dim=1), ps)
            _, ladj = _univ_forward(x, h, F, K, bound, slope, univ)
            acc = acc + ladj.sum(dim=1)
        y = x
    return (y, acc) if want_log_prob else y


# ---------------------------------------------------------- CUDA launches


def _knot_slots(univ, K):
    """Floats of each of a row's three knot columns in the wide tier: the
    spline's ``K + 1`` knots (xs, ys, ds), or the Bernstein coefficients,
    their differences and a De Casteljau scratch of ``M + 5``; none for the
    sum-of-squares polynomial (the ``Row`` fields of ``csrc/nsf_fused.cu``)."""
    if univ == "bernstein":
        return K + 5
    if univ == "sosp":
        return 0
    return K + 1


def _fits_arrays(univ, K):
    """Whether one feature's parameters and solver state fit the narrow
    tier's per-thread arrays."""
    T = _univ_size(univ, K)
    if univ in ("rqs", "crqs"):
        return K <= _MAX_BINS
    if univ == "sosp":
        return T <= _MAX_T and K[1] <= _MAX_NODES
    if univ == "bernstein":
        return T <= _MAX_T and K + 5 <= _MAX_THETA
    return True


def _pad8(v):
    return -(-v // 8) * 8


#: The tiles of the tiled kernels, in rows, largest first
#: (``nsf_sample_tiled``, ``nsf_density_tiled``, a block of 256 threads a
#: tile).
_SAMPLE_TILES = (128, 64, 32)
# a block's shared memory where two blocks share an SM: the 233,472 bytes
# of an sm_90 SM, the only target the kernels are built for, less 1 KB a
# block reserved (the per-block limit is queried, nsf_max_shared_bytes)
_TWO_A_SM = (233472 - 2 * 1024) // 2


class TilePlan(NamedTuple):
    """The tiled narrow tier of a sampler or of a density and apply: the
    fields of
    :class:`~zuko_tpu_torch.ops._common.KernelPlan`, then the rows of its
    tile and the block's shared memory."""

    wide: bool
    slots: int
    chunk_rows: int
    workspace_bytes: int
    desc_bytes: int
    tile_rows: int
    shared_bytes: int


def _tiled(univ, K):
    """Whether the narrow tier of the sampler, the density and the apply is
    tiled: the closed-form univariates and the circular spline, and the
    polynomials of at most :data:`_POLY_REGS` coefficients, Bernstein ``M +
    5`` and sum of squares ``P (L + 1)`` with ``L + 1 <= _SOSP_NODES``
    (``tiled`` in ``csrc/nsf_fused.cu``)."""
    if univ == "bernstein":
        return K + 5 <= _POLY_REGS
    if univ == "sosp":
        return K[0] * K[1] <= _POLY_REGS and K[1] <= _SOSP_NODES
    return True


def _tile_rows(floats, two_a_sm, smem_limit):
    """The largest of :data:`_SAMPLE_TILES` rows ``R`` whose ``floats(R)``
    of shared memory fit ``smem_limit``, ``None`` where none does; with
    ``two_a_sm``, first the largest of 64 and 32 rows of which two blocks
    share an SM's 233,472 bytes (1 KB a block reserved), where one does."""
    if two_a_sm:
        two = next((R for R in _SAMPLE_TILES[1:]
                    if 4 * floats(R) <= min(smem_limit, _TWO_A_SM)), None)
        if two is not None:
            return two
    return next((R for R in _SAMPLE_TILES if 4 * floats(R) <= smem_limit), None)


def _sample_tile_floats(widths, T, R):
    """Floats of shared memory of the tiled sampler's tile of ``R``
    rows (``tile_plan`` in ``csrc/nsf_fused.cu``): one layer's linears as
    ``W^T [in][pad8(out)]`` and a bias of ``pad8(out)``, the iterate and
    context ``[F + C][R]``, the targets ``[F][R]``, two hidden buffers of
    ``pad8(widest hidden)`` rows and the last linear's outputs
    ``[pad8(F T)][R]``."""
    F = widths[-1] // T
    weights = sum(i * _pad8(o) + _pad8(o) for i, o in zip(widths[:-1], widths[1:]))
    hidden = _pad8(max(widths[1:-1], default=0))
    return weights + (widths[0] + F + 2 * hidden + _pad8(F * T)) * R


def _density_tile_floats(widths, T, R):
    """Floats of shared memory of the tiled density's tile of ``R`` rows
    (``tile_plan`` without targets in ``csrc/nsf_fused.cu``): the sampler's
    (:func:`_sample_tile_floats`) but its targets ``[F][R]``."""
    return _sample_tile_floats(widths, T, R) - widths[-1] // T * R


def density_tile_rows(widths, K, univ, smem_limit=_SMEM_OPTIN):
    """Rows of the tiled density's tile (:func:`_tile_rows`): the largest of
    :data:`_SAMPLE_TILES` whose shared memory fits ``smem_limit``, ``None``
    where none does; a polynomial's, whose coefficients in registers want
    the warps of two blocks an SM as its sampler's do, two blocks an SM
    where they fit."""
    T = _univ_size(univ, K)
    return _tile_rows(lambda R: _density_tile_floats(widths, T, R),
                      univ in ("sosp", "bernstein"), smem_limit)


def sample_tile_rows(widths, K, univ, smem_limit=_SMEM_OPTIN):
    """Rows of the tiled sampler's tile (:func:`_tile_rows`): the largest of
    :data:`_SAMPLE_TILES` whose shared memory fits ``smem_limit``, ``None``
    where none does; a polynomial's, whose solve wants the warps of two
    blocks an SM, two blocks an SM where they fit."""
    T = _univ_size(univ, K)
    return _tile_rows(lambda R: _sample_tile_floats(widths, T, R),
                      univ in ("sosp", "bernstein"), smem_limit)


def plan_nsf(widths, K, univ, n_ar, rows, smem_limit=_SMEM_OPTIN, sample=False):
    """The tier of the NSF kernels for a flow of this shape (what the
    wrappers launch, from the shapes alone): the narrow tier within its
    limits, one layer's weights in ``smem_limit`` bytes of shared memory;
    else the wide tier with a workspace of ``F + C + F + 2 max(widths) + T +
    3 k`` floats a row, ``k`` of :func:`_knot_slots` (the fields of ``Row``
    in ``csrc/nsf_fused.cu``), and a descriptor buffer of the widths, the
    passes, the softclip bounds and the Gauss-Legendre nodes and weights.

    The univariates of :func:`_tiled` plan the tiled tier instead of the
    one-layer limit: within the same limits, a :class:`TilePlan` of
    :func:`sample_tile_rows` rows (with ``sample``) or
    :func:`density_tile_rows` rows (without) and its shared memory, else the
    wide tier; a polynomial of more coefficients plans the per-thread narrow
    tier."""
    n_lin = len(widths) - 1
    F = widths[-1] // _univ_size(univ, K)
    w_max = max(widths[:-1])
    layer_floats = sum(o * (i + 1) for i, o in zip(widths[:-1], widths[1:]))
    within = (n_lin <= _MAX_LINEAR and n_ar <= _MAX_LAYERS and w_max <= _MAX_WIDTH
              and F <= _MAX_WIDTH and _fits_arrays(univ, K))
    T = _univ_size(univ, K)
    if _tiled(univ, K):
        tile_rows, floats = ((sample_tile_rows, _sample_tile_floats) if sample
                             else (density_tile_rows, _density_tile_floats))
        R = tile_rows(widths, K, univ, smem_limit) if within else None
        if R is not None:
            return TilePlan(*narrow_plan(rows), R, 4 * floats(widths, T, R))
    elif within and 4 * layer_floats <= smem_limit:
        return narrow_plan(rows)
    slots = widths[0] + F + 2 * w_max + T + 3 * _knot_slots(univ, K)
    nodes = K[1] if univ == "sosp" else 0
    return wide_plan(slots, rows, 4 * (n_lin + 1 + 2 * n_ar + 2 * nodes))


def _widths(layers, F, C, K, univ):
    """Check the shapes of the AR ``layers`` (:func:`_split_layers`):
    ``(widths, passes)`` of the hyper-net and the layers."""
    first = layers[0][0]
    widths = [first[0].shape[1]] + [first[3 * i].shape[0] for i in range(len(first) // 3)]
    T = _univ_size(univ, K)
    if widths[0] != F + C or widths[-1] != F * T:
        raise ValueError(f"hyper-net widths {widths} do not match F={F}, C={C}, T={T}")
    return widths, [p for _, p in layers]


def _pack_weights(params, layout, F, C, K, univ):
    """Check the shapes and pack, per AR layer, ``[M⊙W_0, b_0, M⊙W_1, b_1,
    ...]`` into one contiguous buffer (the mask is multiplied in once per
    call, as ``_presplit_params``' "mask" mode does). Returns ``(packed,
    widths, passes)``."""
    layers = _split_layers(params, layout)
    widths, passes = _widths(layers, F, C, K, univ)
    chunks = []
    for ps, _ in layers:
        for i in range(len(ps) // 3):
            W, b, M = ps[3 * i : 3 * i + 3]
            chunks += [(M * W).reshape(-1), b]
    packed = torch.cat(chunks).detach().contiguous()
    return packed, widths, passes


def _tiled_weights(params, layout):
    """Per AR layer, each linear of the hyper-net as ``(M ⊙ W)^T`` of shape
    ``(in, pad8(out))`` then its bias padded to ``pad8(out)``, zero-filled,
    in one contiguous buffer: what the tiled tier stages (a thread's eight
    outputs in two 16-byte loads)."""
    chunks = []
    for ps, _ in _split_layers(params, layout):
        for i in range(len(ps) // 3):
            W, b, M = ps[3 * i : 3 * i + 3]
            pad = _pad8(W.shape[0]) - W.shape[0]
            chunks += [torch.nn.functional.pad((M * W).T, (0, pad)).reshape(-1),
                       torch.nn.functional.pad(b, (0, pad))]
    return torch.cat(chunks).detach().contiguous()


def _softclip_bounds(layout):
    """Per AR layer, the bound of the softclip right after it (0 for none),
    as the kernels take the interleaves."""
    clips = []
    for entry in layout:
        if entry[0] != "softclip":
            clips.append(0.0)
        elif not clips or clips[-1]:
            raise ValueError("the kernels take a softclip only right after an AR layer")
        else:
            clips[-1] = entry[1]
    return clips


def _counter(name, univ):
    """The launch count of kernel mode ``name`` for univariate ``univ``: the
    three new modes carry their name, ``nsf_sample_<univ>_log_prob`` and
    ``nsf_sample_<univ>_raw`` after the sampler's own."""
    if univ in ("affine", "rqs"):
        return name
    if name.startswith("nsf_sample_"):
        return f"nsf_sample_{univ}_{name[len('nsf_sample_'):]}"
    return f"{name}_{univ}"


def _launch(fn, counter, xc, outs, params, layout, F, K, bound, slope, univ, base):
    """Common launch path of the kernels: check, plan the tier (with the
    card's shared memory), stage the weights the tier reads (the tiled
    tier's :func:`_tiled_weights`, the others' :func:`_pack_weights`), call
    the C entry point with the input, the output pointers ``outs``, the
    weights, the softclip bounds, the base and (for the sum-of-squares
    polynomial) the Gauss-Legendre nodes and weights on the current stream,
    raise on a CUDA error, count (the wide tier under ``<counter>_wide``)."""
    from ._build import check_launch, load_library

    if xc.dim() != 2 or not xc.is_contiguous():
        raise ValueError(f"{counter}: expected a contiguous (n, F + C) tensor")
    check_cuda_f32(counter, [xc, *params])
    C = xc.shape[1] - F
    widths, passes = _widths(_split_layers(params, layout), F, C, K, univ)
    clips = _softclip_bounds(layout)
    lib = load_library("nsf_fused")
    plan = plan_nsf(widths, K, univ, len(passes), xc.shape[0],
                    lib.nsf_max_shared_bytes(xc.device.index),
                    sample=fn.startswith("nsf_sample"))
    work, desc = workspace(plan, xc.device)
    # the tiled tier reads its staged weights alone, the others the packed
    tile = getattr(plan, "tile_rows", 0)
    tiled = _tiled_weights(params, layout) if tile else None
    packed = None if tile else _pack_weights(params, layout, F, C, K, univ)[0]
    K1, K2 = K if univ == "sosp" else (K, 0)
    nodes = np.concatenate(np.polynomial.legendre.leggauss(K2)) if K2 else []
    box = base[0] == "box"
    lo, hi = base[1:] if box else (0.0, 0.0)
    c_widths = (ctypes.c_int * len(widths))(*widths)
    c_passes = (ctypes.c_int * len(passes))(*passes)
    c_clips = (ctypes.c_float * len(clips))(*clips)
    c_nodes = (ctypes.c_float * max(1, len(nodes)))(*nodes)
    with torch.cuda.device(xc.device):
        rc = getattr(lib, fn)(
            xc.data_ptr(), *outs, None if packed is None else packed.data_ptr(),
            ctypes.addressof(c_widths), ctypes.addressof(c_passes), ctypes.addressof(c_clips),
            len(widths) - 1, len(passes), F, C, K1, K2, _UNIV_CODE[univ],
            bound, math.log(slope), slope, ctypes.addressof(c_nodes),
            int(box), lo, hi, math.log(hi - lo) if box else 0.0,
            xc.shape[0], int(plan.wide),
            None if work is None else work.data_ptr(), 0 if work is None else work.numel(),
            plan.chunk_rows, None if desc is None else desc.data_ptr(), plan.desc_bytes,
            torch.cuda.current_stream().cuda_stream,
            None if tiled is None else tiled.data_ptr(), tile,
        )
    counter = _counter(counter, univ)
    check_launch(counter, lib, "nsf_fused", rc)
    LAUNCHES[counter + ("_wide" if plan.wide else "")] += 1


def _density_kernel(xc, params, layout, F, K, bound, slope, univ, base=_NORMAL):
    out = torch.empty(xc.shape[0], device=xc.device, dtype=torch.float32)
    _launch("nsf_density_f32", "nsf_density", xc, [out.data_ptr()],
            params, layout, F, K, bound, slope, univ, base)
    return out


def _apply_kernel(xc, params, layout, F, K, bound, slope, univ, base=_NORMAL):
    y = torch.empty(xc.shape[0], F, device=xc.device, dtype=torch.float32)
    ladj = torch.empty(xc.shape[0], device=xc.device, dtype=torch.float32)
    _launch("nsf_apply_f32", "nsf_apply", xc, [y.data_ptr(), ladj.data_ptr()],
            params, layout, F, K, bound, slope, univ, base)
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


def nsf_density(xc, params, layout, F, K, bound, slope, univ, base=_NORMAL):
    r"""Whole-flow log-density ``xc (n, F + C) -> (n,)``: the ``nsf_density``
    kernel for a CUDA tensor (differentiable through its
    ``autograd.Function``), the plain version for a CPU tensor."""
    if not xc.is_cuda:
        return _full_math(xc, params, layout, F, K, bound, slope, univ, base)
    return _DensityFunction.apply(
        xc.contiguous(), (layout, F, K, bound, slope, univ, base), *params
    )


def nsf_apply(xc, params, layout, F, K, bound, slope, univ, base=_NORMAL):
    r"""Whole-flow forward map ``xc (n, F + C) -> (T(x) (n, F), sum_ladj
    (n,))``, no base term: the ``nsf_apply`` kernel for a CUDA tensor
    (differentiable through its ``autograd.Function``), the plain version
    for a CPU tensor."""
    if not xc.is_cuda:
        return _full_math(xc, params, layout, F, K, bound, slope, univ, base, raw=True)
    return _ApplyFunction.apply(
        xc.contiguous(), (layout, F, K, bound, slope, univ, base), *params
    )


# C entry point and launch counter of each sampling mode (``want_log_prob``)
_SAMPLE_MODES = {
    False: ("nsf_sample_f32", "nsf_sample"),
    True: ("nsf_sample_f32", "nsf_sample_log_prob"),
    "raw": ("nsf_sample_raw_f32", "nsf_sample_raw"),
}


def nsf_sample(zc, params, layout, F, K, bound, slope, univ, base=_NORMAL,
               want_log_prob=False):
    r"""Whole-flow inversion ``zc (n, F + C) -> x (n, F)``, and with
    ``want_log_prob`` also ``log q (n,)`` or (``"raw"``) the bare sum of the
    forward log-Jacobians at ``x``: the ``nsf_sample`` kernel for a CUDA
    tensor, the plain version for a CPU tensor. Not differentiable; the
    differentiable form is :mod:`zuko_tpu_torch.ops.ift`."""
    if not zc.is_cuda:
        with torch.no_grad():
            return _sample_math(zc, params, layout, F, K, bound, slope, univ, base,
                                want_log_prob)
    fn, counter = _SAMPLE_MODES[want_log_prob]
    zc = zc.contiguous()
    x = torch.empty(zc.shape[0], F, device=zc.device, dtype=torch.float32)
    lq = torch.empty(zc.shape[0], device=zc.device, dtype=torch.float32) \
        if want_log_prob else None
    _launch(
        fn, counter, zc, [x.data_ptr(), None if lq is None else lq.data_ptr()],
        params, layout, F, K, bound, slope, univ, base,
    )
    return (x, lq) if want_log_prob else x


# ------------------------------------------------------------ flow level


def _statics(cfg, F):
    """The wrappers' arguments after ``layout``: ``(F, K, bound, slope, univ,
    base)``."""
    return F, cfg["bins"], cfg["bound"], cfg["slope"], cfg["univ"], cfg["base"]


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
    shape, zc = _base_draws(flat, sample_shape, c, generator, flat[2]["base"])
    params, layout, cfg = flat
    out = nsf_sample(zc, params, layout, *_statics(cfg, shape[-1]), want_log_prob=want_log_prob)
    if want_log_prob:
        x, lq = out
        return x.reshape(shape), lq.reshape(shape[:-1])
    return out.reshape(shape)


def _base_draws(flat, sample_shape, c, generator, base=_NORMAL):
    """The sampling preamble (counterpart of ``_prep_sample`` :1503):
    ``(shape, zc)`` with ``shape = sample_shape + batch + (F,)`` and ``zc
    (n, F + C)`` the base draws beside the broadcast context: standard
    normal, or ``lo + (hi - lo) U`` for a box (``_prep_sample`` :1527)."""
    W0 = flat[0][0]
    C = 0 if c is None else c.shape[-1]
    F = W0.shape[1] - C
    cbatch = () if c is None else tuple(c.shape[:-1])
    shape = tuple(sample_shape) + cbatch + (F,)
    if base[0] == "box":
        u = torch.rand(shape, generator=generator, device=W0.device, dtype=W0.dtype)
        z = base[1] + (base[2] - base[1]) * u
    else:
        z = torch.randn(shape, generator=generator, device=W0.device, dtype=W0.dtype)
    zc = z.reshape(-1, F)
    if c is not None:
        cf = c.to(z.dtype).expand(tuple(sample_shape) + cbatch + (C,))
        zc = torch.cat([zc, cf.reshape(-1, C)], dim=-1)
    return shape, zc
