r"""Whole-flow neural autoregressive flow (NAF and UNAF) density and sampling:
plain PyTorch versions and the CUDA kernels that replace the TPU kernels.

Counterpart of ``zuko_tpu/ops/naf_fused.py``, for the monotone-network (MNN,
NAF) and the unconstrained monotone-network (UMNN, UNAF) univariates. Two
kernels, both in ``csrc/naf_fused.cu``, each with a mode per univariate:

* ``naf_density`` replaces ``_naf_density_impl`` (:904, ``pallas_call`` at
  :949): the whole-flow ``log_prob``. Per autoregressive layer, the MADE pass
  gives every feature its signal (and a UMNN its additive constant); the
  univariate network's first layer is split into its signal part (computed
  once, "hoisted") and its ``x`` column. A monotone network gives the
  feature's output and its slope ``g`` in one evaluation with its
  derivative; a UMNN integrates its integrand ``g`` from 0 to ``x`` with 16
  Gauss-Legendre nodes and evaluates ``g(x)`` once more. ``log g`` is the
  log-Jacobian. Softclips between the layers and the standard-normal base
  term close the sum.
* ``naf_sample`` replaces ``_naf_sample_core`` (:1054, ``pallas_call`` at
  :1128): the whole inversion, stages in reverse. A softclip inverts in
  closed form; an autoregressive layer by ``min(passes, F)`` sweeps, each a
  MADE pass on the current iterate and, per feature, a bracketed bisection
  followed by Newton steps on the univariate (a UMNN's target less its
  constant). The first sweep bisects ``[-10, 10]`` 10 times; the later ones
  start from the previous sweep's root (a bracket of radius 0.0625 checked
  by two evaluations, the full bracket for the rows where it does not hold
  the root) and bisect 3 times. Newton steps follow, each clamped to
  ``[-10, 10]``: three for a monotone network; for a UMNN four in the first
  sweep and three later, the integral by 4 nodes in the bisection, 8 in the
  Newton steps but the last and 16 in the last. With ``want_log_prob`` it
  also returns ``log q`` at the returned point.

Each wrapper takes the plain version for a tensor that lies on the CPU, and
launches its kernel (or raises) for a CUDA tensor. :func:`plan_naf` chooses
the kernels' tier from the flow's shape: the narrow tier within its limits,
the wide tier (a workspace in device memory) beyond them. The narrow tier of
both kernels, in both modes, is tiled (a block a tile of rows, the network
evaluations of a step batched into products from shared memory), and its
shared memory must also fit; :func:`umnn_tile_rows` and
:func:`mnn_tile_rows` set the sampler's tile, :func:`density_tile_rows` the
density's. ``LAUNCHES`` counts
the launches under ``naf_density``, ``naf_sample`` and
``naf_sample_log_prob``, with ``_umnn`` after ``naf_density`` or
``naf_sample`` for a UNAF and ``_wide`` at the end for the wide tier.

A flow is handed to them flat: per autoregressive stage the MADE's masked
weights ``M ⊙ W`` and biases, then the univariate network's weights of shape
``(F, out, in)`` (the monotone network's positive ``|W|``, the integrand's
``W``) and biases ``(F, out)``; ``layout`` names the stages. The products
are taken once per ``flow(c)``, outside the kernels, and stay in the
autograd graph of the flow's parameters. The TPU kernels' workarounds are
not carried over: no tile arithmetic, no bf16 product splits, no
compensated logs, no chunks of quadrature nodes, and no route by width to
another path.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
import torch.nn.functional as Fn

from ._common import (
    LAUNCHES,
    SHARED_BYTES,
    RowChunkedBackward,
    check_cuda_f32,
    narrow_plan,
    sm_count,
    wide_plan,
    workspace,
)
from .nsf_fused import (
    FusedStructureError,
    _base_draws,
    _extract_mlp_linears,
    _require_standard_base,
    _softclip,
    _softclip_entry,
    _with_context,
)

__all__ = [
    "density_tile_rows",
    "extract_naf_params",
    "fused_naf_log_prob",
    "fused_naf_sample",
    "mnn_tile_rows",
    "naf_density",
    "naf_sample",
    "plan_naf",
    "umnn_tile_rows",
]

# The narrow tier's limits (mirrored in csrc/naf_fused.cu): features, signal
# size, univariate-network and MADE widths (the MADE's F + C inputs
# included, its F * T outputs excluded: they are computed a feature at a
# time), linears per network, and autoregressive layers and softclips
# together. Beyond any of them the wide tier takes the flow.
_MAX_FEATURES = 64
_MAX_SIGNAL = 64
_MAX_MONO_WIDTH = 128
_MAX_MADE_WIDTH = 256
_MAX_LINEAR = 8
_MAX_STAGES = 64
_MODE_CODE = {"mnn": 0, "umnn": 1}

# The solve of ``MonotonicTransform`` (bound 10) as the TPU sampler runs it:
# a coarse bisection to 2e-2 (10 halvings of [-10, 10]), then Newton steps,
# whose derivative is floored; later sweeps bracket the previous root.
_BOUND = 10.0
_N_COARSE = math.ceil(math.log2(2 * _BOUND / 2e-2))
_WARM_R = 0.0625
_N_WARM = math.ceil(math.log2(2 * _WARM_R / 2e-2))
_N_NEWTON = 3
_DF_FLOOR = 1e-12
# The UMNN's rules (``_UMNN_COARSE_N`` :393, ``_UMNN_NEWTON_N`` :404,
# ``_UMNN_FINE_N`` :406): its integral by GL-4 in the bisection, GL-8 in the
# Newton steps but the last, GL-16 in the last one and in the density; one
# Newton step more in the first sweep (``_N_NEWTON_UMNN`` :85).
_UMNN_COARSE_N, _UMNN_NEWTON_N, _UMNN_FINE_N = 4, 8, 16
_N_NEWTON_UMNN = 4
_GAUSS_LEGENDRE = {
    n: np.polynomial.legendre.leggauss(n) for n in (_UMNN_COARSE_N, _UMNN_NEWTON_N, _UMNN_FINE_N)
}


# ------------------------------------------------------------- extraction


def _extract_stacked_net(net, linear_cls, activation_ok, features, signal, label):
    """Require ``[linear_cls, activation]* linear_cls``, biased, stacked over
    ``features``, mapping ``1 + signal`` inputs to one output with at least
    one hidden layer (its first layer is hoisted per sweep); return its
    linears."""
    lins, expect_linear = [], True
    for layer in net.layers:
        if expect_linear:
            if type(layer) is not linear_cls:
                raise FusedStructureError(
                    f"fused NAF kernels expect {linear_cls.__name__} stacks in the {label},"
                    f" got {type(layer).__name__}"
                )
            if layer.bias is None or layer.weight.dim() != 3:
                raise FusedStructureError(f"the {label} must be biased and stacked per feature")
            lins.append(layer)
        elif not activation_ok(layer):
            raise FusedStructureError(f"fused NAF kernels do not take {layer} in the {label}")
        expect_linear = not expect_linear
    if expect_linear or len(lins) < 2:
        raise FusedStructureError(
            f"the {label} must end with a linear and have a hidden layer"
            " (its first layer is hoisted per sweep)"
        )
    if any(tuple(l.weight.shape[::2]) != (features, l.in_features) for l in lins):
        raise FusedStructureError(f"the {label} must be stacked over the features")
    if lins[0].in_features != 1 + signal or lins[-1].out_features != 1:
        raise FusedStructureError(f"the {label} must map {1 + signal} inputs to 1")
    return lins


def _univariate_net(univariate, features, signal):
    """``(kind, linears)`` of an autoregressive layer's univariate: an
    :class:`~zuko_tpu_torch.flows.neural.MNN`'s monotone network
    (``MonotonicLinear`` with ``TwoWayELU(alpha=1)``, even hidden widths) or
    a :class:`~zuko_tpu_torch.flows.neural.UMNN`'s integrand (``Linear``
    with ELU)."""
    from ..flows.neural import MNN, UMNN
    from ..nn import Activation, Linear, MonotonicLinear, TwoWayELU

    if isinstance(univariate, MNN):
        lins = _extract_stacked_net(
            univariate.network, MonotonicLinear,
            lambda l: type(l) is TwoWayELU and l.alpha == 1.0, features, signal,
            "monotone net")
        if any(l.out_features % 2 for l in lins[:-1]):
            raise FusedStructureError("TwoWayELU needs even hidden widths")
        return "mnn", lins
    if isinstance(univariate, UMNN):
        return "umnn", _extract_stacked_net(
            univariate.integrand, Linear,
            lambda l: isinstance(l, Activation) and l.fn is Fn.elu, features, signal,
            "UMNN integrand")
    raise FusedStructureError(
        f"fused NAF kernels take MNN and UMNN univariates, got {type(univariate).__name__}"
    )


def extract_naf_params(flow):
    """Validate a NAF or UNAF structure and pull its parameters out
    (counterpart of ``extract_naf_params`` :131): masked autoregressive
    layers with an :class:`~zuko_tpu_torch.flows.neural.MNN` univariate
    (shapes ``((S,),)``) or a :class:`~zuko_tpu_torch.flows.neural.UMNN`
    univariate (shapes ``((S,), ())``: a signal and a constant per feature),
    one kind for every layer, unconditional ``SoftclipTransform``
    interleaves, plain ReLU MADE hyper-networks and a standard ``DiagNormal``
    base. Returns ``(stages, {"signal": S, "features": F})`` with stages
    ``("softclip", bound)`` or ``("ar", {kind, made_w, made_b, made_m,
    mono_w, mono_b, passes})``, ``mono_*`` the univariate network's linears
    (the integrand's for ``kind == "umnn"``). Anything else raises
    :class:`FusedStructureError`."""
    from ..flows.autoregressive import MaskedAutoregressiveTransform
    from ..lazy import LazyComposedTransform, UnconditionalTransform

    if not isinstance(getattr(flow, "transform", None), LazyComposedTransform):
        raise FusedStructureError(
            "fused NAF kernels require a LazyComposedTransform flow, got"
            f" {type(getattr(flow, 'transform', None)).__name__}"
        )
    stages, S, F, kind = [], None, None, None
    for t in flow.transform.transforms:
        if isinstance(t, UnconditionalTransform):
            stages.append(_softclip_entry(t))
            continue
        if type(t) is not MaskedAutoregressiveTransform:
            raise FusedStructureError(
                "fused NAF kernels support MaskedAutoregressiveTransform layers only,"
                f" got {type(t).__name__}"
            )
        if not t.shapes or len(t.shapes[0]) != 1:
            raise FusedStructureError(f"unexpected NAF shapes {t.shapes}")
        if S is not None and t.shapes[0][0] != S:
            raise FusedStructureError("layers must share the signal size")
        S = t.shapes[0][0]
        made = _extract_mlp_linears(t.hyper)
        F = made[-1].weight.shape[0] // t.total if F is None else F
        k, net = _univariate_net(t.univariate, F, S)
        if t.shapes != (((S,),) if k == "mnn" else ((S,), ())):
            raise FusedStructureError(f"unexpected {k.upper()} shapes {t.shapes}")
        if kind is not None and k != kind:
            raise FusedStructureError("layers must share the univariate kind")
        kind = k
        stages.append(("ar", {
            "kind": kind,
            "made_w": [l.weight for l in made],
            "made_b": [l.bias for l in made],
            "made_m": [l.mask for l in made],
            "mono_w": [l.weight for l in net],
            "mono_b": [l.bias for l in net],
            "passes": int(t.passes),
        }))
    if F is None:
        raise FusedStructureError("flow has no autoregressive layers")
    _require_standard_base(flow, F)
    return stages, {"signal": S, "features": F}


def _flatten_naf(flow):
    """``(params, layout, F, S)`` (counterpart of ``_stage_layout`` :745):
    per autoregressive stage the flat list holds ``[M⊙W, b]`` per MADE
    linear, then the univariate network's weights (``|W|`` for a monotone
    net, ``W`` for a UMNN integrand), then their biases; ``layout`` has one
    ``("softclip", bound)`` or ``("ar", n_made, n_net, passes, kind)`` entry
    per stage. The products are taken here, once per ``flow(c)``, so the
    gradients to ``W`` are autograd's own."""
    stages, cfg = extract_naf_params(flow)
    params, layout = [], []
    for kind, st in stages:
        if kind == "softclip":
            layout.append((kind, st))
            continue
        for W, b, M in zip(st["made_w"], st["made_b"], st["made_m"]):
            params += [M * W, b]
        net_w = [W.abs() for W in st["mono_w"]] if st["kind"] == "mnn" else st["mono_w"]
        params += list(net_w) + list(st["mono_b"])
        layout.append(("ar", len(st["made_w"]), len(st["mono_w"]), st["passes"], st["kind"]))
    return params, tuple(layout), cfg["features"], cfg["signal"]


def _stages(params, layout):
    """``(entry, made, mono_w, mono_b)`` per stage from the flat list
    (the three lists empty for a softclip)."""
    idx = 0
    for entry in layout:
        if entry[0] == "softclip":
            yield entry, [], [], []
            continue
        _, n_made, n_mono, _, _ = entry
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


def _hoist(sig, mono_w, mono_b):
    """The first network layer's signal part (counterpart of
    ``_hoist_first_layer`` :305): ``pre1 (n, F, H1) = W1[:, :, 1:] · s +
    b1`` from the signals ``sig (n, F, S)``, constant through a sweep's
    solve, and the ``x`` column ``w1x (F, H1)``."""
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


def _integrand(x, pre1, w1x, net_w, net_b):
    """Every feature's UMNN integrand at ``x (n, F)`` from the hoisted first
    layer: ``g = exp(d / (1 + |d / 7|))``, ``d`` the ELU network's output
    (the integrand of ``_umnn_eval_hoisted`` :410)."""
    u = Fn.elu(pre1 + w1x * x[..., None])
    for W, b in zip(net_w[1:-1], net_b[1:-1]):
        u = Fn.elu(torch.einsum("fij,nfj->nfi", W, u) + b)
    d = torch.einsum("fj,nfj->nf", net_w[-1][:, 0], u) + net_b[-1][:, 0]
    return torch.exp(d / (1 + torch.abs(d / 7)))


def _umnn(x, pre1, w1x, net_w, net_b, n, grad=False):
    """Every feature's integral :math:`\\int_0^x g` at ``x (n, F)`` by the
    ``n``-point Gauss-Legendre rule, one node at a time (counterpart of
    ``_umnn_eval_hoisted`` :410), and with ``grad`` also its derivative
    ``g(x)``, one more integrand evaluation (``_umnn_vg_hoisted`` :456)."""
    nodes, weights = _GAUSS_LEGENDRE[n]
    acc = 0.0
    for t, w in zip(nodes.tolist(), weights.tolist()):
        acc = acc + w * _integrand(x * (0.5 * (t + 1.0)), pre1, w1x, net_w, net_b)
    value = 0.5 * x * acc
    return (value, _integrand(x, pre1, w1x, net_w, net_b)) if grad else value


def _univariates(h, kind, mono_w, mono_b, F, S):
    """A layer's per-sweep constants from its hyper outputs ``h (n, F *
    T)`` (``T = S``, or ``S + 1`` with the UMNN's constant last):
    ``(shift (n, F), pre1, w1x)``, the shift zero for a monotone net."""
    hh = h.reshape(h.shape[0], F, -1)
    pre1, w1x = _hoist(hh[..., :S], mono_w, mono_b)
    return (hh[..., S] if kind == "umnn" else 0.0), pre1, w1x


def _ar_layer(x, h, kind, mono_w, mono_b, F, S):
    """An autoregressive layer's univariates at fixed hyper outputs ``h``:
    ``(y (n, F), ladj (n, F))`` with ``ladj = log f'``. Feature ``f`` of
    ``y`` reads ``x[:, f]`` and its outputs in ``h`` only. A UMNN's value is
    its GL-16 integral plus its constant, its slope ``g(x)``."""
    shift, pre1, w1x = _univariates(h, kind, mono_w, mono_b, F, S)
    if kind == "umnn":
        y, g = _umnn(x, pre1, w1x, mono_w, mono_b, _UMNN_FINE_N, grad=True)
    else:
        y, g = _mono(x, pre1, w1x, mono_w, mono_b, grad=True)
    return y + shift, torch.log(g)


def _naf_density_math(xc, params, layout, F, S):
    """Plain version of the density kernel (counterpart of
    ``_naf_density_math_T`` :657): ``xc (n, F + C) -> log_prob (n,)``."""
    x, c = xc[:, :F], xc[:, F:]
    acc = 0.0
    for entry, made, mono_w, mono_b in _stages(params, layout):
        if entry[0] == "softclip":
            x, ladj = _softclip(x, entry[1])
        else:
            h = _made(torch.cat([x, c], dim=1), made)
            x, ladj = _ar_layer(x, h, entry[4], mono_w, mono_b, F, S)
        acc = acc + ladj.sum(dim=1)
    return acc - 0.5 * (x**2).sum(dim=1) - 0.5 * F * math.log(2 * math.pi)


def _ar_inverse(y, c, made, mono_w, mono_b, passes, kind, F, S):
    """Invert one autoregressive layer (counterpart of
    ``_ar_inverse_sweeps_T`` :492, its warm-started default): ``min(passes,
    F)`` Jacobi sweeps, each a MADE pass on the current iterate, then per
    feature a bisection and Newton steps on the univariate. A UMNN solves
    for ``y`` less its constant; it bisects with the GL-4 rule, takes its
    Newton steps with GL-8 and the last one with GL-16, and takes one more
    step in the first sweep than in the later ones."""
    if kind == "umnn":
        def f(t):
            return _umnn(t, pre1, w1x, mono_w, mono_b, _UMNN_COARSE_N)

        def vg(t, last):
            n = _UMNN_FINE_N if last else _UMNN_NEWTON_N
            return _umnn(t, pre1, w1x, mono_w, mono_b, n, grad=True)

        n_newton = (_N_NEWTON_UMNN, _N_NEWTON_UMNN - 1)
    else:
        def f(t):
            return _mono(t, pre1, w1x, mono_w, mono_b)

        def vg(t, last):
            return _mono(t, pre1, w1x, mono_w, mono_b, grad=True)

        n_newton = (_N_NEWTON, _N_NEWTON)
    x = torch.zeros_like(y)
    for sweep in range(min(passes, F)):
        h = _made(torch.cat([x, c], dim=1), made)
        shift, pre1, w1x = _univariates(h, kind, mono_w, mono_b, F, S)
        target = y - shift
        full_lo, full_hi = torch.full_like(y, -_BOUND), torch.full_like(y, _BOUND)
        if sweep == 0:
            lo, hi, n_bisect = full_lo, full_hi, _N_COARSE
        else:
            # the previous root brackets this sweep's where f says it does;
            # the other rows start again from the full bracket
            lo, hi = x - _WARM_R, x + _WARM_R
            ok = (f(lo) < target) & (target < f(hi))
            lo, hi, n_bisect = torch.where(ok, lo, full_lo), torch.where(ok, hi, full_hi), _N_WARM
        for _ in range(n_bisect):
            mid = 0.5 * (lo + hi)
            right = f(mid) < target
            lo, hi = torch.where(right, mid, lo), torch.where(right, hi, mid)
        x = 0.5 * (lo + hi)
        steps = n_newton[sweep > 0]
        for i in range(steps):
            value, g = vg(x, i == steps - 1)
            x = (x - (value - target) / g.clamp(min=_DF_FLOOR)).clamp(-_BOUND, _BOUND)
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
            _, _, _, passes, kind = entry
            x = _ar_inverse(y, c, made, mono_w, mono_b, passes, kind, F, S)
            if want_log_prob:
                h = _made(torch.cat([x, c], dim=1), made)
                acc = acc + _ar_layer(x, h, kind, mono_w, mono_b, F, S)[1].sum(dim=1)
        y = x
    return (y, acc) if want_log_prob else y


# ---------------------------------------------------------- CUDA launches


def _widths(params, layout, F, C, S):
    """``(kind, MADE widths, network widths)`` of the autoregressive layers,
    which must share one shape and one univariate kind; ``ValueError``
    otherwise."""
    layers = [
        (entry[4], [made[0].shape[1]] + [W.shape[0] for W in made[0::2]],
         [mono_w[0].shape[2]] + [W.shape[1] for W in mono_w])
        for entry, made, mono_w, _ in _stages(params, layout) if entry[0] == "ar"
    ]
    if not layers or any(layer != layers[0] for layer in layers):
        raise ValueError("the kernels take autoregressive layers of one shape and kind")
    kind, made_w, mono_w = layers[0]
    T = S + (kind == "umnn")
    if made_w[0] != F + C or made_w[-1] != F * T or mono_w[0] != 1 + S or mono_w[-1] != 1:
        raise ValueError(
            f"MADE widths {made_w} and network widths {mono_w} do not match F = {F},"
            f" C = {C}, S = {S}")
    return kind, made_w, mono_w


def _tile_floats(kind, made_w, mono_w, F, C, S, R):
    """Floats of shared memory of the tiled kernels at tiles of ``R`` rows
    (``tile_plan`` in ``csrc/naf_fused.cu``, each array from a 16-byte
    boundary): the iterate and context, two MADE buffers (the first holds
    the sampler's copy of the iterate where the MADE has no hidden layer),
    the targets (the density's outputs), a feature's T outputs and hoisted
    first layer, the evaluation points, the node activations, the feature's
    middle layers (outputs rounded up to 8) with their biases, and the x
    column, the last layer and its bias. A UMNN (``kind``) keeps the 17
    integrand values of a row, 256 node rows a chunk (fewer for middle
    layers wider than 64) at a row stride of 4 more, and the Gauss-Legendre
    rules; a monotone network the values at two points
    and a derivative a row, 128 value rows a chunk (fewer past 64) in twice
    as many slots (their tangent rows) and 4 more."""
    mids = [(mono_w[i], -(-mono_w[i + 1] // 8) * 8) for i in range(1, len(mono_w) - 2)]
    hp = max([8] + [dp for _, dp in mids])
    if kind == "umnn":
        M = min(256, 16384 // hp // 32 * 32)
        stride, values, rules = M + 4, 17, 56
    else:
        M = min(128, 8192 // hp // 16 * 16)
        stride, values, rules = 2 * M + 4, 3, 0
    mh = max(made_w[1:-1], default=0)
    T = S + (kind == "umnn")
    sizes = [(F + C) * R, (mh or F + C) * R, mh * R, F * R, T * R, mono_w[1] * R, 2 * R,
             values * R, max(mono_w[1:-1]) * stride, sum(din * dp + dp for din, dp in mids),
             mono_w[1] + mono_w[-2] + 4 + rules]
    return sum(-(-v // 4) * 4 for v in sizes)


def _umnn_tile_floats(made_w, mono_w, F, C, S, R):
    """:func:`_tile_floats` of a UNAF's tiled sampler."""
    return _tile_floats("umnn", made_w, mono_w, F, C, S, R)


def umnn_tile_rows(rows, sms):
    """Rows of a tile of the tiled UMNN sampler: 64, or 32 or 16 at so few
    rows that tiles of 64 leave a streaming multiprocessor idle (the kernel
    runs one block an SM)."""
    return next((R for R in (64, 32) if -(-rows // R) >= sms), 16)


def mnn_tile_rows(rows, sms):
    """Rows of a tile of the tiled MNN sampler: 128, so that a bisection
    step's one evaluation a row gives each of the block's 512 threads a
    patch, or 64 or 32 at so few rows that larger tiles leave a streaming
    multiprocessor idle (one block an SM)."""
    return next((R for R in (128, 64) if -(-rows // R) >= sms), 32)


#: The tiles of each kind's tiled kernels, in rows; the sampler's shared
#: memory is planned at the largest.
_TILES = {"umnn": (16, 32, 64), "mnn": (32, 64, 128)}


def _tile_fits(kind, made_w, mono_w, F, C, S, R):
    return 4 * _tile_floats(kind, made_w, mono_w, F, C, S, R) <= SHARED_BYTES


def density_tile_rows(kind, made_w, mono_w, F, C, S, rows, sms):
    """Rows of a tile of the tiled density: the largest of its kind's tiles
    whose shared memory fits in 227 KB, and at most the sampler's tile at
    these rows (:func:`umnn_tile_rows`, :func:`mnn_tile_rows`: tiles that
    leave no streaming multiprocessor idle); ``None`` where none fits (the
    wide tier takes the flow)."""
    most = (umnn_tile_rows if kind == "umnn" else mnn_tile_rows)(rows, sms)
    fits = [R for R in _TILES[kind] if R <= most and _tile_fits(kind, made_w, mono_w, F, C, S, R)]
    return fits[-1] if fits else None


def plan_naf(kind, made_w, mono_w, F, C, S, n_stages, rows, sample=False):
    """The tier of the density (or with ``sample`` the sampler) for a flow of
    this kind (``"umnn"`` or ``"mnn"``) and shape, what the wrappers launch,
    from the shapes alone: the narrow tier, the tiled kernel, within its
    limits and where its shared memory fits in 227 KB (the sampler's at its
    largest tile, 64 rows for a UNAF and 128 for a NAF; the density's at its
    smallest, 16 or 32), else the wide tier with a workspace of ``F + C + 2
    max(MADE widths) + S + 1 + 5 max(network widths) + F`` floats a row (the
    fields of ``Row`` in ``csrc/naf_fused.cu``) and a descriptor buffer of
    the widths, their offsets and 24 bytes a stage, rounded up."""
    n_made, n_mono = len(made_w) - 1, len(mono_w) - 1
    made_max, mono_max = max(made_w[:-1]), max(mono_w[1:-1])
    tile = _TILES[kind][-1 if sample else 0]
    if (F <= _MAX_FEATURES and S <= _MAX_SIGNAL and n_stages <= _MAX_STAGES
            and max(n_made, n_mono) <= _MAX_LINEAR and made_max <= _MAX_MADE_WIDTH
            and mono_max <= _MAX_MONO_WIDTH
            and _tile_fits(kind, made_w, mono_w, F, C, S, tile)):
        return narrow_plan(rows)
    slots = (F + C) + 2 * made_max + (S + 1) + 5 * mono_max + F
    desc = -(-4 * (2 * (n_made + n_mono) + 2) // 16) * 16 + 24 * n_stages
    return wide_plan(slots, rows, desc)


def _launch(fn, counter, xc, outs, params, layout, F, S):
    """Common launch path of the two kernels: check, plan the tier, pack
    every stage's parameters into one buffer (a softclip holds none),
    describe the stages by kind, passes, bound and offset, call the C entry
    point on the current stream, raise on a CUDA error, count (a UMNN flow
    under ``<kernel>_umnn``, the wide tier under ``<counter>_wide``)."""
    from ._build import check_launch, load_library

    if xc.dim() != 2 or not xc.is_contiguous() or xc.shape[1] < F:
        raise ValueError(f"{counter}: expected a contiguous (n, F + C) tensor, F = {F}")
    C = xc.shape[1] - F
    kind, made_w, mono_w = _widths(params, layout, F, C, S)
    check_cuda_f32(counter, [xc, *params])
    sample, rows, sms = fn == "naf_sample_f32", xc.shape[0], sm_count(xc.device)
    plan = plan_naf(kind, made_w, mono_w, F, C, S, len(layout), rows, sample=sample)
    # the narrow tier's tile rows (unused by the wide tier)
    if sample:
        tile = (umnn_tile_rows if kind == "umnn" else mnn_tile_rows)(rows, sms)
    else:
        tile = density_tile_rows(kind, made_w, mono_w, F, C, S, rows, sms) or 0
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
    work, desc = workspace(plan, xc.device)

    lib = load_library("naf_fused")
    with torch.cuda.device(xc.device):
        rc = getattr(lib, fn)(
            xc.data_ptr(), *outs, packed.data_ptr(),
            *(ctypes.addressof(column) for column in columns), len(table),
            ctypes.addressof(c_made), len(made_w) - 1, ctypes.addressof(c_mono), len(mono_w) - 1,
            F, C, S, _MODE_CODE[kind], xc.shape[0], int(plan.wide),
            None if work is None else work.data_ptr(), 0 if work is None else work.numel(),
            plan.chunk_rows, None if desc is None else desc.data_ptr(), plan.desc_bytes,
            tile, torch.cuda.current_stream().cuda_stream,
        )
    check_launch(counter, lib, "naf_fused", rc)
    if kind == "umnn":
        counter = counter.replace("naf_density", "naf_density_umnn").replace(
            "naf_sample", "naf_sample_umnn")
    LAUNCHES[counter + ("_wide" if plan.wide else "")] += 1


def _density_kernel(xc, params, layout, F, S):
    out = torch.empty(xc.shape[0], device=xc.device, dtype=torch.float32)
    _launch("naf_density_f32", "naf_density", xc, [out.data_ptr()], params, layout, F, S)
    return out


def naf_density(xc, params, layout, F, S):
    r"""Whole-flow NAF or UNAF log-density ``xc (n, F + C) -> (n,)``: the
    ``naf_density`` kernel for a CUDA tensor (differentiable through
    :class:`~._common.RowChunkedBackward`, the backward of
    ``_naf_density_bwd`` :855, in chunks of rows for float32 accuracy and
    memory), the plain version for a CPU tensor."""
    if not xc.is_cuda:
        return _naf_density_math(xc, params, layout, F, S)
    return RowChunkedBackward.apply(
        xc.contiguous(), _density_kernel, _naf_density_math, (layout, F, S), *params)


def naf_sample(zc, params, layout, F, S, want_log_prob=False):
    r"""Whole-flow NAF or UNAF inversion ``zc (n, F + C) -> x (n, F)``, and
    with ``want_log_prob`` also ``log q (n,)``: the ``naf_sample`` kernel for
    a CUDA tensor, the plain version for a CPU tensor. Not differentiable;
    the differentiable form is :mod:`zuko_tpu_torch.ops.ift`."""
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
