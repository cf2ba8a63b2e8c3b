r"""Whole-flow continuous normalizing flow (CNF, FFJORD) density and sampling:
plain PyTorch versions and the CUDA kernels that replace the TPU kernels.

Counterpart of ``zuko_tpu/ops/cnf_fused.py``. Two kernels, both in
``csrc/cnf_fused.cu``:

* ``cnf_density`` replaces ``_cnf_impl`` (:819, ``pallas_call`` at :863):
  ``log_prob`` by the adaptive Dormand-Prince 4(5) integration of the
  augmented system :math:`d(x, \ell)/dt = (f(t, x), s\,\mathrm{tr}\,
  \partial_x f)` from t = 0 to 1 (``s = trace_scale``), the trace exact or
  Hutchinson's, then the standard-normal term of the endpoint plus
  :math:`\ell / s`.
* ``cnf_sample`` replaces ``_cnf_sample_impl`` (:1252, ``pallas_call`` at
  :1312): base draws integrated from t = 1 to 0; with ``want_log_prob`` the
  same pass integrates the trace and returns ``log q = log N(z) - ladj``,
  without it ``x`` alone (the error control then runs over ``x`` only, as
  ``FreeFormJacobianTransform.inverse`` does).

Step control is per tile of :data:`TILE` rows, as in the TPU kernel: the
rows of a tile share one sequence of accepted steps, the error ratio being
the max over the tile's rows, over ``x`` and over the scaled ladj
(``_cnf_tile_integrate`` :302, :413-427). Rows past the end of the input
take no part in it (the TPU kernel pads its last tile with rows of zeros
that do), and a tile that runs out of its ``4 max_steps`` attempts
NaN-poisons its rows. The unfused flow controls its steps over the whole
batch (:func:`~zuko_tpu_torch.utils.odeint`); the two agree to solver
tolerance, and exactly when one tile holds the batch. The plain versions
(:func:`_cnf_tile_math`, :func:`_cnf_tile_sample_math`) take the same tiles.

Each wrapper takes the plain version for a tensor that lies on the CPU, and
launches its kernel (or raises) for a CUDA tensor. :func:`plan_cnf` chooses
the kernels' tier from the flow's shape. ``LAUNCHES`` counts the launches
under ``cnf_density``, ``cnf_sample`` and ``cnf_sample_log_prob``, with
``_wide`` at the end for the wide tier. The density's backward is not a
kernel: it is autograd over the global-step integration
(:func:`_ref_log_prob`), as ``_cnf_bwd`` (:761) is a VJP of it. The TPU
kernels' workarounds are not carried over: no tile shrinking for a wide
flow (``_cnf_tb``), no VMEM gate (``_CNF_VMEM_BUDGET``), no ``exp``/``log``
forms of ELU or of the step factor.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as Fn

from ..transforms import ComposedTransform, FreeFormJacobianTransform
from ..utils import _DP_A, _DP_B4, _DP_B5, _DP_C, broadcast
from ._common import (
    LAUNCHES,
    WORKSPACE_BYTES,
    KernelPlan,
    PlainBackward,
    check_cuda_f32,
    narrow_plan,
    workspace,
)
from .nsf_fused import FusedStructureError, _require_standard_base

__all__ = [
    "TILE",
    "cnf_density",
    "cnf_sample",
    "extract_cnf_params",
    "fused_cnf_log_prob",
    "fused_cnf_sample",
    "plan_cnf",
]

#: Rows of a tile: one CUDA block, one thread a row, one sequence of steps.
TILE = 256
_LOG_2PI = math.log(2 * math.pi)
# The narrow tier's limits (mirrored in csrc/cnf_fused.cu): features, hidden
# widths, linears, frequencies, and the floats of the weights it stages in
# shared memory. Beyond any of them the wide tier takes the flow.
_MAX_FEATURES = 16
_MAX_WIDTH = 128
_MAX_LINEAR = 4
_MAX_FREQS = 16
_MAX_SHARED_FLOATS = 32768
_TRACE_CODE = {None: 0, True: 1, False: 2}  # no trace, exact, Hutchinson


# ------------------------------------------------------------- extraction


def extract_cnf_params(flow, transform, c=None):
    """Validate a built CNF transform and pull its parameters out
    (counterpart of ``extract_cnf_params`` :88): exactly one
    :class:`~zuko_tpu_torch.transforms.FreeFormJacobianTransform` over the
    CNF dynamics from t = 0 to 1, an ODE network of biased ``Linear`` layers
    with ELU between them, and a constant standard-normal base. Anything else
    raises :class:`FusedStructureError`. Returns ``(ws, bs, c, t, cfg)``,
    ``t`` the transform (its ``probe`` draws the Hutchinson probe)."""
    from ..flows.continuous import _ffj_dynamics
    from ..nn import Activation, Linear

    if isinstance(transform, ComposedTransform):
        if len(transform.transforms) != 1:
            raise FusedStructureError("fused CNF kernels require a single-transform flow")
        transform = transform.transforms[0]
    t = transform
    if type(t) is not FreeFormJacobianTransform or t.f is not _ffj_dynamics:
        raise FusedStructureError(
            "fused CNF kernels require a FreeFormJacobianTransform over the CNF dynamics,"
            f" got {type(t).__name__}")
    if (t.t0, t.t1) != (0.0, 1.0):
        raise FusedStructureError(f"fused CNF density integrates t=0..1, got ({t.t0}, {t.t1})")
    if not t.exact and t.seed is None:
        raise FusedStructureError("the Hutchinson trace needs a seed")
    ws, bs, expect_linear = [], [], True
    for layer in t.phi["ode"].layers:
        if expect_linear:
            if type(layer) is not Linear or layer.weight.dim() != 2:
                raise FusedStructureError(
                    "fused CNF kernels require a plain (unstacked) Linear MLP, got"
                    f" {type(layer).__name__}")
            if layer.bias is None:
                raise FusedStructureError("fused CNF kernels require biases")
            ws.append(layer.weight)
            bs.append(layer.bias)
        elif not isinstance(layer, Activation) or layer.fn is not Fn.elu:
            raise FusedStructureError(
                f"fused CNF kernels support ELU activations only, got {type(layer).__name__}")
        expect_linear = not expect_linear
    if expect_linear:
        raise FusedStructureError("unexpected ODE-net layer structure")
    F, C = ws[-1].shape[0], 0 if c is None else c.shape[-1]
    freqs = tuple(float(f) for f in t.phi["freqs"].tolist())
    nf = len(freqs)
    if ws[0].shape[1] != 2 * nf + F + C:
        raise FusedStructureError(f"ODE-net input width {ws[0].shape[1]} != 2*{nf} + {F} + {C}")
    _require_standard_base(flow, F)
    cfg = {
        "F": F, "C": C, "nf": nf, "atol": t.atol, "rtol": t.rtol, "max_steps": t.max_steps,
        "exact": t.exact, "scale": t.trace_scale, "freqs": freqs,
    }
    return ws, bs, c, t, cfg


def _flatten_cnf(flow, transform, c=None):
    """``(params, probe, cfg)``: the ODE network's ``[W, b, ...]``, the
    transform's Hutchinson ``probe`` (``None`` for the exact trace) and the
    configuration, taken once per ``flow(c)``."""
    ws, bs, _, t, cfg = extract_cnf_params(flow, transform, c)
    params = [p for pair in zip(ws, bs) for p in pair]
    return params, None if t.exact else t.probe, cfg


def _kernel_params(ws, bs, c, cfg):
    """Split the first layer into its ``x``, time-embedding and context
    columns (the dynamics' input is ``[te, x, c]``) and fold the context
    into the first bias (counterpart of ``_kernel_params`` :782 and, for a
    context of rows, of ``_batched_aug`` :802): ``[W1_x, W1_te, b1, W2,
    b2, ...]`` with ``b1`` of shape ``(H1,)``, or ``(n, H1)`` for a context
    ``(n, C)``."""
    F, C, nf = cfg["F"], cfg["C"], cfg["nf"]
    W1 = ws[0]
    b1 = bs[0]
    if C:
        b1 = b1 + c.to(W1.dtype) @ W1[:, 2 * nf + F:].T
    params = [W1[:, 2 * nf: 2 * nf + F], W1[:, : 2 * nf], b1]
    for W, b in zip(ws[1:], bs[1:]):
        params += [W, b]
    return params


# ------------------------------------------------------------ global steps


def _net_dynamics(t, u, phi):
    """The dynamics with explicit parameters: the ODE network ``phi["w"]``,
    ``phi["b"]`` (ELU between its linears) on ``[cos(f t), sin(f t), u, c]``;
    :func:`~zuko_tpu_torch.flows.continuous._ffj_dynamics` with the network
    written out."""
    te = phi["freqs"] * t[..., None]
    te = torch.cat([torch.cos(te), torch.sin(te)], dim=-1)
    c = phi["c"]
    parts = broadcast(te, u, ignore=1) if c is None else broadcast(te, u, c, ignore=1)
    h = torch.cat(parts, dim=-1)
    for i, (W, b) in enumerate(zip(phi["w"], phi["b"])):
        h = h @ W.T + b
        if i < len(phi["w"]) - 1:
            h = Fn.elu(h)
    return h


def _ref_log_prob(x, eps, ws, bs, c, cfg):
    """The density by the unfused flow's global-step integration (counterpart
    of ``_ref_log_prob`` :247), with explicit parameters: what the density
    Function's backward differentiates."""
    t = FreeFormJacobianTransform(
        _net_dynamics, 0.0, 1.0,
        {"w": list(ws), "b": list(bs), "c": c,
         "freqs": torch.tensor(cfg["freqs"], dtype=x.dtype, device=x.device)},
        cfg["atol"], cfg["rtol"], cfg["exact"], None, cfg["max_steps"])
    y, ladj = t.augmented(x, eps)
    return -0.5 * (y * y).sum(dim=-1) - 0.5 * cfg["F"] * _LOG_2PI + ladj


# ------------------------------------------------------------ plain versions


def _tile_dynamics(s, xi, params, b1, eps, cfg, reverse, trace):
    """The tiles' dynamics at stage times ``s (k,)``, states ``xi (k, T, F)``:
    ``dx`` and ``trace_scale`` times the trace (``None`` without a trace),
    both negated for the reverse direction (the ``t1 - t0 = -1`` factor of
    the normalized time). The exact trace takes, for each column ``j``,
    ``W1_x[:, j]`` through the hidden layers (``v <- W (elu'(h) * v)``) and
    only row ``j`` of the last layer; Hutchinson's takes ``eps`` through
    once and dots the result with it (counterpart of ``f_aug`` in
    ``_cnf_tile_integrate`` :341)."""
    W1_x, W1_te, rest = params[0], params[1], params[3:]
    tt = 1 - s if reverse else s
    ft = tt[:, None] * torch.tensor(cfg["freqs"], dtype=xi.dtype, device=xi.device)
    te = torch.cat([torch.cos(ft), torch.sin(ft)], dim=1) @ W1_te.T
    h = xi @ W1_x.T + b1 + te[:, None, :]
    derivs = []
    for W, b in zip(rest[0::2], rest[1::2]):
        derivs.append(torch.where(h > 0, 1.0, torch.exp(h.clamp(max=0))))
        h = Fn.elu(h) @ W.T + b
    tr = None
    if trace is not None:
        Ws = rest[0::2]
        if trace:  # exact: column j of W1_x, row j of the last layer
            if not Ws:
                tr = torch.diagonal(W1_x).sum().expand(h.shape[:-1])
            else:
                v = derivs[0][..., None, :] * W1_x.T
                for W, d in zip(Ws[:-1], derivs[1:]):
                    v = (v @ W.T) * d[..., None, :]
                tr = torch.einsum("ktjh,jh->kt", v, Ws[-1])
        else:
            v = eps @ W1_x.T
            for W, d in zip(Ws, derivs):
                v = (d * v) @ W.T
            tr = (v * eps).sum(dim=-1)
        tr = tr * cfg["scale"]
    if reverse:
        return -h, None if tr is None else -tr
    return h, tr


def _tile_step(x, l, s, dt, f):
    """One Dormand-Prince 4(5) step of every tile at once: ``x (k, T, F)``,
    ``l (k, T)`` or ``None``, ``s, dt (k,)``; returns the fifth-order
    solutions and the error estimates."""
    dtx, dtl = dt[:, None, None], dt[:, None]
    kxs, kls = [], []
    for i in range(7):
        xi = x
        for j, a in enumerate(_DP_A[i]):
            if a != 0.0:
                xi = xi + (dtx * a) * kxs[j]
        kx, kl = f(s + _DP_C[i] * dt, xi)
        kxs.append(kx)
        kls.append(kl)
    x5, ex = x, torch.zeros_like(x)
    l5, el = l, None if l is None else torch.zeros_like(l)
    for i in range(7):
        b5, d = _DP_B5[i], _DP_B5[i] - _DP_B4[i]
        if b5 != 0.0:
            x5 = x5 + (dtx * b5) * kxs[i]
            if l is not None:
                l5 = l5 + (dtl * b5) * kls[i]
        if d != 0.0:
            ex = ex + (dtx * d) * kxs[i]
            if l is not None:
                el = el + (dtl * d) * kls[i]
    return x5, l5, ex, el


def _tiles(a, tile):
    """Rows ``(n, ...)`` as ``(tiles, tile, ...)``, the last tile padded with
    zeros."""
    pad = -a.shape[0] % tile
    if pad:
        a = torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])
    return a.reshape((-1, tile) + a.shape[1:])


def _cnf_tile_integrate(x, eps, params, cfg, reverse, trace, tile=None):
    """The adaptive integration of the rows ``x (n, F)`` in tiles of
    ``tile`` rows (default :data:`TILE`), each tile with its own ``t``,
    ``dt`` and accept decision (counterpart of ``_cnf_tile_integrate``
    :302): the error ratio is the max over the tile's rows (those past
    ``n`` excluded) of ``|err| / (atol + rtol max(|x|, |y|))`` over ``x`` and
    the scaled ladj, NaN a rejection, the step factor ``0.9 ratio^(-1/5)``
    clipped to [0.1, 10]; a tile still short of its end after ``4
    max_steps`` attempts is NaN. ``trace``: ``None`` (``x`` alone), ``True``
    (exact) or ``False`` (Hutchinson, probe ``eps (n, F)``). Returns the
    endpoints, the scaled ladjs (``None`` without a trace) and the attempts
    of each tile."""
    tile = TILE if tile is None else tile
    n, F = x.shape
    X = _tiles(x, tile).clone()  # updated in place below
    valid = _tiles(torch.ones(n, dtype=torch.bool, device=x.device), tile)
    E = None if eps is None else _tiles(eps, tile)
    b1 = params[2]
    B = b1 if b1.dim() == 1 else _tiles(b1, tile)
    L = None if trace is None else x.new_zeros(X.shape[:2])
    k = X.shape[0]
    t, dt = x.new_zeros(k), x.new_ones(k)
    attempts = torch.zeros(k, dtype=torch.long, device=x.device)
    tiny = torch.finfo(x.dtype).tiny
    while True:
        idx = ((t < 1) & (attempts < 4 * cfg["max_steps"])).nonzero()[:, 0]
        if idx.numel() == 0:
            break
        xa, ta, ok = X[idx], t[idx], valid[idx]
        la = None if L is None else L[idx]
        dta = torch.minimum(dt[idx], 1 - ta)
        b1a = B if B.dim() == 1 else B[idx]
        ea = None if E is None else E[idx]
        y, ly, ex, el = _tile_step(xa, la, ta, dta, lambda s, xi: _tile_dynamics(
            s, xi, params, b1a, ea, cfg, reverse, trace))
        tol = cfg["atol"] + cfg["rtol"] * torch.maximum(xa.abs(), y.abs())
        ratio = torch.where(ok[..., None], ex.abs() / tol, 0.0).amax(dim=(1, 2))
        if L is not None:
            tol = cfg["atol"] + cfg["rtol"] * torch.maximum(la.abs(), ly.abs())
            ratio = torch.maximum(ratio, torch.where(ok, el.abs() / tol, 0.0).amax(dim=1))
        ratio = torch.where(torch.isnan(ratio), math.inf, ratio)
        accept = ratio <= 1
        X[idx] = torch.where(accept[:, None, None], y, xa)
        if L is not None:
            L[idx] = torch.where(accept[:, None], ly, la)
        t[idx] = torch.where(accept, ta + dta, ta)
        dt[idx] = dta * (0.9 * ratio.clamp(min=tiny) ** -0.2).clamp(0.1, 10.0)
        attempts[idx] += 1
    # a tile that ran out of attempts: NaN, as the TPU kernel's (:439-444)
    exhausted = t < 1 - 64 * torch.finfo(torch.float32).eps
    X[exhausted] = math.nan
    if L is not None:
        L[exhausted] = math.nan
    L = None if L is None else L.reshape(-1)[:n]
    return X.reshape(-1, F)[:n], L, attempts


def _cnf_tile_math(x, eps, params, cfg, tile=None, counts=False):
    """Plain version of the density kernel (counterpart of
    ``_cnf_tile_math`` :641): ``x (n, F)`` integrated from t = 0 to 1 with
    the trace, ``log N(z) + ladj`` at the endpoint ``z``; ``params`` as
    :func:`_kernel_params` gives them. With ``counts`` also the attempts of
    each tile."""
    z, l, attempts = _cnf_tile_integrate(x, eps, params, cfg, False, cfg["exact"], tile)
    lp = -0.5 * (z * z).sum(dim=1) - 0.5 * cfg["F"] * _LOG_2PI + l / cfg["scale"]
    return (lp, attempts) if counts else lp


def _cnf_tile_sample_math(z, eps, params, cfg, want_log_prob=False, tile=None, counts=False):
    """Plain version of the sampling kernel (counterpart of
    ``_cnf_tile_sample_math`` :650): the base draws ``z (n, F)`` integrated
    from t = 1 to 0, ``x`` alone or, with ``want_log_prob``, with the trace
    and ``log q = log N(z) - ladj``. With ``counts`` also the attempts of
    each tile."""
    trace = cfg["exact"] if want_log_prob else None
    x, l, attempts = _cnf_tile_integrate(z, eps, params, cfg, True, trace, tile)
    out = x
    if want_log_prob:
        out = x, -0.5 * (z * z).sum(dim=1) - 0.5 * cfg["F"] * _LOG_2PI - l / cfg["scale"]
    return (out, attempts) if counts else out


# ---------------------------------------------------------- CUDA launches


def _widths(params):
    """``[F, H1, ..., F]``: the ODE network's input ``x`` width and the
    output width of each linear, from ``[W1_x, W1_te, b1, W2, b2, ...]``."""
    return [params[0].shape[1], params[0].shape[0], *(W.shape[0] for W in params[3::2])]


def plan_cnf(widths, nf, rows):
    """The tier of the CNF kernels for a network of ``widths = [F, H1, ...,
    F]`` under ``nf`` frequencies (what the wrappers launch, from the shapes
    alone): the narrow tier within its limits (the weights staged in shared
    memory, a row's state in per-thread arrays), else the wide tier with a
    workspace of ``3 F + 7 (F + 1) + sum(hidden) + 4 max(hidden)`` floats a
    row (the fields of ``Row`` in ``csrc/cnf_fused.cu``), in launches of whole
    tiles, and a descriptor buffer of the widths, offsets and frequencies."""
    F, hidden, n_lin = widths[0], widths[1:-1], len(widths) - 1
    weights = sum(o * (i + 1) for i, o in zip(widths[:-1], widths[1:])) + 2 * nf * widths[1]
    if (F <= _MAX_FEATURES and max(hidden, default=0) <= _MAX_WIDTH and n_lin <= _MAX_LINEAR
            and nf <= _MAX_FREQS and weights <= _MAX_SHARED_FLOATS):
        return narrow_plan(rows)
    slots = 3 * F + 7 * (F + 1) + sum(hidden) + 4 * max(hidden, default=1)
    most = max(TILE, WORKSPACE_BYTES // (4 * slots) // TILE * TILE)
    chunk = min(most, max(TILE, -(-rows // TILE) * TILE))
    return KernelPlan(True, slots, chunk, 4 * slots * chunk, 4 * (2 * n_lin + 1 + nf))


def _launch(fn, counter, x, eps, outs, params, cfg, trace):
    """Common launch path of the two kernels: check, plan the tier, pack the
    weights (``[W1_x, W1_te, b1 unless per row, W2, b2, ...]``), call the C
    entry point on the current stream, raise on a CUDA error, count (the
    wide tier under ``<counter>_wide``)."""
    from ._build import check_launch, load_library

    F = cfg["F"]
    if x.dim() != 2 or x.shape[1] != F or not x.is_contiguous():
        raise ValueError(f"{counter}: expected a contiguous (n, {F}) tensor")
    n = x.shape[0]
    row_bias = params[2].dim() == 2
    if row_bias and tuple(params[2].shape) != (n, params[0].shape[0]):
        raise ValueError(f"{counter}: the per-row first bias must be (n, H1)")
    if trace is False and (eps is None or tuple(eps.shape) != (n, F)):
        raise ValueError(f"{counter}: the Hutchinson trace needs a probe of shape (n, {F})")
    check_cuda_f32(counter, [x, *params] + ([eps] if trace is False else []))
    widths = _widths(params)
    plan = plan_cnf(widths, cfg["nf"], n)
    packed = torch.cat([p.detach().reshape(-1) for i, p in enumerate(params)
                        if not (i == 2 and row_bias)])
    bias = params[2].detach().contiguous() if row_bias else None
    eps = eps.contiguous() if trace is False else None
    c_widths = (ctypes.c_int * len(widths))(*widths)
    c_freqs = (ctypes.c_float * max(1, cfg["nf"]))(*cfg["freqs"])
    work, desc = workspace(plan, x.device)

    lib = load_library("cnf_fused")
    with torch.cuda.device(x.device):
        rc = getattr(lib, fn)(
            x.data_ptr(), None if eps is None else eps.data_ptr(),
            None if bias is None else bias.data_ptr(), *outs, packed.data_ptr(),
            ctypes.addressof(c_widths), len(widths) - 1, cfg["nf"], ctypes.addressof(c_freqs),
            cfg["atol"], cfg["rtol"], cfg["scale"], cfg["max_steps"], _TRACE_CODE[trace], n,
            int(plan.wide), None if work is None else work.data_ptr(),
            0 if work is None else work.numel(), plan.chunk_rows,
            None if desc is None else desc.data_ptr(), plan.desc_bytes,
            torch.cuda.current_stream().cuda_stream,
        )
    check_launch(counter, lib, "cnf_fused", rc)
    LAUNCHES[counter + ("_wide" if plan.wide else "")] += 1


def _split(params, has_c):
    """``(ws, bs, c)`` from the density Function's flat parameters."""
    c = params[-1] if has_c else None
    flat = params[:-1] if has_c else params
    return list(flat[0::2]), list(flat[1::2]), c


def _density_plain(x, params, eps, cfg, has_c):
    ws, bs, c = _split(params, has_c)
    return _cnf_tile_math(x, eps, _kernel_params(ws, bs, c, cfg), cfg)


def _density_kernel(x, params, eps, cfg, has_c):
    ws, bs, c = _split(params, has_c)
    with torch.no_grad():
        kp = _kernel_params(ws, bs, c, cfg)
    out = torch.empty(x.shape[0], device=x.device, dtype=torch.float32)
    _launch("cnf_density_f32", "cnf_density", x, eps, [out.data_ptr()], kp, cfg, cfg["exact"])
    return out


def _density_ref(x, params, eps, cfg, has_c):
    ws, bs, c = _split(params, has_c)
    return _ref_log_prob(x, eps, ws, bs, c, cfg)


def cnf_density(x, eps, params, c, cfg):
    r"""Whole-flow CNF log-density of the rows ``x (n, F)`` (counterpart of
    ``_cnf_op`` :715): the ``cnf_density`` kernel for a CUDA tensor, the
    plain version for a CPU tensor; ``eps (n, F)`` is the Hutchinson probe
    (``None`` for the exact trace), ``params`` the ODE network's ``[W, b,
    ...]``, ``c`` the context (``(C,)``, ``(n, C)`` or ``None``).
    Differentiable with respect to ``x``, ``params`` and ``c``: the
    backward is autograd over the global-step integration
    (:func:`_ref_log_prob`) in the input's dtype, as ``_cnf_bwd`` (:761)."""
    forward = _density_kernel if x.is_cuda else _density_plain
    extra = [] if c is None else [c]
    return PlainBackward.apply(x, forward, _density_ref, (eps, cfg, c is not None),
                               *params, *extra)


def cnf_sample(z, eps, params, c, cfg, want_log_prob=False):
    r"""Whole-flow CNF sampling from the base draws ``z (n, F)``: ``x (n, F)``
    and, with ``want_log_prob``, ``log q (n,)`` (counterpart of
    ``_cnf_sample_impl`` :1252): the ``cnf_sample`` kernel for a CUDA
    tensor, the plain version for a CPU tensor. Not differentiable."""
    with torch.no_grad():
        kp = _kernel_params(params[0::2], params[1::2], c, cfg)
        if not z.is_cuda:
            return _cnf_tile_sample_math(z, eps, kp, cfg, want_log_prob)
        z = z.contiguous()
        x = torch.empty(z.shape[0], cfg["F"], device=z.device, dtype=torch.float32)
        lq = torch.empty(z.shape[0], device=z.device, dtype=torch.float32) \
            if want_log_prob else None
        _launch("cnf_sample_f32", "cnf_sample_log_prob" if want_log_prob else "cnf_sample",
                z, eps, [x.data_ptr(), None if lq is None else lq.data_ptr()], kp, cfg,
                cfg["exact"] if want_log_prob else None)
    return (x, lq) if want_log_prob else x


# ------------------------------------------------------------ flow level


def _rows(a, batch):
    """``a (*, k)`` broadcast to ``batch`` and flattened to rows."""
    return a.expand(batch + a.shape[-1:]).reshape(-1, a.shape[-1])


def fused_cnf_log_prob(flat, x, c=None):
    r"""``flow(c).log_prob(x)`` for a CNF through :func:`cnf_density`, with
    ``flat = _flatten_cnf(flow, transform, c)`` (counterpart of
    ``fused_cnf_log_prob`` :678). The Hutchinson probe is the transform's, at
    ``x``'s shape; a context of rows broadcasts against the batch of ``x``."""
    params, probe, cfg = flat
    F = cfg["F"]
    if x.shape[-1] != F:
        raise FusedStructureError(f"x has {x.shape[-1]} features, flow has {F}")
    eps = None if probe is None else probe(x)
    batch = x.shape[:-1]
    if c is not None and c.dim() > 1:
        batch = torch.broadcast_shapes(batch, c.shape[:-1])
        c = _rows(c, batch)
    eps = None if eps is None else _rows(eps, batch)
    return cnf_density(_rows(x, batch), eps, params, c, cfg).reshape(batch)


def fused_cnf_sample(flat, sample_shape=(), c=None, generator=None, want_log_prob=False):
    r"""Draw ``sample_shape + cbatch + (F,)`` samples (and ``log q`` with
    ``want_log_prob``) through :func:`cnf_sample`, with ``flat =
    _flatten_cnf(flow, transform, c)`` (counterpart of ``fused_cnf_sample``
    :896): the base draws are the unfused flow's (``torch.randn`` of
    ``generator``), the Hutchinson probe the transform's at their shape. Not
    differentiable."""
    params, probe, cfg = flat
    F, W = cfg["F"], params[0]
    cbatch = () if c is None else tuple(c.shape[:-1])
    shape = tuple(sample_shape) + cbatch + (F,)
    z = torch.randn(shape, generator=generator, device=W.device, dtype=W.dtype)
    eps = None if probe is None or not want_log_prob else probe(z).reshape(-1, F)
    if c is not None and c.dim() > 1:
        c = _rows(c, shape[:-1])
    out = cnf_sample(z.reshape(-1, F), eps, params, c, cfg, want_log_prob)
    if want_log_prob:
        x, lq = out
        return x.reshape(shape), lq.reshape(shape[:-1])
    return out.reshape(shape)
