r"""Whole-flow continuous normalizing flow (CNF, FFJORD) density, sampling and
the continuous adjoint of sampling: plain PyTorch versions and the CUDA
kernels that replace the TPU kernels.

Counterpart of ``zuko_tpu/ops/cnf_fused.py``. Three kernels, all in
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
* ``cnf_adjoint`` replaces ``_cnf_adjoint_pallas`` (:957, ``pallas_call`` at
  :1044): the backward of :func:`fused_cnf_rsample`, one continuous-adjoint
  integration per tile of ``(u, a, g_theta)`` from the samples back to the
  base draws (:func:`_cnf_tile_adjoint_math`), followed by the
  solve-consistency gate (:func:`_cnf_bwd_finish`).

Step control is per tile of :data:`TILE` rows, as in the TPU kernel: the
rows of a tile share one sequence of accepted steps, the error ratio being
the max over the tile's rows, over ``x`` and over the scaled ladj
(``_cnf_tile_integrate`` :302, :413-427), and for the adjoint over every
leaf. Rows past the end of the input take no part in it (the TPU kernel
pads its last tile with rows of zeros that do), and a tile that runs out of
its ``4 max_steps`` attempts NaN-poisons its rows. The unfused flow controls
its steps over the whole batch (:func:`~zuko_tpu_torch.utils.odeint`); the
two agree to solver tolerance, and exactly when one tile holds the batch
(for the adjoint: without a context, whose gradient ``zuko_tpu``'s CPU
backend controls where the tile adjoint controls the folded first bias's).
The plain versions (:func:`_cnf_tile_math`, :func:`_cnf_tile_sample_math`,
:func:`_cnf_tile_adjoint_math`) take the same tiles.

Each wrapper takes the plain version for a tensor that lies on the CPU, and
launches its kernel (or raises) for a CUDA tensor. :func:`plan_cnf` and
:func:`plan_cnf_adjoint` choose the kernels' tier from the flow's shape;
each narrow tier spreads a tile over a cluster of blocks
(:class:`ClusterPlan` for the density and the sampler, :class:`AdjointPlan`).
``LAUNCHES`` counts the launches under ``cnf_density``, ``cnf_sample``,
``cnf_sample_log_prob``, ``cnf_adjoint`` and ``cnf_adjoint_log_prob``, with
``_wide`` at the end for the wide tier. The density's backward is not a
kernel: it is autograd over the global-step integration
(:func:`_ref_log_prob`), as ``_cnf_bwd`` (:761) is a VJP of it. The TPU
kernels' workarounds are not carried over: no tile shrinking for a wide
flow (``_cnf_tb``), no VMEM gate (``_CNF_VMEM_BUDGET``), no ``exp``/``log``
forms of ELU or of the step factor, no second backend of the adjoint
(``_CNF_ADJ``).
"""

from __future__ import annotations

import ctypes
import functools
import math

from typing import NamedTuple

import torch
import torch.nn.functional as Fn

from ..transforms import ComposedTransform, FreeFormJacobianTransform
from ..utils import _DP_A, _DP_B4, _DP_B5, _DP_C, broadcast
from ._common import (
    LAUNCHES,
    SHARED_BYTES,
    WORKSPACE_BYTES,
    PlainBackward,
    check_cuda_f32,
    workspace,
)
from .nsf_fused import FusedStructureError, _require_standard_base

__all__ = [
    "TILE",
    "AdjointPlan",
    "ClusterPlan",
    "cnf_adjoint",
    "cnf_density",
    "cnf_sample",
    "extract_cnf_params",
    "fused_cnf_log_prob",
    "fused_cnf_rsample",
    "fused_cnf_sample",
    "plan_cnf",
    "plan_cnf_adjoint",
]

#: Rows of a tile: one sequence of steps (a cluster of blocks in the narrow
#: tier, one block of one thread a row in the wide tier).
TILE = 256
_LOG_2PI = math.log(2 * math.pi)
# The narrow tier's limits (mirrored in csrc/cnf_fused.cu): features, hidden
# widths, linears, frequencies, and the floats of the packed weights. Beyond
# any of them, or where no cluster plan fits, the wide tier takes the flow.
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


@functools.lru_cache(maxsize=None)
def _freq_tensor(freqs, dtype, device):
    """The frequencies of the time embedding as a tensor, made once."""
    return torch.tensor(freqs, dtype=dtype, device=device)


def _tile_net(s, u, theta, cfg):
    """The ODE network on the tiles at times ``s (k,)`` and states ``u (k,
    T, F)``, ``theta = [W1_x, W1_te, b1, W2, b2, ...]`` shared by the tiles
    but the first bias (``(H1,)``, or per row ``(k, T, H1)``): ``f (k, T,
    F)``, the time embedding ``[cos(s w), sin(s w)] (k, 2 nf)``, and each
    hidden layer's ELU output and ELU derivative."""
    W1_x, W1_te, b1, rest = theta[0], theta[1], theta[2], theta[3:]
    ft = s[:, None] * _freq_tensor(cfg["freqs"], s.dtype, s.device)
    emb = torch.cat([torch.cos(ft), torch.sin(ft)], dim=1)
    h = u @ W1_x.T + b1 + emb[:, None, :] @ W1_te.T
    acts, derivs = [], []
    for W, b in zip(rest[0::2], rest[1::2]):
        derivs.append(torch.exp(h.clamp(max=0)))  # elu'(h): 1 where h > 0
        acts.append(Fn.elu(h))
        h = acts[-1] @ W.T + b
    return h, emb, acts, derivs


def _tile_f_and_tr(s, u, theta, eps, cfg, trace):
    """The tiles' dynamics ``f (k, T, F)`` and the UNSCALED trace ``(k, T)``
    (``None`` without a trace), as a pure function of ``(u, theta)``
    (counterpart of ``_tile_f_and_tr`` :447), :func:`_tile_net`'s arguments.
    The exact trace takes, for each column ``j``, ``W1_x[:, j]`` through the
    hidden layers (``v <- W (elu'(h) * v)``) and only row ``j`` of the last
    layer; Hutchinson's (``trace`` False) takes the probe ``eps (k, T, F)``
    through once and dots the result with it."""
    h, _, _, derivs = _tile_net(s, u, theta, cfg)
    if trace is None:
        return h, None
    W1_x, Ws = theta[0], theta[3::2]
    if trace and not Ws:
        return h, torch.diagonal(W1_x).sum().expand(h.shape[:-1])
    if trace:  # exact: column j of W1_x, row j of the last layer
        v = derivs[0][..., None, :] * W1_x.T
        for W, d in zip(Ws[:-1], derivs[1:]):
            v = (v @ W.T) * d[..., None, :]
        return h, torch.einsum("ktjh,jh->kt", v, Ws[-1])
    v = eps @ W1_x.T
    for W, d in zip(Ws, derivs):
        v = (d * v) @ W.T
    return h, (v * eps).sum(dim=-1)


def _tile_f_vjp(s, u, theta, eps, fbar, trbar, cfg, trace):
    """:func:`_tile_f_and_tr`'s ``f`` and, by hand, the vector-Jacobian
    product of ``sum(fbar f) + sum(trbar tr)`` (``trbar (k, T)``, ``None``
    with ``trace`` ``None``): ``(f, du, dtheta)``, each parameter's
    cotangent summed over each tile's rows, ``(k, *shape)``, a per-row first
    bias's ``(k, T, H1)``. The trace's tangents are those of a probe ``E``,
    the unit vectors (exact) or ``eps`` (Hutchinson): ``P_1 = E W1_x^T``,
    ``V_i = elu'(h_i) P_i``, ``P_{i + 1} = V_i W_{i + 1}^T``, ``tr = sum(P_L
    E)``; ``tr``'s cotangent reaches each ``h_i`` through ``elu'``'s
    derivative."""
    W1_x, b1, Ws = theta[0], theta[2], theta[3::2]
    h, emb, acts, derivs = _tile_net(s, u, theta, cfg)
    if trace is not None:  # the tangents
        if trace:
            E = torch.eye(u.shape[-1], dtype=u.dtype, device=u.device)
            P = [W1_x.T.expand(u.shape[:2] + W1_x.T.shape)]
        else:
            E = eps[..., None, :]
            P = [E @ W1_x.T]
        V = []
        for W, d in zip(Ws, derivs):
            V.append(d[..., None, :] * P[-1])
            P.append(V[-1] @ W.T)
        gP = trbar[..., None, None] * E

    def outer(a, b):  # sum over a tile's rows (and tangents) of a b^T: (k, o, i)
        return a.flatten(1, -2).mT @ b.flatten(1, -2)

    g, dWs, dbs = fbar, [], []
    for i in reversed(range(len(Ws))):
        dWs.append(outer(g, acts[i]))
        dbs.append(g.sum(dim=1))
        gh = (g @ Ws[i]) * derivs[i]
        if trace is not None:
            dWs[-1] = dWs[-1] + outer(gP, V[i])
            gV = gP @ Ws[i]
            gd = (gV * P[i]).sum(dim=-2)
            gh = gh + gd * torch.where(acts[i] > 0, 0.0, derivs[i])
            gP = gV * derivs[i][..., None, :]
        g = gh
    dW1 = outer(g, u)
    if trace:
        dW1 = dW1 + gP.sum(dim=1).mT
    elif trace is False:
        dW1 = dW1 + outer(gP[..., 0, :], eps)
    gte = g.sum(dim=1)
    dth = [dW1, gte[:, :, None] * emb[:, None, :], gte if b1.dim() == 1 else g]
    for dW, db in zip(reversed(dWs), reversed(dbs)):
        dth += [dW, db]
    return h, g @ W1_x, dth


def _tile_dynamics(s, xi, params, b1, eps, cfg, reverse, trace):
    """The tiles' dynamics at stage times ``s (k,)``, states ``xi (k, T, F)``:
    ``dx`` and ``trace_scale`` times the trace (``None`` without a trace),
    both negated for the reverse direction (the ``t1 - t0 = -1`` factor of
    the normalized time); :func:`_tile_f_and_tr` with the first bias ``b1``
    (counterpart of ``f_aug`` in ``_cnf_tile_integrate`` :341)."""
    h, tr = _tile_f_and_tr(1 - s if reverse else s, xi, [params[0], params[1], b1, *params[3:]],
                           eps, cfg, trace)
    if tr is not None:
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


def _cnf_tile_adjoint_math(x, a, glq, eps, params, cfg, tile=None, counts=False):
    r"""Plain version of the adjoint kernel (counterpart of
    ``_cnf_tile_adjoint`` :506): per tile of ``tile`` rows (default
    :data:`TILE`), the continuous adjoint

    .. math:: \dot u = f,\quad \dot a = -\partial_u(a^\top f - \bar L\,
        \mathrm{tr}),\quad \dot g_\theta = -\partial_\theta(a^\top f - \bar L\,
        \mathrm{tr})

    integrated from the samples ``x (n, F)`` (t = 0) to the base draws (t =
    1), ``a (n, F)`` the cotangent of ``x`` and ``glq (n,)`` that of log q
    (:math:`\bar L`; ``None``: no trace term, the error control then runs
    without it as ``_cnf_tile_adjoint``'s does). ``f`` and the unscaled
    trace are :func:`_tile_f_and_tr`, the slopes its vector-Jacobian product
    by hand (:func:`_tile_f_vjp`), each tile's parameter cotangents its own,
    of the parameters ``params`` (as :func:`_kernel_params` gives them;
    ``eps (n, F)`` the Hutchinson probe).
    Dormand-Prince 4(5) with the error ratio the max over every leaf (``u``,
    ``a``, each parameter's accumulator; rows past ``n`` excluded), NaN a
    rejection, at most ``4 max_steps`` attempts; an exhausted tile is NaN in
    every leaf. Returns ``u1 (n, F)``, ``a1 (n, F)`` and the parameter
    cotangents in the order of ``params``: ``(tiles, *shape)``, summed over
    each tile's rows, and for a per-row first bias ``(n, H1)``. With
    ``counts`` also the attempts of each tile."""
    tile = TILE if tile is None else tile
    n, F = x.shape
    trace = None if glq is None else cfg["exact"]
    row_bias = params[2].dim() == 2
    valid = _tiles(torch.ones(n, dtype=torch.bool, device=x.device), tile)
    E = _tiles(eps, tile) if trace is False else None
    Lq = None if glq is None else _tiles(glq, tile)
    B = _tiles(params[2], tile) if row_bias else None
    k = valid.shape[0]
    # each tile's state as one flat vector: u, a, then each parameter's
    # accumulator (a per-row first bias with a row axis); rows past n are
    # left out of the error control
    shapes = [(tile, F), (tile, F)] + [(tile,) + p.shape[1:] if i == 2 and row_bias else p.shape
                                       for i, p in enumerate(params)]
    sizes = [math.prod(shape) for shape in shapes]
    by_row = [0, 1] + ([4] if row_bias else [])
    state = torch.cat([_tiles(x, tile).reshape(k, -1), _tiles(a, tile).reshape(k, -1),
                       x.new_zeros(k, sum(sizes[2:]))], dim=1)
    counted = torch.cat([valid.repeat_interleave(size // tile, dim=1) if j in by_row
                         else valid.new_ones(k, size) for j, size in enumerate(sizes)], dim=1)
    t, dt = x.new_zeros(k), x.new_ones(k)
    attempts = torch.zeros(k, dtype=torch.long, device=x.device)
    tiny = torch.finfo(x.dtype).tiny

    def slopes(s, flat, theta, eps, trbar):
        # (f, -d/du, -d/dtheta) of phi = a . f - Lq tr, trbar = -Lq
        m = flat.shape[0]
        u, av = (v.reshape(m, tile, F) for v in flat[:, : 2 * sizes[0]].split(sizes[0], dim=1))
        f, du, dth = _tile_f_vjp(s, u, theta, eps, av, trbar, cfg, trace)
        return torch.cat([f.reshape(m, -1)] + [(-g).reshape(m, -1) for g in [du, *dth]], dim=1)

    while True:
        idx = ((t < 1) & (attempts < 4 * cfg["max_steps"])).nonzero()[:, 0]
        if idx.numel() == 0:
            break
        y0, ta = state[idx], t[idx]
        dta = torch.minimum(dt[idx], 1 - ta)
        at = ([params[0], params[1], B[idx] if row_bias else params[2], *params[3:]],
              None if E is None else E[idx], None if Lq is None else -Lq[idx])
        ks = []
        for i in range(7):
            yi = y0
            for j, c in enumerate(_DP_A[i]):
                if c != 0.0:
                    yi = yi + (dta * c)[:, None] * ks[j]
            ks.append(slopes(ta + _DP_C[i] * dta, yi, *at))
        y, err = y0, torch.zeros_like(y0)
        for i in range(7):
            b5, d = _DP_B5[i], _DP_B5[i] - _DP_B4[i]
            if b5 != 0.0:
                y = y + (dta * b5)[:, None] * ks[i]
            if d != 0.0:
                err = err + (dta * d)[:, None] * ks[i]
        r = err.abs() / (cfg["atol"] + cfg["rtol"] * torch.maximum(y0.abs(), y.abs()))
        ratio = torch.where(counted[idx], r, 0.0).amax(dim=1)
        ratio = torch.where(torch.isnan(ratio), math.inf, ratio)
        accept = ratio <= 1
        state[idx] = torch.where(accept[:, None], y, y0)
        t[idx] = torch.where(accept, ta + dta, ta)
        dt[idx] = dta * (0.9 * ratio.clamp(min=tiny) ** -0.2).clamp(0.1, 10.0)
        attempts[idx] += 1
    # a tile that ran out of attempts: NaN in every leaf
    state[t < 1 - 64 * torch.finfo(torch.float32).eps] = math.nan
    leaves = [v.reshape((k,) + shape) for v, shape in zip(state.split(sizes, dim=1), shapes)]
    u1, a1 = (v.reshape(-1, F)[:n] for v in leaves[:2])
    gth = [g.reshape(-1, g.shape[-1])[:n] if i == 2 and row_bias else g
           for i, g in enumerate(leaves[2:])]
    return (u1, a1, gth, attempts) if counts else (u1, a1, gth)


# ---------------------------------------------------------- CUDA launches


def _widths(params):
    """``[F, H1, ..., F]``: the ODE network's input ``x`` width and the
    output width of each linear, from ``[W1_x, W1_te, b1, W2, b2, ...]``."""
    return [params[0].shape[1], params[0].shape[0], *(W.shape[0] for W in params[3::2])]


def _weights(widths, nf):
    """Floats of ``[W1_x, W1_te, b1, W2, b2, ...]`` for ``widths = [F, H1,
    ..., F]`` under ``nf`` frequencies."""
    return sum(o * (i + 1) for i, o in zip(widths[:-1], widths[1:])) + 2 * nf * widths[1]


def _fits_narrow(widths, nf):
    """Whether the narrow tier takes the network (the limits mirrored in
    ``csrc/cnf_fused.cu``)."""
    return (widths[0] <= _MAX_FEATURES and max(widths[1:-1], default=0) <= _MAX_WIDTH
            and len(widths) - 1 <= _MAX_LINEAR and nf <= _MAX_FREQS
            and _weights(widths, nf) <= _MAX_SHARED_FLOATS)


class ClusterPlan(NamedTuple):
    """How the density (K10) and the sampler (K11) take a call, from the
    shapes alone: the fields of
    :class:`~zuko_tpu_torch.ops._common.KernelPlan`, and for the narrow tier
    the blocks of a tile's cluster, the rows of a block, the exact trace's
    tangent columns a pass (none without a trace) and the block's shared
    memory."""

    wide: bool
    slots: int
    chunk_rows: int
    workspace_bytes: int
    desc_bytes: int
    cluster: int = 0
    block_rows: int = 0
    columns: int = 0
    shared_bytes: int = 0


#: Rows of a block of the cluster tier (``kDenRows``).
_DEN_BLOCK_ROWS = 64


def _cluster_tile(widths, exact):
    """``(rows a block, tangent columns a pass, shared floats)`` of the
    cluster tier of K10 and K11 (``density_plan`` in ``csrc/cnf_fused.cu``)
    under the trace ``exact`` (``True`` exact, ``False`` Hutchinson's,
    ``None`` none: K11 without log q): blocks of ``rb = min(TILE, 64)``
    rows, or 32 where 64 do not fit. Shared memory holds each linear's
    ``W^T [in][pad8(out)]``, the time-embedding term and the block max,
    then ``[slot][row]`` columns: with a trace ``3 F + 1`` (x, the stage
    inputs, the probe, l), ``7 (F + 1)`` stage slopes, ``pad8(widest
    hidden)`` activations, ``sum(hidden)`` ELU derivatives, ``F`` trace
    terms and ``pad8(widest hidden)`` tangent rows of ``nc rb`` columns, nc
    = F (exact) or 1 (Hutchinson), fewer where 227 KB cannot hold them;
    without one ``2 F`` (x, the stage inputs), ``7 F`` stage slopes and the
    activations alone. ``None`` where nothing fits."""
    F, hidden = widths[0], widths[1:-1]
    weights = sum(i * _pad8(o) for i, o in zip(widths[:-1], widths[1:]))
    hp = _pad8(max(hidden, default=0))
    for most in (_DEN_BLOCK_ROWS, _DEN_BLOCK_ROWS // 2):
        rb = min(TILE, most)
        if TILE % rb or rb & (rb - 1) or rb < 4 or TILE // rb > 8:
            continue
        if exact is None:
            floats = weights + _pad8(widths[1]) + _RED + (2 * F + 7 * F + hp) * rb
            if 4 * floats <= SHARED_BYTES:
                return rb, 0, floats
            continue
        base = (weights + _pad8(widths[1]) + _RED
                + (3 * F + 1 + 7 * (F + 1) + hp + sum(hidden) + F) * rb)
        for nc in range(F if exact else 1, 0, -1):
            if 4 * (base + hp * nc * rb) <= SHARED_BYTES:
                return rb, nc, base + hp * nc * rb
    return None


def plan_cnf(widths, nf, rows, exact=True):
    """The tier of the density (K10) and sampler (K11) kernels for a network
    of ``widths = [F, H1, ..., F]`` under ``nf`` frequencies and the trace
    the launch carries (``exact``: ``True`` the exact trace, ``False``
    Hutchinson's, ``None`` none, the sampler without log q), from the shapes
    alone: within the narrow limits the cluster tier, a
    :class:`ClusterPlan` of ``TILE / rb`` blocks of ``rb`` rows a tile, the
    tangent columns and the shared memory of :func:`_cluster_tile`; else, or
    where no tile fits, the wide tier with a workspace of ``3 F + 7 (F + 1)
    + sum(hidden) + 4 max(hidden)`` floats a row (the fields of ``Row`` in
    ``csrc/cnf_fused.cu``), in launches of whole tiles, and a descriptor
    buffer of the widths, offsets and frequencies."""
    F, hidden, n_lin = widths[0], widths[1:-1], len(widths) - 1
    if _fits_narrow(widths, nf):
        tile = _cluster_tile(widths, exact)
        if tile is not None:
            rb, nc, floats = tile
            return ClusterPlan(False, 0, rows, 0, 0, TILE // rb, rb, nc, 4 * floats)
    slots = 3 * F + 7 * (F + 1) + sum(hidden) + 4 * max(hidden, default=1)
    most = max(TILE, WORKSPACE_BYTES // (4 * slots) // TILE * TILE)
    chunk = min(most, max(TILE, -(-rows // TILE) * TILE))
    return ClusterPlan(True, slots, chunk, 4 * slots * chunk, 4 * (2 * n_lin + 1 + nf))


class AdjointPlan(NamedTuple):
    """How the adjoint kernel takes a call, from the shapes alone: the tier
    (``wide``), the floats a row in the workspace (``slots``), the rows of
    one launch (``chunk_rows``, whole tiles), the workspace's bytes and those
    of the wide tier's descriptor buffer; for the narrow tier also the
    blocks of a tile's cluster, the rows of a block, the block's shared
    memory, and whether the padded weights and the rows' columns lie in
    it."""

    wide: bool
    slots: int
    chunk_rows: int
    workspace_bytes: int
    desc_bytes: int
    cluster: int = 0
    block_rows: int = 0
    shared_bytes: int = 0
    weights_shared: bool = False
    rows_shared: bool = False


#: Rows of a block of the adjoint's narrow tier: a tile is a cluster of
#: ``TILE // 64`` blocks (``kAdjRows`` in ``csrc/cnf_fused.cu``).
_ADJ_BLOCK_ROWS = 64
_RED = 32  # floats of the block max (kRed)


def _pad8(v):
    return -(-v // 8) * 8


def plan_cnf_adjoint(widths, nf, rows, trace, row_bias):
    """The adjoint kernel's plan for a network of ``widths = [F, H1, ...,
    F]`` under ``nf`` frequencies, ``trace`` (``None``, exact ``True`` or
    Hutchinson ``False``) and a per-row first bias or not, from the shapes
    alone, in launches of whole tiles of :data:`TILE` rows, at most
    :data:`WORKSPACE_BYTES` (``adjoint_plan`` in ``csrc/cnf_fused.cu``).

    The narrow tier (within :func:`plan_cnf`'s limits): a tile is a cluster
    of ``TILE / rb`` blocks of ``rb = min(TILE, 64)`` rows. A block's shared
    memory holds the linears padded (``sum_l in_l pad8(out_l) + out_l
    pad8(in_l)`` floats), the time-embedding term (``pad8(H1)``) and the
    block max (32) when they fit in 227 KB, and then, if they fit too, the
    rows' columns: ``5 F + 4 sum(hidden) + 2 max(widths)`` floats a row at a
    stride of ``rb + 1``. The workspace: ``14 F`` floats a row (the stage
    slopes), ``3 H1`` more with a per-row first bias, the columns where
    shared memory does not hold them, and ``2 P`` floats a block (its
    increments and errors; ``P`` the parameters, the first bias apart when
    it comes per row).

    The wide tier: ``19 F + 4 sum(hidden) + 2 max(widths) + 3 H1`` floats
    a row (the columns of ``AdjointRow``) and, a tile, the increment and the
    error estimate of each parameter's accumulator (``2 P``) and for each
    linear the per-row vectors whose outer products sum to its gradient
    (``1 + F`` pairs a row with the exact trace, 2 with Hutchinson's, 1
    without a trace), and a descriptor buffer."""
    F, hidden, H1 = widths[0], widths[1:-1], widths[1]
    P = _weights(widths, nf) - (H1 if row_bias else 0)
    pairs = list(zip(widths[:-1], widths[1:]))
    if _fits_narrow(widths, nf):
        rb = min(TILE, _ADJ_BLOCK_ROWS)
        cluster = TILE // rb
        weights = sum(i * _pad8(o) + o * _pad8(i) for i, o in pairs)
        hot = 5 * F + 4 * sum(hidden) + 2 * max(widths)
        base = _pad8(H1) + _RED
        weights_shared = 4 * (weights + base) <= SHARED_BYTES
        rows_shared = weights_shared and 4 * (weights + base + hot * (rb + 1)) <= SHARED_BYTES
        shared = 4 * ((weights if weights_shared else 0) + base
                      + (hot * (rb + 1) if rows_shared else 0))
        slots = 14 * F + (3 * H1 if row_bias else 0) + (0 if rows_shared else hot)
        per_tile = slots * TILE + cluster * 2 * P
        most = max(1, WORKSPACE_BYTES // (4 * per_tile)) * TILE
        chunk = min(most, max(TILE, -(-rows // TILE) * TILE))
        return AdjointPlan(False, slots, chunk, 4 * per_tile * (chunk // TILE), 0, cluster, rb,
                           shared, weights_shared, rows_shared)
    slots = 19 * F + 4 * sum(hidden) + 2 * max(widths) + 3 * H1
    n_pairs = 1 + {None: 0, True: F, False: 1}[trace]
    per_tile = slots * TILE + 2 * P + TILE * n_pairs * sum(i + o for i, o in pairs)
    most = max(1, WORKSPACE_BYTES // (4 * per_tile)) * TILE
    chunk = min(most, max(TILE, -(-rows // TILE) * TILE))
    desc = 4 * (2 * (len(widths) - 1) + 1 + nf)
    return AdjointPlan(True, slots, chunk, 4 * per_tile * (chunk // TILE), desc)


def _padded_weights(kp):
    """The linears of the kernel parameters ``kp`` (``W1_x``, ``W2``, ...),
    each as ``W^T`` of shape ``(in, pad8(out))`` then ``W`` of shape
    ``(out, pad8(in))``, zero-padded, in one flat tensor: the adjoint's
    narrow tier reads a thread's eight outputs in two 16-byte loads."""
    parts = []
    for W in [kp[0], *kp[3::2]]:
        out, inp = W.shape
        parts += [Fn.pad(W.T, (0, _pad8(out) - out)).reshape(-1),
                  Fn.pad(W, (0, _pad8(inp) - inp)).reshape(-1)]
    return torch.cat(parts)


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
    plan = plan_cnf(widths, cfg["nf"], n, exact=trace)
    packed = torch.cat([p.detach().reshape(-1) for i, p in enumerate(params)
                        if not (i == 2 and row_bias)])
    # the cluster tier: the padded linears (the tile rows follow them)
    padded = None if plan.wide else _padded_weights([p.detach() for p in params])
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
            None if padded is None else padded.data_ptr(), TILE,
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


def _adjoint_kernel(x, a, glq, eps, kp, cfg):
    """Launch the adjoint kernel on ``x``, ``a (n, F)``, ``glq (n,)`` (or
    ``None``) and the kernel parameters ``kp``; returns ``u1``, ``a1`` and
    the parameter cotangents as :func:`_cnf_tile_adjoint_math` does."""
    from ._build import check_launch, load_library

    F, n = cfg["F"], x.shape[0]
    trace = None if glq is None else cfg["exact"]
    name = "cnf_adjoint" if glq is None else "cnf_adjoint_log_prob"
    for t, shape in ((x, (n, F)), (a, (n, F)), (glq, (n,)), (eps if trace is False else None,
                                                              (n, F))):
        if t is not None and (tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name}: expected contiguous tensors x, a (n, {F}), glq (n,),"
                             f" the Hutchinson probe (n, {F})")
    if trace is False and eps is None:
        raise ValueError(f"{name}: the Hutchinson trace needs a probe of shape (n, {F})")
    row_bias = kp[2].dim() == 2
    H1 = kp[0].shape[0]
    if row_bias and tuple(kp[2].shape) != (n, H1):
        raise ValueError(f"{name}: the per-row first bias must be (n, H1)")
    extra = [t for t in (glq, eps if trace is False else None) if t is not None]
    check_cuda_f32(name, [x, a, *kp, *extra])
    widths = _widths(kp)
    plan = plan_cnf_adjoint(widths, cfg["nf"], n, trace, row_bias)
    packed = torch.cat([p.reshape(-1) for i, p in enumerate(kp) if not (i == 2 and row_bias)])
    padded = None if plan.wide else _padded_weights(kp)
    tiles = -(-n // TILE)
    u1, a1 = torch.empty_like(x), torch.empty_like(x)
    g = torch.empty(tiles, packed.numel(), device=x.device, dtype=torch.float32)
    gb = torch.empty(n, H1, device=x.device, dtype=torch.float32) if row_bias else None
    work = torch.empty(plan.workspace_bytes // 4, device=x.device, dtype=torch.float32)
    desc = torch.empty(plan.desc_bytes, device=x.device, dtype=torch.uint8) if plan.wide else None
    c_widths = (ctypes.c_int * len(widths))(*widths)
    c_freqs = (ctypes.c_float * max(1, cfg["nf"]))(*cfg["freqs"])

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = load_library("cnf_fused")
    with torch.cuda.device(x.device):
        rc = lib.cnf_adjoint_f32(
            x.data_ptr(), a.data_ptr(), ptr(glq), ptr(eps if trace is False else None),
            ptr(kp[2] if row_bias else None), u1.data_ptr(), a1.data_ptr(), g.data_ptr(), ptr(gb),
            packed.data_ptr(), ptr(padded), ctypes.addressof(c_widths), len(widths) - 1,
            cfg["nf"], ctypes.addressof(c_freqs), cfg["atol"], cfg["rtol"], cfg["max_steps"],
            _TRACE_CODE[trace], n, TILE, int(plan.wide), work.data_ptr(), work.numel(),
            plan.chunk_rows, ptr(desc), plan.desc_bytes, torch.cuda.current_stream().cuda_stream,
        )
    check_launch(name, lib, "cnf_fused", rc)
    LAUNCHES[name + ("_wide" if plan.wide else "")] += 1
    gth, at = [], 0
    for i, p in enumerate(kp):
        if i == 2 and row_bias:
            gth.append(gb)
            continue
        gth.append(g[:, at: at + p.numel()].reshape((tiles,) + p.shape))
        at += p.numel()
    return u1, a1, gth


def cnf_adjoint(x, gx, glq, eps, params, c, cfg):
    r"""The continuous adjoint of CNF sampling at the samples ``x (n, F)``
    (counterpart of ``_cnf_adjoint_pallas`` :957): the ``cnf_adjoint``
    kernel (``cnf_adjoint_log_prob`` with a log-q cotangent ``glq (n,)``)
    for a CUDA tensor, :func:`_cnf_tile_adjoint_math` for a CPU tensor, with
    the cotangent ``gx (n, F)`` of ``x``, the Hutchinson probe ``eps (n, F)``
    (``None`` for the exact trace), the ODE network's ``params = [W, b, ...]``
    and the context ``c`` (``(C,)``, rows ``(n, C)`` or ``None``). The tile
    partials are summed here, ``W1``'s gradient is reassembled from its
    time-embedding, ``x`` and context columns, and the context's recovered
    from the folded first bias (:func:`_kernel_params`). Returns ``(u1, a1,
    {"w": [...], "b": [...], "c": ...})``: the re-integrated base draws, the
    cotangent of the draws (without the base term) and the parameters' and
    the context's cotangents."""
    with torch.no_grad():
        kp = [p.contiguous() for p in _kernel_params(params[0::2], params[1::2], c, cfg)]
        a = gx.to(x.dtype).contiguous()
        glq = None if glq is None else glq.to(x.dtype).contiguous()
        eps = None if eps is None else eps.contiguous()
        if x.is_cuda:
            u1, a1, gk = _adjoint_kernel(x.contiguous(), a, glq, eps, kp, cfg)
        else:
            u1, a1, gk = _cnf_tile_adjoint_math(x, a, glq, eps, kp, cfg)
        return u1, a1, _flat_cotangents(gk, params, c, cfg)


def _flat_cotangents(gk, params, c, cfg):
    """The cotangents of the kernel parameters (per tile, a per-row first
    bias per row; :func:`_cnf_tile_adjoint_math`) as those of the ODE
    network's ``params`` and of the context ``c`` (counterpart of
    :957-1101): the tiles summed, ``W1`` reassembled from its time-embedding,
    ``x`` and context columns, the context's recovered from the folded first
    bias (``W1_c^T gb1``, or per row ``gb1_rows W1_c``)."""
    row_bias = c is not None and c.dim() == 2
    g = [gi if i == 2 and row_bias else gi.sum(dim=0) for i, gi in enumerate(gk)]
    F, C, nf = cfg["F"], cfg["C"], cfg["nf"]
    gb1, cols, gc = g[2], [g[1], g[0]], None
    if C:
        W1_c = params[0][:, 2 * nf + F:]
        cx = c.to(gb1.dtype)
        if row_bias:
            cols.append(gb1.T @ cx)
            gc, gb1 = gb1 @ W1_c, gb1.sum(dim=0)
        else:
            cols.append(gb1[:, None] * cx[None, :])
            gc = W1_c.T @ gb1
    return {"w": [torch.cat(cols, dim=1), *g[3::2]], "b": [gb1, *g[4::2]], "c": gc}


#: The solve-consistency gate of the adjoint (counterpart of ``_REINT_ATOL``
#: :78): the largest gap allowed between the re-integrated base draw and
#: the saved one.
_REINT_ATOL = 1e-2


def _cnf_bwd_finish(z, eps, c, params, cfg, glq, u1, a1, gth):
    """The adjoint's tail (counterpart of ``_cnf_bwd_finish`` :1214): a row
    whose re-integrated ``u1`` misses its base draw ``z`` by more than
    :data:`_REINT_ATOL` NaN-poisons its ``dz``, and any such row every
    parameter and context gradient (the parameters' cotangents are sums over
    the rows); the base term ``dz = a1 - glq z`` of log q; a zero gradient
    for the probe. Returns ``(dz, deps, dc, [dW, db, ...])``."""
    zf = z.reshape(-1, cfg["F"])
    ok = (u1 - zf).abs().amax(dim=-1) <= _REINT_ATOL
    all_ok = ok.all()
    dz = torch.where(ok[:, None], a1, math.nan)
    if glq is not None:
        dz = dz - glq.reshape(-1).to(dz.dtype)[:, None] * zf
    dflat = []
    for W, b, p, q in zip(gth["w"], gth["b"], params[0::2], params[1::2]):
        dflat += [torch.where(all_ok, W, math.nan).to(p.dtype),
                  torch.where(all_ok, b, math.nan).to(q.dtype)]
    dc = None if gth["c"] is None else torch.where(all_ok, gth["c"], math.nan).to(c.dtype)
    return (dz.reshape(z.shape).to(z.dtype), None if eps is None else torch.zeros_like(eps), dc,
            dflat)


class _CnfRsample(torch.autograd.Function):
    """Differentiable CNF sampling (counterpart of ``_cnf_sample_op`` with
    ``_cnf_sample_fwd`` and ``_cnf_sample_bwd`` :946-1212): the forward is
    :func:`cnf_sample` (with log q when asked), the backward
    :func:`cnf_adjoint` followed by :func:`_cnf_bwd_finish`."""

    @staticmethod
    def forward(ctx, z, eps, cfg, want_log_prob, c, *params):
        out = cnf_sample(z, eps, params, c, cfg, want_log_prob)
        ctx.cfg, ctx.want_log_prob = cfg, want_log_prob
        ctx.save_for_backward(z, eps, c, out[0] if want_log_prob else out, *params)
        return out

    @staticmethod
    def backward(ctx, gx, glq=None):
        z, eps, c, x, *params = ctx.saved_tensors
        glq = glq if ctx.want_log_prob else None
        u1, a1, gth = cnf_adjoint(x, gx, glq, eps, params, c, ctx.cfg)
        dz, deps, dc, dflat = _cnf_bwd_finish(z, eps, c, params, ctx.cfg, glq, u1, a1, gth)
        return (dz, deps, None, None, dc, *dflat)


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


def fused_cnf_rsample(flat, sample_shape=(), c=None, generator=None, want_log_prob=False):
    r"""Differentiable :func:`fused_cnf_sample` (counterpart of
    ``fused_cnf_rsample`` :915 with ``_prep_cnf_sample`` :874): the same
    base draws, probe and forward (:func:`cnf_sample`), and as backward one
    continuous-adjoint integration per tile from the samples back to the
    base draws (:func:`cnf_adjoint`: the ``cnf_adjoint`` kernel on the card,
    its plain version on the CPU) with the solve-consistency gate of
    :func:`_cnf_bwd_finish`. Gradients flow to the ODE network's parameters,
    to the context and to nothing else (the base draws are fixed)."""
    params, probe, cfg = flat
    F, W = cfg["F"], params[0]
    cbatch = () if c is None else tuple(c.shape[:-1])
    shape = tuple(sample_shape) + cbatch + (F,)
    z = torch.randn(shape, generator=generator, device=W.device, dtype=W.dtype)
    eps = None if probe is None or not want_log_prob else probe(z).reshape(-1, F)
    if c is not None and c.dim() > 1:
        c = _rows(c, shape[:-1])
    out = _CnfRsample.apply(z.reshape(-1, F), eps, cfg, want_log_prob, c, *params)
    if want_log_prob:
        x, lq = out
        return x.reshape(shape), lq.reshape(shape[:-1])
    return out.reshape(shape)
