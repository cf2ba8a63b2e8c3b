r"""Differentiable fused sampling through the implicit function theorem.

Counterpart of ``zuko_tpu/ops/ift.py``: the NSF/MAF tier (:103-433 and
:815-842), the NAF tier (:436-641, monotone-network and UMNN layers) and the GF tier
(:653-803, at the end of this module).
``rsample`` / ``rsample_and_log_prob`` do not differentiate through the
autoregressive solve:

* **forward**: the sampling kernel (:func:`..nsf_fused.nsf_sample`, not
  differentiable) solves :math:`x = T^{-1}(z; \phi)`, optionally with the
  fused :math:`\log q(x)` or (raw mode) the bare sum of forward
  log-Jacobians;
* **backward**: by the implicit function theorem on :math:`T(x; \phi) = z`,

  .. math::
     \bar z = J^{-\top} \bar x, \qquad
     \bar\phi = -(\partial T / \partial\phi)^{\top} J^{-\top} \bar x,

  where :math:`J = \partial T / \partial x` is triangular by
  autoregressivity, with the univariate derivatives on its diagonal. Per
  layer the transposed system :math:`J_l^\top u = v` is solved by the
  nilpotent fixed-point iteration :math:`u \leftarrow (v - (J_l^\top - D)
  u) / d`, exact after ``passes`` iterations for the same reason the forward
  sweeps are. With a log-density output its cotangent is folded in exactly:
  :math:`\log q = \ell(x(\phi, z), \phi)`, so :math:`\bar\phi` gains
  :math:`\bar L\,\partial\ell/\partial\phi` and :math:`v = \bar x + \bar
  L\,\partial\ell/\partial x` feeds the same solves.

The backward is not a kernel (``_ift_bwd`` :224 is not either): it is
autograd over the plain per-layer functions of
:mod:`zuko_tpu_torch.ops.nsf_fused`, each layer's graph kept alive across
the three sweeps.
"""

from __future__ import annotations

import itertools

import torch

from . import gf_fused as gf
from . import naf_fused as naf
from . import nsf_fused as nf

__all__ = [
    "fused_gf_rsample",
    "fused_gf_rsample_and_log_prob",
    "fused_naf_rsample",
    "fused_naf_rsample_and_log_prob",
    "fused_nsf_inverse_and_ladj",
    "fused_nsf_rsample",
    "fused_nsf_rsample_and_log_prob",
]

# The implicit function theorem needs T(x) = z at the solved point. Rows
# whose reconstruction misses z by more than this get zero cotangent: a
# failed solve has no meaningful pathwise gradient. The closed-form inverses
# (rqs, affine) never trip it, their out-of-domain branch being an exact
# identity; it stands guard for the iterative families: a GF's bisection
# pegs at its bracket for tail targets the saturated erf mixture cannot reach.
_SOLVE_ATOL = 1e-2


# A MADE's hidden ReLUs have a kink at 0. At a row whose pre-activation lies
# within float32 rounding of it, the float32 march can take the other side
# than the exact function at the same root, and the row's parameter term
# then comes from the other branch; a reverse-KL gradient, whose rows' terms
# cancel, shows it (on an H100, a BPF flagship row whose unit lay 8.3e-9
# above 0 in float64 and 2.5e-7 below it in float32 moved an element whose
# terms cancel 45-fold: chip_smoke.py phase 15). The float32 march keeps a
# pre-activation within a quarter of _KINK_RTOL of its scale |b| + |W| |a|
# of float64's (tests/test_torch_ift_kinks.py holds it on the flagships).
# So a float32 backward finds the rows with one within _KINK_RTOL of its
# scale of 0 as it marches (about 5% of the flagships' rows), marches them
# through the flow once in float64 and takes their ReLUs' sides from there.
# The arithmetic stays float32.
_KINK_RTOL = 1e-4


def _made_near(xc, linears, near):
    """The MADE ``linears`` (``[(M ⊙ W, b), ...]``, the last without a ReLU)
    on ``xc``, without gradients. Where ``near`` (``(n,)`` bool) is given,
    marks in it the rows at which a hidden pre-activation lies within
    ``_KINK_RTOL`` of its scale ``|b| + |W| |a|`` of 0."""
    with torch.no_grad():
        h = xc
        for W, b in linears[:-1]:
            z = torch.addmm(b, h, W.T)
            if near is not None:
                scale = torch.addmm(b.abs(), h.abs(), W.abs().T)
                near |= (z.abs() < _KINK_RTOL * scale).any(dim=1)
            h = torch.relu(z)
        W, b = linears[-1]
        return torch.addmm(b, h, W.T)


def _made_and_sides(xc, linears):
    """The MADE ``linears`` on ``xc``: its output and each hidden ReLU's
    side (``z > 0``)."""
    h, sides = xc, []
    for W, b in linears[:-1]:
        z = torch.addmm(b, h, W.T)
        sides.append(z > 0)
        h = torch.relu(z)
    W, b = linears[-1]
    return torch.addmm(b, h, W.T), sides


def _made_sided(xc, linears, kinks):
    """The MADE ``linears`` on ``xc``, differentiable, each hidden ReLU as
    ``z (z > 0)``, but at the rows of ``kinks = (rows, sides)`` (from
    :func:`_kinks`, or ``None``) on the sides given."""
    h = xc
    for i, (W, b) in enumerate(linears):
        z = torch.addmm(b, h, W.T)
        if i < len(linears) - 1:
            on = z > 0
            if kinks is not None:
                on = on.index_put((kinks[0],), kinks[1][i])
            z = z * on.to(z.dtype)
        h = z
    return h


def _kinks(near, sides64):
    """Per autoregressive layer, ``(rows, sides)``: the rows marked in
    ``near`` (one host sync) and their hidden ReLUs' sides ``sides64(rows)``
    on the float64 march; ``None`` for each where there are none."""
    rows = None if near is None else near.nonzero()[:, 0]
    if rows is None or rows.numel() == 0:
        return itertools.repeat(None)
    with torch.no_grad():
        return [(rows, sides) for sides in sides64(rows)]


def _nsf_sides64(x, c, params, layout, F, K, bound, slope, univ):
    """Per autoregressive layer (``nf._stages``), the hidden ReLUs' sides of
    its MADE on the float64 march from the roots ``x`` with context ``c``."""
    x64, c64, out = x.double(), c.double(), []
    for stage in nf._stages([p.double() for p in params], layout):
        if stage[0] == "softclip":
            x64 = nf._softclip(x64, stage[1])[0]
        else:
            h, sides = _made_and_sides(torch.cat([x64, c64], dim=1), _linears(stage[0]))
            x64 = nf._univ_forward(x64, h, F, K, bound, slope, univ, ladj=False)[0]
            out.append(sides)
    return out


def _naf_sides64(x, c, params, layout, F, S):
    """:func:`_nsf_sides64` over NAF stages (``naf._stages``)."""
    x64, c64, out = x.double(), c.double(), []
    for entry, made, mono_w, mono_b in naf._stages([p.double() for p in params], layout):
        if entry[0] == "softclip":
            x64 = naf._softclip(x64, entry[1])[0]
        else:
            h, sides = _made_and_sides(torch.cat([x64, c64], dim=1),
                                       list(zip(made[0::2], made[1::2])))
            shift, pre1, w1x = naf._univariates(h, entry[4], mono_w, mono_b, F, S)
            if entry[4] == "umnn":
                y = naf._umnn(x64, pre1, w1x, mono_w, mono_b, naf._UMNN_FINE_N)
            else:
                y = naf._mono(x64, pre1, w1x, mono_w, mono_b)
            x64 = y + shift
            out.append(sides)
    return out


def _linears(ps):
    """``[(M ⊙ W, b), ...]`` of an NSF-tier MADE's ``[W, b, M, ...]``."""
    return [(M * W, b) for W, b, M in zip(*[iter(ps)] * 3)]


def _solve_consistency_mask(zhat, z, xbar, lbar, atol=_SOLVE_ATOL):
    """Zero the cotangents of the rows where the marched forward ``zhat (n,
    F)`` misses the target ``z``. Returns the masked ``(xbar (n, F), lbar
    (n, 1) or None)``."""
    ok = ((zhat - z).abs().amax(dim=1, keepdim=True) < atol).to(zhat.dtype)
    return xbar * ok, None if lbar is None else lbar[:, None] * ok


def _ift_bwd_math(zc, x, xbar, lbar, params, needs, layout, F, K, bound, slope,
                  univ, base=nf._NORMAL, raw=False):
    """The IFT backward on flat rows (counterpart of ``_ift_bwd_math``
    :238): cotangents ``xbar (n, F)`` and ``lbar (n,)`` (or ``None``, no
    log-density cotangent) -> ``(dzc (n, F + C), dparams)``, with ``None``
    in ``dparams`` where ``needs`` is false (the masks).

    Three sweeps share one linearisation per layer. Each layer splits as
    ``y = S(x, h)``, ``h = H(x, c)``: ``S`` is the univariate map, diagonal
    in ``x`` at fixed ``h`` (feature ``f`` reads ``x_f`` and ``h[f * T : (f
    + 1) * T]`` only), ``H`` the masked hyper-net. A softclip is diagonal
    and has no parameters.

    1. **march**: ``x_l = T_l(x_{l-1})``, keeping each stage's graphs, the
       diagonal ``d = dy/dx`` at fixed ``h`` and ``G[f * T + t] = dy_f /
       dh_{f, t}`` (one pullback of ones gives both);
    2. **density backward** (with ``lbar``): ``g_l = d(lbar · log q) /
       dx_l`` runs from the base back through the same graphs; the box base
       is flat inside, so its cotangent is zero, as the raw mode's is;
    3. **solves**: ``v = xbar + g_0`` chains through ``u = v / d`` per
       softclip and one transposed triangular solve per layer, ``Jᵀu = d·u +
       H'(x)ᵀ(G ⊙ repeat(u))`` (the hyper outputs are feature-major, so
       ``u`` repeats ``T`` times per feature), and each layer takes one
       merged parameter pullback with cotangents ``(g_l - u_l, lbar)``."""
    z, c = zc[:, :F], zc[:, F:].detach().requires_grad_(zc.shape[1] > F)
    T = nf._univ_size(univ, K)
    dparams = [None] * len(params)
    # the rows near a MADE's kink, marked as a float32 backward marches
    near = torch.zeros_like(x[:, 0], dtype=torch.bool) if x.dtype == torch.float32 else None

    def grad(outputs, inputs, cotangents):
        return torch.autograd.grad(outputs, inputs, cotangents, retain_graph=True)

    with torch.enable_grad():
        # ---- sweep 1: march and linearise
        recs = []
        xcur = x.detach()
        for stage in nf._stages(list(params), layout):
            xs = xcur.detach().requires_grad_(True)
            if stage[0] == "softclip":
                y, ladj = nf._softclip(xs, stage[1])
                (d,) = grad(y, xs, torch.ones_like(y))
                recs.append((None, None, None, None, xs, None, y, ladj, d, None))
            else:
                ps = [p.detach().requires_grad_(i % 3 != 2) for i, p in enumerate(stage[0])]
                xh = xcur.detach().requires_grad_(True)
                hs = _made_near(torch.cat([xcur, c.detach()], dim=1), _linears(ps), near)
                hs.requires_grad_(True)
                y, ladj = nf._univ_forward(xs, hs, F, K, bound, slope, univ)
                d, G = grad(y, (xs, hs), torch.ones_like(y))
                recs.append([ps, stage[1], xh, None, xs, hs, y, ladj, d, G])
            xcur = y.detach()

        # each MADE's graph, its ReLUs at the rows near a kink on float64's sides
        kinks = _kinks(near, lambda rows: _nsf_sides64(
            x[rows], c[rows], params, layout, F, K, bound, slope, univ))
        for rec, k in zip([r for r in recs if r[0] is not None], kinks):
            rec[3] = _made_sided(torch.cat([rec[2], c], dim=1), _linears(rec[0]), k)

        # rows whose solve failed contribute nothing
        xbar, lrow = _solve_consistency_mask(xcur, z, xbar, lbar)

        # ---- sweep 2: g_out[i], the log-density cotangent at stage i's output
        g_out = [None] * len(recs)
        v = xbar
        if lrow is not None:
            # raw mode: lbar is the cotangent of the bare sum of ladjs; a
            # box base is flat: zero, as zuko_tpu (ift.py:351-354)
            g = torch.zeros_like(xcur) if raw or base[0] != "normal" else -xcur * lrow
            for i in reversed(range(len(recs))):
                g_out[i] = g
                _, _, xh, h, xs, hs, y, ladj, _, _ = recs[i]
                if h is None:
                    (g,) = grad((y, ladj), xs, (g, lrow.expand_as(ladj)))
                    continue
                gxs, gh = grad((y, ladj), (xs, hs), (g, lrow.expand_as(ladj)))
                (gxh,) = grad(h, xh, gh)
                g = gxs + gxh
            v = xbar + g

        # ---- sweep 3: triangular solves and merged parameter pullbacks
        dc = torch.zeros_like(c)
        idx = 0
        for i, (ps, passes, xh, h, xs, hs, y, ladj, d, G) in enumerate(recs):
            # d is the autodiff diagonal, used for the division and (inside
            # J) for the application alike; the first iteration, from u = 0,
            # is v / d, and min(passes, F) in all are exact by nilpotency
            u = v / d
            if ps is None:  # a softclip: diagonal, no parameters
                v = u
                continue
            for _ in range(min(passes, F) - 1):
                (lower,) = grad(h, xh, G * u.repeat_interleave(T, dim=1))
                u = (v - lower) / d

            # (dT_l/dphi)ᵀ (g_l - u_l) + lbar · dladj_l/dphi, context included
            ycot = -u if g_out[i] is None else g_out[i] - u
            lcot = torch.zeros_like(ladj) if lrow is None else lrow.expand_as(ladj)
            (gh,) = grad((y, ladj), hs, (ycot, lcot))
            wanted = [j for j, p in enumerate(ps) if p.requires_grad and needs[idx + j]]
            wrt = [ps[j] for j in wanted] + ([c] if c.requires_grad else [])
            grads = iter(grad(h, wrt, gh) if wrt else ())
            for j in wanted:
                dparams[idx + j] = next(grads)
            if c.requires_grad:
                dc = dc + next(grads)
            idx += len(ps)
            v = u

    return torch.cat([v, dc], dim=1), dparams


class _IFTFunction(torch.autograd.Function):
    """The sampling kernel forward, the IFT backward (counterpart of
    ``_ift_op`` :151). ``want_log_prob`` is ``False`` (``x``), ``True``
    (``x, log q``) or ``"raw"`` (``x``, bare sum of forward ladjs).
    Differentiable once."""

    @staticmethod
    def forward(ctx, zc, statics, want_log_prob, *params):
        out = nf.nsf_sample(zc, params, *statics, want_log_prob=want_log_prob)
        ctx.statics, ctx.want_log_prob = statics, want_log_prob
        ctx.save_for_backward(zc, out[0] if want_log_prob else out, *params)
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    def backward(ctx, xbar, lbar=None):
        zc, x, *params = ctx.saved_tensors
        if xbar is None:
            xbar = torch.zeros_like(x)
        dzc, dparams = _ift_bwd_math(
            zc, x, xbar, lbar, params, ctx.needs_input_grad[3:], *ctx.statics,
            raw=ctx.want_log_prob == "raw",
        )
        return (dzc if ctx.needs_input_grad[0] else None, None, None, *dparams)


def _ift(zc, flat, F, want_log_prob):
    params, layout, cfg = flat
    return _IFTFunction.apply(zc, (layout, *nf._statics(cfg, F)), want_log_prob, *params)


def fused_nsf_rsample(flat, sample_shape=(), c=None, generator=None,
                      want_log_prob: bool = False):
    r"""Differentiable fused sampling, with ``flat = _flatten_flow(flow)``:
    the sampling kernel forward and the implicit-function-theorem backward
    (see the module docstring). The values are those of
    :func:`..nsf_fused.fused_nsf_sample` for the same generator state; the
    gradients match differentiating the unfused inverse sweeps. With
    ``want_log_prob`` also returns the equally differentiable ``log q(x)``,
    the reverse-KL pair."""
    shape, zc = nf._base_draws(flat, sample_shape, c, generator, flat[2]["base"])
    out = _ift(zc, flat, shape[-1], want_log_prob)
    if want_log_prob:
        x, lq = out
        return x.reshape(shape), lq.reshape(shape[:-1])
    return out.reshape(shape)


def fused_nsf_rsample_and_log_prob(flat, sample_shape=(), c=None, generator=None):
    return fused_nsf_rsample(flat, sample_shape, c, generator, want_log_prob=True)


def fused_nsf_inverse_and_ladj(flat, x, c=None):
    r"""Differentiable fused inverse at arbitrary targets: ``(u, sum of
    forward ladjs at u)`` with ``u = T^{-1}(x)``, through the sampling
    kernel's raw mode and the raw-mode IFT backward (no base term). It is
    what the density of an inverted flow is made of: ``log_prob'(x) =
    base(u) - sum_ladj``."""
    F = x.shape[-1]
    batch, xc = nf._with_context(x, c)
    u, ladj = _ift(xc, flat, F, "raw")
    return u.reshape(batch + (F,)), ladj.reshape(batch)


# ----------------------------------------------------------------- NAF tier
#
# The NSF tier's three sweeps over NAF and UNAF stages. An autoregressive
# layer splits as y = S(x, h), h = H(x, c): S is every feature's monotone
# network (or UMNN integral plus constant), diagonal in x at fixed h, and it
# has parameters of its own (the networks' weights); h's outputs [f * T, (f +
# 1) * T) feed feature f only (feature-major, so u repeats T times per
# feature; T = S, or S + 1 with a UMNN's constant). A softclip is diagonal
# and has none. The solved roots carry the solver's tolerance (about 1e-6),
# so the gradients match differentiating the unfused solve to that, not to
# roundoff; a UMNN's d = dy/dx is that of its GL-16 integral, as in
# zuko_tpu.


def _naf_ift_bwd_math(zc, x, xbar, lbar, params, needs, layout, F, S):
    """The IFT backward over NAF stages (counterpart of ``_naf_ift_bwd_math``
    :501): cotangents ``xbar (n, F)`` and ``lbar (n,)`` (or ``None``) ->
    ``(dzc (n, F + C), dparams)``, with ``None`` in ``dparams`` where
    ``needs`` is false. The sweeps of :func:`_ift_bwd_math`:

    1. **march** from the solved ``x`` through every stage, keeping each
       stage's graphs, its diagonal ``d = dy/dx`` at fixed ``h`` and, for an
       autoregressive layer, ``G = dy/dh``;
    2. **density backward** (with ``lbar``): ``g_l = d(lbar · log q) / dx_l``
       from the base back;
    3. **solves**: ``u = v / d`` for a softclip; for an autoregressive layer
       the nilpotent iteration ``u = (v - H'(x)ᵀ(G ⊙ repeat(u))) / d``, then
       one merged pullback with cotangents ``(g_l - u_l, lbar)`` to the
       monotone networks' parameters, the MADE's and the context."""
    z, c = zc[:, :F], zc[:, F:].detach().requires_grad_(zc.shape[1] > F)
    dparams = [None] * len(params)
    near = torch.zeros_like(x[:, 0], dtype=torch.bool) if x.dtype == torch.float32 else None

    def grad(outputs, inputs, cotangents):
        return torch.autograd.grad(outputs, inputs, cotangents, retain_graph=True)

    with torch.enable_grad():
        # ---- sweep 1: march and linearise
        recs, idx = [], 0
        xcur = x.detach()
        for entry, made, mono_w, mono_b in naf._stages(list(params), layout):
            xs = xcur.detach().requires_grad_(True)
            if entry[0] == "softclip":
                y, ladj = naf._softclip(xs, entry[1])
                (d,) = grad(y, xs, torch.ones_like(y))
                recs.append((entry, None, xs, y, ladj, d))
            else:
                count = len(made) + 2 * len(mono_w)
                ps = [p.detach().requires_grad_(needs[idx + j])
                      for j, p in enumerate(made + mono_w + mono_b)]
                xh = xcur.detach().requires_grad_(True)
                linears = list(zip(ps[: len(made): 2], ps[1: len(made): 2]))
                hs = _made_near(torch.cat([xcur, c.detach()], dim=1), linears, near)
                hs.requires_grad_(True)
                mono = ps[len(made):]
                y, ladj = naf._ar_layer(
                    xs, hs, entry[4], mono[: len(mono_w)], mono[len(mono_w):], F, S)
                d, G = grad(y, (xs, hs), torch.ones_like(y))
                recs.append((entry, [idx, ps, len(made), xh, None, hs, G], xs, y, ladj, d))
                idx += count
            xcur = y.detach()

        # each MADE's graph, its ReLUs at the rows near a kink on float64's sides
        kinks = _kinks(near, lambda rows: _naf_sides64(x[rows], c[rows], params, layout, F, S))
        for ar, k in zip([rec[1] for rec in recs if rec[1] is not None], kinks):
            _, ps, n_made, xh = ar[:4]
            ar[4] = _made_sided(torch.cat([xh, c], dim=1),
                                list(zip(ps[:n_made:2], ps[1:n_made:2])), k)

        # rows whose solve failed contribute nothing
        xbar, lrow = _solve_consistency_mask(xcur, z, xbar, lbar)

        # ---- sweep 2: g_out[i], the log-density cotangent at stage i's output
        g_out = [None] * len(recs)
        v = xbar
        if lrow is not None:
            g = -xcur * lrow  # the standard-normal base
            for i in reversed(range(len(recs))):
                g_out[i] = g
                _, ar, xs, y, ladj, _ = recs[i]
                if ar is None:
                    (g,) = grad((y, ladj), xs, (g, lrow.expand_as(ladj)))
                else:
                    _, _, _, xh, h, hs, _ = ar
                    gxs, gh = grad((y, ladj), (xs, hs), (g, lrow.expand_as(ladj)))
                    (gxh,) = grad(h, xh, gh)
                    g = gxs + gxh
            v = xbar + g

        # ---- sweep 3: triangular solves and merged parameter pullbacks
        dc = torch.zeros_like(c)
        for i, (entry, ar, xs, y, ladj, d) in enumerate(recs):
            u = v / d
            if ar is not None:
                idx, ps, n_made, xh, h, hs, G = ar
                # min(passes, F) iterations in all are exact by nilpotency
                for _ in range(min(entry[3], F) - 1):
                    (lower,) = grad(h, xh, G * u.repeat_interleave(G.shape[1] // F, dim=1))
                    u = (v - lower) / d
                ycot = -u if g_out[i] is None else g_out[i] - u
                lcot = torch.zeros_like(ladj) if lrow is None else lrow.expand_as(ladj)
                mono = [j for j in range(n_made, len(ps)) if ps[j].requires_grad]
                gh, *gmono = grad((y, ladj), [hs] + [ps[j] for j in mono], (ycot, lcot))
                for j, gj in zip(mono, gmono):
                    dparams[idx + j] = gj
                made = [j for j in range(n_made) if ps[j].requires_grad]
                wrt = [ps[j] for j in made] + ([c] if c.requires_grad else [])
                grads = iter(grad(h, wrt, gh) if wrt else ())
                for j in made:
                    dparams[idx + j] = next(grads)
                if c.requires_grad:
                    dc = dc + next(grads)
            v = u

    return torch.cat([v, dc], dim=1), dparams


class _NAFIFTFunction(torch.autograd.Function):
    """The NAF sampling kernel forward, the IFT backward (counterpart of
    ``_naf_ift_op`` :473). Differentiable once."""

    @staticmethod
    def forward(ctx, zc, statics, want_log_prob, *params):
        out = naf.naf_sample(zc, params, *statics, want_log_prob)
        ctx.statics = statics
        ctx.save_for_backward(zc, out[0] if want_log_prob else out, *params)
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    def backward(ctx, xbar, lbar=None):
        zc, x, *params = ctx.saved_tensors
        if xbar is None:
            xbar = torch.zeros_like(x)
        dzc, dparams = _naf_ift_bwd_math(
            zc, x, xbar, lbar, params, ctx.needs_input_grad[3:], *ctx.statics)
        return (dzc if ctx.needs_input_grad[0] else None, None, None, *dparams)


def fused_naf_rsample(flat, sample_shape=(), c=None, generator=None,
                      want_log_prob: bool = False):
    r"""Differentiable fused NAF sampling, with ``flat =
    _flatten_naf(flow)`` (counterpart of ``fused_naf_rsample`` :449): the
    sampling kernel forward (:func:`..naf_fused.naf_sample`) and the
    implicit-function-theorem backward. The values are those of
    :func:`..naf_fused.fused_naf_sample` for the same generator state. With
    ``want_log_prob`` also returns the equally differentiable ``log q(x)``,
    the reverse-KL pair."""
    shape, zc = nf._base_draws(flat, sample_shape, c, generator)
    params, layout, F, S = flat
    out = _NAFIFTFunction.apply(zc, (layout, F, S), want_log_prob, *params)
    if want_log_prob:
        x, lq = out
        return x.reshape(shape), lq.reshape(shape[:-1])
    return out.reshape(shape)


def fused_naf_rsample_and_log_prob(flat, sample_shape=(), c=None, generator=None):
    return fused_naf_rsample(flat, sample_shape, c, generator, want_log_prob=True)


# ------------------------------------------------------------------ GF tier
#
# Gaussianization flows are the easy case: every layer is either an
# element-wise erf mixture (a diagonal Jacobian, so the triangular solve is
# one division) or an orthogonal rotation (J^-T v = R v). No iteration.


def _gf_ift_bwd_math(z, x, xbar, lbar, params, needs, layout, F):
    """The IFT backward over GF stages (counterpart of ``_gf_ift_bwd_math``
    :716): cotangents ``xbar (n, F)`` and ``lbar (n,)`` (or ``None``) ->
    ``(dz (n, F), dparams)``, with ``None`` in ``dparams`` where ``needs`` is
    false. Per-row parameters are inputs like the others, so their
    cotangents come back per row. The three sweeps of the NSF tier, each
    layer's graph kept alive across them:

    1. **march** ``x_l = T_l(x_{l-1})`` from the solved ``x``;
    2. **density backward** (with ``lbar``): ``g_l = d(lbar · log q) / dx_l``
       from the base back;
    3. **solves**: ``v = xbar + g_0`` goes through ``u = v / exp(ladj)`` per
       layer and ``u = R v`` per rotation, and each stage takes one parameter
       pullback with cotangents ``(g_l - u_l, lbar)``; a rotation's is
       ``(g_l - u_l)ᵀ x_{l-1}``."""
    dparams = [None] * len(params)

    def grad(outputs, inputs, cotangents):
        return torch.autograd.grad(outputs, inputs, cotangents, retain_graph=True)

    with torch.enable_grad():
        recs, idx = [], 0
        xcur = x.detach()
        for kind, tensors in gf._stages(list(params), layout):
            if kind == "rot":
                recs.append((kind, idx, tensors[0].detach(), xcur))
                xcur = xcur @ tensors[0].detach().T
            else:
                ps = [t.detach().requires_grad_(needs[idx + i]) for i, t in enumerate(tensors)]
                xs = xcur.requires_grad_(True)
                y, ladj = gf._gauss_forward(xs, *ps)
                recs.append((kind, idx, ps, xs, y, ladj))
                xcur = y.detach()
            idx += len(tensors)

        # rows whose solve pegged contribute nothing
        xbar, lrow = _solve_consistency_mask(xcur, z, xbar, lbar)

        g_out = [None] * len(recs)
        v = xbar
        if lrow is not None:
            g = -xcur * lrow  # the standard-normal base
            for i in reversed(range(len(recs))):
                g_out[i] = g
                if recs[i][0] == "rot":
                    g = g @ recs[i][2]  # Rᵀ g; |det R| = 1, no lbar term
                else:
                    _, _, _, xs, y, ladj = recs[i]
                    (g,) = grad((y, ladj), xs, (g, lrow.expand_as(ladj)))
            v = xbar + g

        for i, rec in enumerate(recs):
            if rec[0] == "rot":
                _, idx, R, xin = rec
                u = v @ R.T  # J^-T v = R v
                if needs[idx]:
                    ycot = -u if g_out[i] is None else g_out[i] - u
                    dparams[idx] = ycot.T @ xin
            else:
                _, idx, ps, xs, y, ladj = rec
                u = v / torch.exp(ladj.detach())
                wrt = [p for p in ps if p.requires_grad]
                if wrt:
                    ycot = -u if g_out[i] is None else g_out[i] - u
                    lcot = torch.zeros_like(ladj) if lrow is None else lrow.expand_as(ladj)
                    grads = iter(grad((y, ladj), wrt, (ycot, lcot)))
                    for j, p in enumerate(ps):
                        if p.requires_grad:
                            dparams[idx + j] = next(grads)
            v = u
    return v, dparams


class _GFIFTFunction(torch.autograd.Function):
    """The GF sampling kernel forward, the IFT backward (counterpart of
    ``_gf_ift_op`` :690). Differentiable once."""

    @staticmethod
    def forward(ctx, z, statics, want_log_prob, *params):
        out = gf.gf_sample(z, params, *statics, want_log_prob)
        ctx.statics = statics
        ctx.save_for_backward(z, out[0] if want_log_prob else out, *params)
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    def backward(ctx, xbar, lbar=None):
        z, x, *params = ctx.saved_tensors
        if xbar is None:
            xbar = torch.zeros_like(x)
        dz, dparams = _gf_ift_bwd_math(
            z, x, xbar, lbar, params, ctx.needs_input_grad[3:], *ctx.statics)
        return (dz if ctx.needs_input_grad[0] else None, None, None, *dparams)


def fused_gf_rsample(flat, sample_shape=(), generator=None, want_log_prob: bool = False):
    r"""Differentiable fused GF sampling, with ``flat = _flatten_gf(flow,
    c)``: the sampling kernel forward (:func:`..gf_fused.gf_sample`) and an
    implicit-function-theorem backward of diagonal solves and rotation
    products. The values are those of :func:`..gf_fused.fused_gf_sample` for
    the same generator state. With ``want_log_prob`` also returns the equally
    differentiable ``log q(x)``, the reverse-KL pair."""
    shape, z, params = gf._gf_prep_sample(flat, sample_shape, generator)
    out = _GFIFTFunction.apply(z, flat[1:3], want_log_prob, *params)
    if want_log_prob:
        x, lq = out
        return x.reshape(shape), lq.reshape(shape[:-1])
    return out.reshape(shape)


def fused_gf_rsample_and_log_prob(flat, sample_shape=(), generator=None):
    return fused_gf_rsample(flat, sample_shape, generator, want_log_prob=True)
