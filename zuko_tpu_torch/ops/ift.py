r"""Differentiable fused sampling through the implicit function theorem.

Counterpart of ``zuko_tpu/ops/ift.py`` (the NSF/MAF tier, :103-433 and
:815-842). ``rsample`` / ``rsample_and_log_prob`` do not differentiate
through the autoregressive solve:

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
the three sweeps. The NAF and GF tiers of ``zuko_tpu/ops/ift.py`` come with
their families.
"""

from __future__ import annotations

import torch

from . import nsf_fused as nf

__all__ = [
    "fused_nsf_inverse_and_ladj",
    "fused_nsf_rsample",
    "fused_nsf_rsample_and_log_prob",
]

# The implicit function theorem needs T(x) = z at the solved point. Rows
# whose reconstruction misses z by more than this get zero cotangent: a
# failed solve has no meaningful pathwise gradient. The closed-form inverses
# (rqs, affine) never trip it, their out-of-domain branch being an exact
# identity; it stands guard for the iterative families.
_SOLVE_ATOL = 1e-2


def _solve_consistency_mask(zhat, z, xbar, lbar, atol=_SOLVE_ATOL):
    """Zero the cotangents of the rows where the marched forward ``zhat (n,
    F)`` misses the target ``z``. Returns the masked ``(xbar (n, F), lbar
    (n, 1) or None)``."""
    ok = ((zhat - z).abs().amax(dim=1, keepdim=True) < atol).to(zhat.dtype)
    return xbar * ok, None if lbar is None else lbar[:, None] * ok


def _ift_bwd_math(zc, x, xbar, lbar, params, needs, layout, F, K, bound, slope,
                  univ, raw=False):
    """The IFT backward on flat rows (counterpart of ``_ift_bwd_math``
    :238): cotangents ``xbar (n, F)`` and ``lbar (n,)`` (or ``None``, no
    log-density cotangent) -> ``(dzc (n, F + C), dparams)``, with ``None``
    in ``dparams`` where ``needs`` is false (the masks).

    Three sweeps share one linearisation per layer. Each layer splits as
    ``y = S(x, h)``, ``h = H(x, c)``: ``S`` is the univariate map, diagonal
    in ``x`` at fixed ``h`` (feature ``f`` reads ``x_f`` and ``h[f * T : (f
    + 1) * T]`` only), ``H`` the masked hyper-net.

    1. **march**: ``x_l = T_l(x_{l-1})``, keeping each layer's two graphs,
       the diagonal ``d = dy/dx`` at fixed ``h`` and ``G[f * T + t] = dy_f /
       dh_{f, t}`` (one pullback of ones gives both);
    2. **density backward** (with ``lbar``): ``g_l = d(lbar · log q) /
       dx_l`` runs from the base back through the same graphs;
    3. **solves**: ``v = xbar + g_0`` chains through one transposed
       triangular solve per layer, ``Jᵀu = d·u + H'(x)ᵀ(G ⊙ repeat(u))``
       (the hyper outputs are feature-major, so ``u`` repeats ``T`` times
       per feature), and each layer takes one merged parameter pullback with
       cotangents ``(g_l - u_l, lbar)``."""
    z, c = zc[:, :F], zc[:, F:].detach().requires_grad_(zc.shape[1] > F)
    T = nf._univ_size(univ, K)
    per_layer = nf._split_layers(list(params), layout)
    dparams = [None] * len(params)

    def grad(outputs, inputs, cotangents):
        return torch.autograd.grad(outputs, inputs, cotangents, retain_graph=True)

    with torch.enable_grad():
        # ---- sweep 1: march and linearise
        recs = []
        xcur = x.detach()
        for ps, passes in per_layer:
            ps = [p.detach().requires_grad_(i % 3 != 2) for i, p in enumerate(ps)]
            xh = xcur.requires_grad_(True)
            h = nf._hyper(torch.cat([xh, c], dim=1), ps)
            xs, hs = xcur.detach().requires_grad_(True), h.detach().requires_grad_(True)
            y, ladj = nf._univ_forward(xs, hs, F, K, bound, slope, univ)
            d, G = grad(y, (xs, hs), torch.ones_like(y))
            recs.append((ps, passes, xh, h, xs, hs, y, ladj, d, G))
            xcur = y.detach()

        # rows whose solve failed contribute nothing
        xbar, lrow = _solve_consistency_mask(xcur, z, xbar, lbar)

        # ---- sweep 2: g_out[i], the log-density cotangent at layer i's output
        g_out = [None] * len(recs)
        v = xbar
        if lrow is not None:
            # raw mode: lbar is the cotangent of the bare sum of ladjs
            g = torch.zeros_like(xcur) if raw else -xcur * lrow
            for i in reversed(range(len(recs))):
                g_out[i] = g
                _, _, xh, h, xs, hs, y, ladj, _, _ = recs[i]
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
        out = nf.nsf_sample(zc, params, *statics, want_log_prob)
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
    shape, zc = nf._base_draws(flat, sample_shape, c, generator)
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
