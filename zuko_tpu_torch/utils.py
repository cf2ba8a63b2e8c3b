r"""Tensor helpers and the device rule.

Counterpart of ``zuko_tpu/utils.py`` (``broadcast`` :85, ``unpack`` :116,
``bisection`` :171, ``newton_bisection`` :251, ``gauss_legendre`` :299,
``odeint`` :474).
"""

from __future__ import annotations

import math

from typing import Callable, Iterable, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = [
    "bisection", "broadcast", "gauss_legendre", "newton_bisection", "odeint", "resolve_device",
    "unpack",
]


def resolve_device(device=None) -> torch.device:
    r"""The device rule of the package: ``None`` means ``cuda``, and asking
    for ``cuda`` without a card raises instead of dropping to the CPU.
    Pass ``device="cpu"`` to build on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "zuko_tpu_torch builds on the GPU by default and no CUDA device is"
            " available; pass device='cpu' to build on the CPU"
        )
    return device


def broadcast(*tensors: torch.Tensor, ignore: Union[int, Sequence[int]] = 0):
    r"""Broadcast tensors together, ignoring a number of trailing dimensions
    (reference semantics: zuko/utils.py:212-244).

    Example:
        >>> x, y = broadcast(torch.ones(2, 3), torch.ones(5, 1, 4), ignore=1)
        >>> x.shape, y.shape
        (torch.Size([5, 2, 3]), torch.Size([5, 2, 4]))
    """
    if isinstance(ignore, int):
        ignore = [ignore] * len(tensors)
    dims = [t.dim() - i for t, i in zip(tensors, ignore)]
    common = torch.broadcast_shapes(*(t.shape[:d] for t, d in zip(tensors, dims)))
    return [t.expand(common + t.shape[d:]) for t, d in zip(tensors, dims)]


def unpack(x: torch.Tensor, shapes: Sequence[Tuple[int, ...]]):
    r"""Split the last dimension of ``x`` into chunks of ``prod(shape)``
    elements, each reshaped to ``x.shape[:-1] + shape``
    (reference semantics: zuko/utils.py:596-622).

    Example:
        >>> a, b = unpack(torch.arange(10.0).reshape(2, 5), [(3,), (2,)])
        >>> a.shape, b.shape
        (torch.Size([2, 3]), torch.Size([2, 2]))
    """
    sizes = [math.prod(s) for s in shapes]
    chunks = torch.split(x, sizes, dim=-1)
    return [c.reshape(c.shape[:-1] + tuple(s)) for c, s in zip(chunks, shapes)]


# ------------------------------------------------------------------ bisection


def _implicit_backward(ctx, grad_x, needs):
    """The implicit-function rule both solvers share (counterpart of
    ``_bisection_bwd`` :157): ``f(x*, phi) = y`` gives ``dx/dy = 1 / f'(x*)``,
    and the parameters receive the pullback of ``-grad_y`` through ``f`` at
    the solved point. ``needs`` says which of ``phi`` want a gradient.
    With ``ctx.f_phi``, ``f`` is evaluated at copies of ``phi`` cut from
    their history, so the pullback is ``f``'s partial derivative in each
    entry and walks no graph beyond ``phi``. Returns ``(grad_y, grad_phi)``."""
    phi = ctx.saved_tensors
    with torch.enable_grad():
        x = ctx.x.detach().requires_grad_()
        if ctx.f_phi is None:
            y = ctx.f(x)
        else:
            phi = [p.detach().requires_grad_(need) for p, need in zip(phi, needs)]
            y = ctx.f_phi(x, phi)
    (jacobian,) = torch.autograd.grad(y, x, torch.ones_like(y), retain_graph=True)
    grad_y = grad_x / jacobian
    wanted = [p for p, need in zip(phi, needs) if need]
    grads = iter(torch.autograd.grad(y, wanted, -grad_y, allow_unused=True) if wanted else ())
    return grad_y, [next(grads) if need else None for need in needs]


class _Bisection(torch.autograd.Function):
    """``n`` even subdivisions of ``[a, b]`` forward, the implicit-function
    rule backward (reference: zuko/utils.py:118-209)."""

    @staticmethod
    def forward(ctx, f, n, y, a, b, *phi):
        for _ in range(n):
            c = (a + b) / 2
            mask = f(c) < y
            a = torch.where(mask, c, a)
            b = torch.where(mask, b, c)
        ctx.f, ctx.f_phi, ctx.x = f, None, (a + b) / 2
        ctx.save_for_backward(*phi)
        return ctx.x

    @staticmethod
    def backward(ctx, grad_x):
        grad_y, grad_phi = _implicit_backward(ctx, grad_x, ctx.needs_input_grad[5:])
        return (None, None, grad_y, None, None, *grad_phi)


class _NewtonBisection(torch.autograd.Function):
    """Safeguarded Newton ("rtsafe") forward, the implicit-function rule
    backward (counterpart of ``_newton_bisection`` :206). A Newton step is
    taken only when it stays inside the bracket and makes fast enough
    progress (``|2 r| <= |dx_old f'|``, the Numerical-Recipes criterion that
    prevents oscillation); otherwise the bracket is bisected, so it provably
    shrinks. The loop ends early, on the host, once every element has
    converged."""

    @staticmethod
    def forward(ctx, f, f_phi, n, xtol, y, a, b, *phi):
        lo, hi = a, b
        x, dxold = (a + b) / 2, b - a
        for _ in range(n):
            if not bool(torch.max(torch.minimum(hi - lo, dxold.abs())) > xtol):
                break
            with torch.enable_grad():
                xg = x.detach().requires_grad_()
                fx = f(xg)
                (dfx,) = torch.autograd.grad(fx, xg, torch.ones_like(fx))
            r = fx.detach() - y
            below = r < 0
            lo = torch.where(below, x, lo)
            hi = torch.where(below, hi, x)
            xn = x - r / dfx
            ok = (
                (xn >= lo) & (xn <= hi) & torch.isfinite(xn)
                & ((2 * r).abs() <= (dxold * dfx).abs())
            )
            x_new = torch.where(ok, xn, (lo + hi) / 2)
            x, dxold = x_new, x_new - x
        ctx.f, ctx.f_phi, ctx.x = f, f_phi, x
        ctx.save_for_backward(*phi)
        return x

    @staticmethod
    def backward(ctx, grad_x):
        grad_y, grad_phi = _implicit_backward(ctx, grad_x, ctx.needs_input_grad[7:])
        return (None, None, None, None, grad_y, None, None, *grad_phi)


def _solver_inputs(y, a, b):
    """``y`` and the bracket ends broadcast to it, in their common dtype."""
    y = torch.as_tensor(y)
    dtype = torch.promote_types(torch.result_type(y, a), torch.result_type(y, b))
    y = y.to(dtype)
    a = torch.as_tensor(a, dtype=dtype, device=y.device).expand(y.shape)
    b = torch.as_tensor(b, dtype=dtype, device=y.device).expand(y.shape)
    return y, a, b


def bisection(
    f: Callable[[torch.Tensor], torch.Tensor],
    y: torch.Tensor,
    a: Union[float, torch.Tensor],
    b: Union[float, torch.Tensor],
    n: int = 16,
    phi: Iterable[torch.Tensor] = (),
) -> torch.Tensor:
    r"""Solve ``f(x) = y`` elementwise by ``n`` bisection iterations.

    ``f`` must be strictly increasing on ``[a, b]`` with ``f(a) <= y <= f(b)``
    (reference: zuko/utils.py:118-209). ``phi`` holds the tensors ``f``
    depends on: gradients reach ``y`` and them through the implicit function
    theorem, not through the iterations.

    Example:
        >>> f = lambda x: x**3
        >>> x = bisection(f, torch.tensor(8.0), 0.0, 10.0, n=40)
        >>> bool(torch.allclose(x, torch.tensor(2.0), atol=1e-6))
        True
    """
    return _Bisection.apply(f, n, *_solver_inputs(y, a, b), *phi)


def newton_bisection(
    f: Callable[[torch.Tensor], torch.Tensor],
    y: torch.Tensor,
    a: Union[float, torch.Tensor],
    b: Union[float, torch.Tensor],
    n: int = 32,
    xtol: float = 1e-8,
    phi: Iterable[torch.Tensor] = (),
    f_phi: Callable = None,
) -> torch.Tensor:
    r"""Solve ``f(x) = y`` for an elementwise increasing ``f`` with
    safeguarded Newton iterations: each step takes the Newton update when it
    stays inside the current bracket and bisects otherwise, at most ``n``
    steps, fewer once every element moves by less than ``xtol``. Gradients
    use the same implicit-function rule as :func:`bisection`.

    ``f_phi(x, phi)``, when given, is ``f`` with ``phi`` explicit: the
    backward differentiates it at copies of ``phi`` cut from their history.
    Give it when one entry of ``phi`` depends on another (a NAF's network
    parameters lie upstream of a later sweep's signal): ``f``'s closure would
    pull the gradient back through that history as well, into the caller's
    graph, and free it.

    Example:
        >>> f = lambda x: x**3 + x
        >>> x = newton_bisection(f, torch.tensor(10.0), -3.0, 3.0)
        >>> bool(torch.allclose(f(x), torch.tensor(10.0), atol=1e-6))
        True
    """
    return _NewtonBisection.apply(f, f_phi, n, float(xtol), *_solver_inputs(y, a, b), *phi)


# ---------------------------------------------------------------- quadrature


def gauss_legendre(
    f: Callable[[torch.Tensor], torch.Tensor],
    a: Union[float, torch.Tensor],
    b: Union[float, torch.Tensor],
    n: int = 3,
) -> torch.Tensor:
    r"""Estimate :math:`\int_a^b f(x) dx` with an ``n``-point Gauss-Legendre
    rule, exact for polynomials of degree up to :math:`2n - 1` (reference:
    zuko/utils.py:247-363). The nodes and weights are numpy's float64 values
    cast to the working dtype. ``f`` is called once on every node of every
    element, stacked on a new leading dimension; gradients to ``a``, ``b``
    and whatever ``f`` reads flow by plain autograd through the weighted sum.

    Example:
        >>> v = gauss_legendre(lambda x: x**2, torch.tensor(0.0), torch.tensor(1.0), n=2)
        >>> bool(torch.allclose(v, torch.tensor(1 / 3)))
        True
    """
    nodes, weights = np.polynomial.legendre.leggauss(n)
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    dtype = torch.promote_types(torch.promote_types(a.dtype, b.dtype), torch.float32)
    half, mid = (b - a).to(dtype) / 2, (a + b).to(dtype) / 2
    shape = (-1,) + (1,) * mid.dim()
    nodes = torch.as_tensor(nodes, dtype=dtype, device=mid.device).reshape(shape)
    ys = f(mid + half * nodes)
    weights = torch.as_tensor(weights, dtype=dtype, device=ys.device)
    return half * torch.sum(weights.reshape((-1,) + (1,) * (ys.dim() - 1)) * ys, dim=0)


# -------------------------------------------------------------------- odeint

# The Dormand-Prince 4(5) tableau, the public coefficients that
# ``zuko_tpu/utils.py:345-356`` also carries: the stage times, the stage
# weights (row i holds the weights of the slopes 0..i-1), and the fifth- and
# fourth-order solution weights.
_DP_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_DP_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DP_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DP_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40)


def _leaves(tree):
    """The tensors of a nest of tuples, lists and dicts, in order (what
    ``ravel_pytree`` walks); other leaves (modules, ``None``) are not
    collected."""
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in tree for t in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _leaves(v)]
    return []


def _replace(tree, tensors):
    """``tree`` with its tensors taken in order from the iterator ``tensors``."""
    if torch.is_tensor(tree):
        return next(tensors)
    if isinstance(tree, dict):
        return {k: _replace(v, tensors) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_replace(v, tensors) for v in tree)
    return tree


def _ravel(tree):
    return torch.cat([t.reshape(-1) for t in _leaves(tree)])


def _unravel(like, flat):
    """``like``'s structure from the flat vector ``flat``."""
    sizes = [t.numel() for t in _leaves(like)]
    chunks = iter(c.reshape(t.shape) for c, t in zip(flat.split(sizes), _leaves(like)))
    return _replace(like, chunks)


def _empty_phi(phi) -> bool:
    return phi is None or (isinstance(phi, (tuple, list)) and len(phi) == 0)


def _dp_step(f, x, t, dt, p):
    """One Dormand-Prince 4(5) step of ``dx/ds = f(s, x, p)``: the fifth-order
    solution and the error estimate (counterpart of ``_dp_step`` :359)."""
    ks = []
    for i in range(7):
        xi = x
        for j, a in enumerate(_DP_A[i]):
            if a != 0.0:
                xi = xi + (dt * a) * ks[j]
        ks.append(f(t + _DP_C[i] * dt, xi, p))
    x5, err = x, torch.zeros_like(x)
    for i in range(7):
        if _DP_B5[i] != 0.0:
            x5 = x5 + (dt * _DP_B5[i]) * ks[i]
        d = _DP_B5[i] - _DP_B4[i]
        if d != 0.0:
            err = err + (dt * d) * ks[i]
    return x5, err


def _odeint_loop(f, x, p, atol, rtol, max_steps):
    """The adaptive loop on ``s`` from 0 to 1 (counterpart of
    ``_odeint_fwd_loop`` :391): ``(x(1), accepted steps [(x, s, ds)])``.
    The error ratio is the max over the whole state of ``|err| / (atol + rtol
    max(|x|, |y|))``, NaN counts as a rejection, and the step grows or
    shrinks by ``0.9 ratio^(-1/5)`` clipped to [0.1, 10]. At most ``4
    max_steps`` attempts and ``max_steps`` accepted steps: a budget that runs
    out before ``s = 1`` NaN-poisons the result. ``s`` and the step live on
    the host, in float64."""
    s, ds, attempts, steps = 0.0, 1.0, 0, []
    tiny = torch.finfo(x.dtype).tiny
    while s < 1.0 and attempts < 4 * max_steps and len(steps) < max_steps:
        ds = min(ds, 1.0 - s)
        y, err = _dp_step(f, x, s, ds, p)
        ratio = float((err.abs() / (atol + rtol * torch.maximum(x.abs(), y.abs()))).max())
        if math.isnan(ratio):
            ratio = math.inf
        if ratio <= 1.0:
            steps.append((x, s, ds))
            x, s = y, s + ds
        ds *= min(max(0.9 * max(ratio, tiny) ** -0.2, 0.1), 10.0)
        attempts += 1
    if s < 1.0 - 64 * torch.finfo(x.dtype).eps:
        x = torch.full_like(x, math.nan)
    return x, steps


class _Odeint(torch.autograd.Function):
    """The loop forward, its discrete adjoint backward (counterpart of
    ``_odeint_flat`` and ``_odeint_flat_bwd`` :445): the forward records the
    accepted ``(x, s, ds)`` without a graph; the backward walks them in
    reverse and pulls the cotangent back through one step at a time, so its
    memory is one step's graph, not the loop's."""

    @staticmethod
    def forward(ctx, f, atol, rtol, max_steps, x0, *p):
        x, steps = _odeint_loop(f, x0.detach(), p, atol, rtol, max_steps)
        ctx.f, ctx.steps = f, steps
        ctx.save_for_backward(*p)
        return x

    @staticmethod
    def backward(ctx, g):
        p = ctx.saved_tensors
        needs = ctx.needs_input_grad[5:]
        a_x, a_p = g, [None] * len(p)
        for x, s, ds in reversed(ctx.steps):
            with torch.enable_grad():
                x = x.detach().requires_grad_()
                ps = [q.detach().requires_grad_(need) for q, need in zip(p, needs)]
                y, _ = _dp_step(ctx.f, x, s, ds, ps)
                wanted = [q for q in ps if q.requires_grad]
                grads = torch.autograd.grad(y, [x, *wanted], a_x, allow_unused=True)
            a_x, grads = grads[0], iter(grads[1:])
            for i, q in enumerate(ps):
                if q.requires_grad:
                    d = next(grads)
                    if d is not None:
                        a_p[i] = d if a_p[i] is None else a_p[i] + d
        return (None, None, None, None, a_x, *a_p)


def odeint(
    f: Callable,
    x,
    t0: Union[float, torch.Tensor],
    t1: Union[float, torch.Tensor],
    phi=(),
    atol: float = 1e-6,
    rtol: float = 1e-5,
    max_steps: int = 256,
):
    r"""Integrate :math:`dx/dt = f(t, x)` from ``t0`` to ``t1`` (counterpart
    of ``odeint`` :474; reference behavior: zuko/utils.py:366-593).

    Adaptive Dormand-Prince 4(5) with error control :math:`\tau = \text{atol}
    + \text{rtol} \max(|x|, |y|)` over the whole state, and the step factor
    :math:`0.9\,\varepsilon^{-1/5}` clipped to :math:`[0.1, 10]`. It runs in
    normalized time :math:`s \in [0, 1]` with the factor :math:`t_1 - t_0`,
    so ``t1 < t0`` works. The state ``x`` may be a tensor or a tuple (or list
    or dict) of tensors, integrated as one flat vector. If ``phi`` is given,
    ``f`` is called as ``f(t, x, phi)``, else ``f(t, x)``; ``phi`` is a nest
    of tuples, lists and dicts whose tensors are the parameters of ``f``
    (other leaves pass through as they are). Gradients with respect to
    ``x``, the tensors of ``phi``, ``t0`` and ``t1`` use a discrete adjoint
    over the accepted steps, one step's graph at a time. A budget of ``4
    max_steps`` attempts or ``max_steps`` accepted steps that runs out before
    ``t1`` NaN-poisons the result.

    Example:
        >>> x1 = odeint(lambda t, x: -x, torch.ones(2), 0.0, 1.0)
        >>> bool(torch.allclose(x1, torch.exp(torch.tensor(-1.0)), atol=1e-4))
        True
    """
    x0 = _ravel(x)
    t0 = torch.as_tensor(t0, dtype=x0.dtype, device=x0.device)
    t1 = torch.as_tensor(t1, dtype=x0.dtype, device=x0.device)
    has_phi = not _empty_phi(phi)

    def f_flat(s, xf, p):
        t0, t1, *ps = p
        t = t0 + s * (t1 - t0)
        state = _unravel(x, xf)
        dx = f(t, state, _replace(phi, iter(ps))) if has_phi else f(t, state)
        return (t1 - t0) * _ravel(dx)

    out = _Odeint.apply(f_flat, float(atol), float(rtol), int(max_steps), x0, t0, t1,
                        *_leaves(phi))
    return _unravel(x, out)
