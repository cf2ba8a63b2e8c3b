r"""Tensor helpers and the device rule.

Counterpart of ``zuko_tpu/utils.py`` (``broadcast`` :85, ``unpack`` :116,
``bisection`` :171, ``newton_bisection`` :251, ``gauss_legendre`` :299).
"""

from __future__ import annotations

import math

from typing import Callable, Iterable, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = [
    "bisection", "broadcast", "gauss_legendre", "newton_bisection", "resolve_device", "unpack",
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
    Returns ``(grad_y, grad_phi)``."""
    phi = ctx.saved_tensors
    with torch.enable_grad():
        x = ctx.x.detach().requires_grad_()
        y = ctx.f(x)
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
        ctx.f, ctx.x = f, (a + b) / 2
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
    def forward(ctx, f, n, xtol, y, a, b, *phi):
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
        ctx.f, ctx.x = f, x
        ctx.save_for_backward(*phi)
        return x

    @staticmethod
    def backward(ctx, grad_x):
        grad_y, grad_phi = _implicit_backward(ctx, grad_x, ctx.needs_input_grad[6:])
        return (None, None, None, grad_y, None, None, *grad_phi)


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
) -> torch.Tensor:
    r"""Solve ``f(x) = y`` for an elementwise increasing ``f`` with
    safeguarded Newton iterations: each step takes the Newton update when it
    stays inside the current bracket and bisects otherwise, at most ``n``
    steps, fewer once every element moves by less than ``xtol``. Gradients
    use the same implicit-function rule as :func:`bisection`.

    Example:
        >>> f = lambda x: x**3 + x
        >>> x = newton_bisection(f, torch.tensor(10.0), -3.0, 3.0)
        >>> bool(torch.allclose(f(x), torch.tensor(10.0), atol=1e-6))
        True
    """
    return _NewtonBisection.apply(f, n, float(xtol), *_solver_inputs(y, a, b), *phi)


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
