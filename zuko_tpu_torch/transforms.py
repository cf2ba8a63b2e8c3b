r"""Bijective transformations with fused log-Jacobians.

Counterpart of ``zuko_tpu/transforms.py``: :class:`Transform` :95,
:class:`ComposedTransform` :197, :class:`DependentTransform` :284,
:class:`SoftclipTransform` :505, :class:`CircularShiftTransform` :529,
:class:`MonotonicAffineTransform` :584,
:class:`MonotonicRQSTransform` :612,
:class:`AdditiveTransform` :563, :class:`MonotonicTransform` :724,
:class:`BernsteinTransform` :793, :class:`BoundedBernsteinTransform` :882,
:class:`GaussianizationTransform` :910,
:class:`UnconstrainedMonotonicTransform` :966,
:class:`SOSPolynomialTransform` :1005,
:class:`AutoregressiveTransform` :1033, :class:`FreeFormJacobianTransform`
:1131 and :class:`RotationTransform` :1292.
Transforms are plain objects built per call by the lazy modules; they hold
tensors, not parameters.

Convention (as in ``zuko_tpu``): ``inverse_and_ladj(y)`` returns the
log-det of the *inverse* map, i.e. minus the forward ladj at
:math:`x = f^{-1}(y)`.
"""

from __future__ import annotations

import math

from typing import Callable, Iterable, Tuple

import torch
import torch.nn.functional as F

from .utils import _empty_phi, gauss_legendre, newton_bisection, odeint

__all__ = [
    "AdditiveTransform",
    "AutoregressiveTransform",
    "BernsteinTransform",
    "BoundedBernsteinTransform",
    "CircularShiftTransform",
    "ComposedTransform",
    "DependentTransform",
    "FreeFormJacobianTransform",
    "GaussianizationTransform",
    "Inverse",
    "MonotonicAffineTransform",
    "MonotonicRQSTransform",
    "MonotonicTransform",
    "RotationTransform",
    "SOSPolynomialTransform",
    "SoftclipTransform",
    "Transform",
    "UnconstrainedMonotonicTransform",
]


def _sum_rightmost(x: torch.Tensor, n: int) -> torch.Tensor:
    if n == 0:
        return x
    return x.sum(dim=tuple(range(-n, 0)))


class Transform:
    r"""Abstract bijective transformation :math:`y = f(x)`.

    ``domain_dim`` / ``codomain_dim`` are the numbers of event dimensions the
    transformation consumes / produces."""

    domain_dim: int = 0
    codomain_dim: int = 0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, _ = self.call_and_ladj(x)
        return y

    def inverse(self, y: torch.Tensor) -> torch.Tensor:
        x, _ = self.inverse_and_ladj(y)
        return x

    def call_and_ladj(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def inverse_and_ladj(self, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        r"""Returns :math:`(f^{-1}(y), \log|\det J_{f^{-1}}(y)|)`."""
        raise NotImplementedError

    @property
    def inv(self) -> "Transform":
        return Inverse(self)


class Inverse(Transform):
    r"""Lazy inverse of a transformation."""

    def __init__(self, base: Transform):
        self.base = base

    @property
    def domain_dim(self) -> int:
        return self.base.codomain_dim

    @property
    def codomain_dim(self) -> int:
        return self.base.domain_dim

    def forward(self, x):
        return self.base.inverse(x)

    def inverse(self, y):
        return self.base.forward(y)

    def call_and_ladj(self, x):
        return self.base.inverse_and_ladj(x)

    def inverse_and_ladj(self, y):
        return self.base.call_and_ladj(y)

    @property
    def inv(self) -> Transform:
        return self.base


class ComposedTransform(Transform):
    r"""Composition :math:`f = f_n \circ \dots \circ f_0` with event-dimension
    accounting (reference: zuko/transforms.py:59-160)."""

    def __init__(self, *transforms: Transform):
        assert transforms, "'transforms' cannot be empty"
        event_dim = 0
        for t in reversed(transforms):
            event_dim = t.domain_dim + max(event_dim - t.codomain_dim, 0)
        self._domain_dim = event_dim
        for t in transforms:
            event_dim += t.codomain_dim - t.domain_dim
        self._codomain_dim = event_dim
        self.transforms = list(transforms)

    @property
    def domain_dim(self) -> int:
        return self._domain_dim

    @property
    def codomain_dim(self) -> int:
        return self._codomain_dim

    def forward(self, x):
        for t in self.transforms:
            x = t(x)
        return x

    def inverse(self, y):
        for t in reversed(self.transforms):
            y = t.inverse(y)
        return y

    def call_and_ladj(self, x):
        event_dim = self.domain_dim
        acc = 0.0
        for t in self.transforms:
            x, ladj = t.call_and_ladj(x)
            acc = acc + _sum_rightmost(ladj, event_dim - t.domain_dim)
            event_dim += t.codomain_dim - t.domain_dim
        return x, acc

    def inverse_and_ladj(self, y):
        event_dim = self.codomain_dim
        acc = 0.0
        for t in reversed(self.transforms):
            y, ladj = t.inverse_and_ladj(y)
            acc = acc + _sum_rightmost(ladj, event_dim - t.codomain_dim)
            event_dim += t.domain_dim - t.codomain_dim
        return y, acc

    @property
    def inv(self) -> Transform:
        return ComposedTransform(*(t.inv for t in reversed(self.transforms)))


class DependentTransform(Transform):
    r"""Reinterprets the rightmost dimensions of a base transformation as
    dependent, summing their log-Jacobian (reference: zuko/transforms.py:163-220)."""

    def __init__(self, base: Transform, reinterpreted: int):
        self.base = base
        self.reinterpreted = int(reinterpreted)

    @property
    def domain_dim(self) -> int:
        return self.base.domain_dim + self.reinterpreted

    @property
    def codomain_dim(self) -> int:
        return self.base.codomain_dim + self.reinterpreted

    def forward(self, x):
        return self.base(x)

    def inverse(self, y):
        return self.base.inverse(y)

    def call_and_ladj(self, x):
        y, ladj = self.base.call_and_ladj(x)
        return y, _sum_rightmost(ladj, self.reinterpreted)

    def inverse_and_ladj(self, y):
        x, ladj = self.base.inverse_and_ladj(y)
        return x, _sum_rightmost(ladj, self.reinterpreted)


class SoftclipTransform(Transform):
    r""":math:`f(x) = \frac{x}{1 + |x / B|}`, mapping :math:`\mathbb{R}` onto
    :math:`(-B, B)` (reference: zuko/transforms.py:286-316); NAF puts one
    between its autoregressive layers.

    Example:
        >>> t = SoftclipTransform(5.0)
        >>> x = torch.tensor(100.0)
        >>> bool(torch.allclose(t.inverse(t(x)), x, atol=1e-3))
        True
    """

    def __init__(self, bound: float = 1.0):
        self.bound = float(bound)

    def forward(self, x):
        return x / (1 + torch.abs(x / self.bound))

    def inverse(self, y):
        return y / (1 - torch.abs(y / self.bound))

    def _ladj(self, x):
        return -2 * torch.log1p(torch.abs(x / self.bound))

    def call_and_ladj(self, x):
        return self.forward(x), self._ladj(x)

    def inverse_and_ladj(self, y):
        x = self.inverse(y)
        return x, -self._ladj(x)


class CircularShiftTransform(Transform):
    r""":math:`f(x) = (x \bmod 2B) - B`, a circular shift of :math:`[-B, B)`
    by :math:`B`, its own inverse on the circle (reference:
    zuko/transforms.py:319-351). The log-Jacobian is zero."""

    def __init__(self, bound: float = 1.0):
        self.bound = float(bound)

    def forward(self, x):
        return torch.remainder(x, 2 * self.bound) - self.bound

    inverse = forward

    def call_and_ladj(self, x):
        return self.forward(x), torch.zeros_like(x)

    def inverse_and_ladj(self, y):
        return self.inverse(y), torch.zeros_like(y)


class AdditiveTransform(Transform):
    r""":math:`f(x) = x + b`, the NICE coupling law (reference:
    zuko/transforms.py:381-409); UMNN adds its per-feature constant with it."""

    def __init__(self, shift):
        self.shift = shift

    def forward(self, x):
        return x + self.shift

    def inverse(self, y):
        return y - self.shift

    def _ladj(self, x):
        return torch.zeros(torch.broadcast_shapes(x.shape, self.shift.shape),
                           dtype=x.dtype, device=x.device)

    def call_and_ladj(self, x):
        return self.forward(x), self._ladj(x)

    def inverse_and_ladj(self, y):
        return self.inverse(y), self._ladj(y)


class MonotonicAffineTransform(Transform):
    r""":math:`f(x) = \exp(a) x + b` with the minimum-slope soft-clamp
    :math:`a \mapsto a / (1 + |a / \log s|)` (reference:
    zuko/transforms.py:412-446) — the default univariate of MAF."""

    def __init__(self, shift, scale, slope: float = 1e-3):
        self.shift = shift
        self.log_scale = scale / (1 + torch.abs(scale / math.log(slope)))
        self.scale = torch.exp(self.log_scale)

    def forward(self, x):
        return x * self.scale + self.shift

    def inverse(self, y):
        return (y - self.shift) / self.scale

    def _ladj(self, x):
        shape = torch.broadcast_shapes(x.shape, self.log_scale.shape)
        return self.log_scale.expand(shape)

    def call_and_ladj(self, x):
        return self.forward(x), self._ladj(x)

    def inverse_and_ladj(self, y):
        return self.inverse(y), -self._ladj(y)


class MonotonicRQSTransform(Transform):
    r"""Monotonic rational-quadratic spline (Neural Spline Flows).

    Raw widths / heights / derivatives are slope-clamped, softmaxed and
    cumsummed into ``K + 1`` knots on :math:`[-B, B]`; the bin is the
    branchless ``sum(knots < value) - 1``; out-of-domain inputs pass through
    the identity with zero log-Jacobian (reference: zuko/transforms.py:449-567).
    For a tensor on the GPU the forward and the inverse run the ``rqs``
    kernel (:mod:`zuko_tpu_torch.ops.rqs`, float32 only).
    """

    def __init__(self, widths, heights, derivatives, bound: float = 5.0,
                 slope: float = 1e-3):
        log_slope = math.log(slope)
        widths = widths / (1 + torch.abs(2 * widths / log_slope))
        heights = heights / (1 + torch.abs(2 * heights / log_slope))
        derivatives = derivatives / (1 + torch.abs(derivatives / log_slope))

        widths = F.pad(torch.softmax(widths, dim=-1), (1, 0))
        heights = F.pad(torch.softmax(heights, dim=-1), (1, 0))
        derivatives = F.pad(derivatives, (1, 1))

        self.horizontal = bound * (2 * torch.cumsum(widths, dim=-1) - 1)
        self.vertical = bound * (2 * torch.cumsum(heights, dim=-1) - 1)
        self.derivatives = torch.exp(derivatives)

    @property
    def bins(self) -> int:
        return self.horizontal.shape[-1] - 1

    def _bin(self, knots, value):
        """Bin parameters at ``value`` along ``knots`` (horizontal for the
        forward, vertical for the inverse) and the in-domain mask."""
        k = torch.sum(knots < value[..., None], dim=-1) - 1
        mask = (0 <= k) & (k < self.bins)
        k = (k % self.bins)[..., None]

        def take(arr, idx):
            arr = arr.expand(value.shape + arr.shape[-1:])
            return torch.gather(arr, -1, idx)[..., 0]

        x0, x1 = take(self.horizontal, k), take(self.horizontal, k + 1)
        y0, y1 = take(self.vertical, k), take(self.vertical, k + 1)
        d0, d1 = take(self.derivatives, k), take(self.derivatives, k + 1)
        s = (y1 - y0) / (x1 - x0)
        return mask, x0, x1, y0, y1, d0, d1, s

    @staticmethod
    def _log_jac(z, d0, d1, s):
        z1 = z * (1 - z)
        denom = s + (d0 + d1 - 2 * s) * z1
        jac = s**2 * (2 * s * z1 + d0 * (1 - z) ** 2 + d1 * z**2) / denom**2
        return torch.log(jac), denom

    def call_and_ladj(self, x):
        if x.is_cuda:  # the kernel, or an error: never the plain version
            from .ops import rqs_forward

            return rqs_forward(x, self.horizontal, self.vertical, self.derivatives)
        return self._forward_math(x)

    def inverse_and_ladj(self, y):
        if y.is_cuda:
            from .ops import rqs_inverse

            return rqs_inverse(y, self.horizontal, self.vertical, self.derivatives)
        return self._inverse_math(y)

    def _forward_math(self, x):
        """The forward's own arithmetic, on any device."""
        mask, x0, x1, y0, y1, d0, d1, s = self._bin(self.horizontal, x)
        z = torch.where(mask, (x - x0) / (x1 - x0), 0.0)
        log_jac, denom = self._log_jac(z, d0, d1, s)
        y = y0 + (y1 - y0) * (s * z**2 + d0 * z * (1 - z)) / denom
        return torch.where(mask, y, x), torch.where(mask, log_jac, 0.0)

    def _inverse_math(self, y):
        """The inverse's own arithmetic, on any device."""
        mask, x0, x1, y0, y1, d0, d1, s = self._bin(self.vertical, y)
        y_ = torch.where(mask, y - y0, 0.0)
        a = (y1 - y0) * (s - d0) + y_ * (d0 + d1 - 2 * s)
        b = (y1 - y0) * d0 - y_ * (d0 + d1 - 2 * s)
        c = -s * y_
        disc = torch.clamp(b**2 - 4 * a * c, min=0.0)
        z = torch.where(mask, 2 * c / (-b - torch.sqrt(disc)), 0.0)
        log_jac, _ = self._log_jac(z, d0, d1, s)
        x = x0 + z * (x1 - x0)
        return torch.where(mask, x, y), torch.where(mask, -log_jac, 0.0)


class MonotonicTransform(Transform):
    r"""Transformation from a generic monotonic univariate function
    :math:`f_\phi` (reference: zuko/transforms.py:570-637).

    The inverse is a safeguarded Newton solve on :math:`[-B, B]`
    (:func:`zuko_tpu_torch.utils.newton_bisection`) of at most
    :math:`n = \lceil \log_2(2B/\epsilon) \rceil + 4` steps; ``phi`` holds
    the tensors ``f`` depends on, which receive their gradients by implicit
    differentiation. The log-Jacobian differentiates ``f``. A subclass whose
    ``phi`` depend on one another defines ``f_phi(x, phi)``, ``f`` with
    ``phi`` explicit, for the solve's backward
    (:func:`~zuko_tpu_torch.utils.newton_bisection`).
    """

    f_phi = None

    def __init__(
        self,
        f: Callable[[torch.Tensor], torch.Tensor] = None,
        phi: Iterable[torch.Tensor] = (),
        bound: float = 10.0,
        eps: float = 1e-6,
    ):
        if f is not None:
            self.f = f
        self.phi = tuple(phi)
        self.bound = float(bound)
        self.eps = float(eps)

    def forward(self, x):
        return self.f(x)

    def inverse(self, y):
        n = int(math.ceil(math.log2(2 * self.bound / self.eps))) + 4
        return newton_bisection(
            self.f, y, -self.bound, self.bound, n=n, xtol=self.eps, phi=self.phi,
            f_phi=self.f_phi,
        )

    def call_and_ladj(self, x):
        with torch.enable_grad():
            x = x.view_as(x).requires_grad_()
            y = self.f(x)
            (jacobian,) = torch.autograd.grad(
                y, x, torch.ones_like(y), create_graph=True
            )
        return y, torch.log(jacobian)

    def inverse_and_ladj(self, y):
        x = self.inverse(y)
        _, ladj = self.call_and_ladj(x)
        return x, -ladj


class BernsteinTransform(MonotonicTransform):
    r"""Monotonic Bernstein polynomial transformation (reference:
    zuko/transforms.py:640-777), the ingredient of BPF.

    The raw coefficients are made increasing by softplus and cumsum, with the
    end differences repeated so that the bounds are smooth. The polynomial is
    the Bezier sum :math:`\sum_i \theta_i b_{i, M}(u)` on :math:`u = (x + B)
    / 2B`, evaluated by De Casteljau's repeated lerps; outside :math:`[\epsilon,
    1 - \epsilon]` it extends linearly with matching offset and slope, and the
    inverse is that line's closed form there. The coefficients are the
    ``phi`` of the inverse's implicit-function backward.

    Arguments:
        theta: unconstrained coefficients, shape ``(*, M - 2)``.
        bound: the domain bound :math:`B`.
    """

    def __init__(self, theta, bound: float = 5.0, eps: float = 1e-6):
        super().__init__(None, bound=bound, eps=eps)
        self.theta = self._constrain_theta(theta)
        self._setup_extrapolation()
        self.phi = (self.theta, *self.offset, *self.slope)

    @property
    def order(self) -> int:
        return self.theta.shape[-1] - 1

    def _constrain_theta(self, utheta):
        # reference: zuko/transforms.py:703-727
        shift = math.log(2.0) * utheta.shape[-1] / 2
        rest = utheta[..., 1:]
        rest = torch.cat([rest[..., :1], rest, rest[..., -1:]], dim=-1)
        diffs = torch.cat([utheta[..., :1], F.softplus(rest)], dim=-1)
        return torch.cumsum(diffs, dim=-1) - shift

    @staticmethod
    def _poly(u, theta):
        """De Casteljau: the Bezier sum of ``theta`` at ``u``."""
        u = u[..., None]
        while theta.shape[-1] > 1:
            theta = theta[..., :-1] + u * (theta[..., 1:] - theta[..., :-1])
        return theta[..., 0]

    def _setup_extrapolation(self):
        dtheta = self.order * (self.theta[..., 1:] - self.theta[..., :-1])
        lo = torch.full(self.theta.shape[:-1], self.eps, dtype=self.theta.dtype,
                        device=self.theta.device)
        self.offset = (self._poly(lo, self.theta), self._poly(1 - lo, self.theta))
        self.slope = (self._poly(lo, dtheta), self._poly(1 - lo, dtheta))

    def f(self, x):
        u = (x + self.bound) / (2 * self.bound)
        lower, upper = u <= self.eps, u >= 1 - self.eps
        y = self._poly(torch.where(lower | upper, 0.5, u), self.theta)
        y = torch.where(lower, self.slope[0] * (u - self.eps) + self.offset[0], y)
        return torch.where(upper, self.slope[1] * (u - 1 + self.eps) + self.offset[1], y)

    def inverse(self, y):
        # the closed form in the extrapolated regions (zuko/transforms.py:762-777)
        x = super().inverse(y)
        B, eps = self.bound, self.eps
        x0 = ((y - self.offset[0]) / self.slope[0] + eps) * 2 * B - B
        x1 = ((y - self.offset[1]) / self.slope[1] - eps + 1) * 2 * B - B
        x = torch.where(y <= self.offset[0], x0, x)
        return torch.where(y >= self.offset[1], x1, x)


class BoundedBernsteinTransform(BernsteinTransform):
    r"""Bernstein polynomial pinned to :math:`[-B, B] \to [-B, B]`, with slope
    1 and no curvature at the bounds, so that layers chain (reference:
    zuko/transforms.py:780-831), the univariate of BPF: the coefficients are
    :math:`-B`, two steps of :math:`d = 2B / (M + 4)`, the softmax of the raw
    ones scaled to fill :math:`2B - 4d`, and two steps of :math:`d` again,
    cumsummed; outside the bounds it is the identity's line.

    Arguments:
        theta: unconstrained coefficients, shape ``(*, M - 5)``.
    """

    def _constrain_theta(self, utheta):
        # reference: zuko/transforms.py:797-818
        d = (2 * self.bound) / (utheta.shape[-1] + 4)
        diffs = torch.softmax(utheta, dim=-1) * (2 * self.bound - 4 * d)
        ones = torch.ones_like(utheta[..., :1])
        diffs = torch.cat([-self.bound * ones, d * ones, d * ones, diffs, d * ones, d * ones],
                          dim=-1)
        return torch.cumsum(diffs, dim=-1)

    def _setup_extrapolation(self):
        # fixed offsets and slopes (reference: zuko/transforms.py:820-831)
        def const(v):
            return torch.tensor(v, dtype=self.theta.dtype, device=self.theta.device)

        self.offset = (const(-self.bound), const(self.bound))
        self.slope = (const(2 * self.bound), const(2 * self.bound))


class GaussianizationTransform(MonotonicTransform):
    r"""Gaussianization: :math:`f(x) = \Phi^{-1}(\frac{1}{K}\sum_i
    \Phi(\exp(a_i) x + b_i))` (reference: zuko/transforms.py:834-875), the
    univariate of GF. The inverse is a root solve.

    Arguments:
        shift: shifts :math:`b`, shape ``(*, K)``.
        scale: unconstrained log-scales :math:`a`, shape ``(*, K)``.
    """

    EPS = 1e-6  # the reference shrinks the mean of erfs by 1 - 1e-6

    def __init__(self, shift, scale, **kwargs):
        super().__init__(None, **kwargs)
        self.shift = shift
        self.log_scale = scale
        self.scale = torch.exp(scale)
        self.phi = (self.shift, self.scale)

    def f(self, x):
        z = x[..., None] * self.scale + self.shift
        m = torch.erf(z / math.sqrt(2)).mean(dim=-1) * (1 - self.EPS)
        return torch.erfinv(m) * math.sqrt(2)

    def call_and_ladj(self, x):
        r"""``f(x)`` with the analytic log-sum-exp log-Jacobian

        .. math:: \log f'(x) = \frac{y^2}{2} + \log\frac{1-\epsilon}{K}
            + \mathrm{logsumexp}_i\left(a_i - \frac{(e^{a_i} x+b_i)^2}{2}\right),

        finite for any parameters. Differentiating ``f`` instead computes
        ``log(mean_i s_i phi(s_i x + b_i) / phi(y))``, whose inner sum
        underflows to 0 in float32 wherever every component saturates
        (:math:`|s_i x + b_i|` above about 9.3): the log-Jacobian becomes
        ``-inf`` and a training loss ``inf``."""
        z = x[..., None] * self.scale + self.shift
        m = torch.erf(z / math.sqrt(2)).mean(dim=-1) * (1 - self.EPS)
        y = torch.erfinv(m) * math.sqrt(2)
        K = self.scale.shape[-1]
        ls = torch.logsumexp(self.log_scale - 0.5 * z**2, dim=-1)
        return y, 0.5 * y**2 + math.log((1 - self.EPS) / K) + ls


class UnconstrainedMonotonicTransform(MonotonicTransform):
    r""":math:`f(x) = \int_0^x g(u)\,du` with a positive integrand :math:`g`,
    estimated by an ``n``-point Gauss-Legendre rule
    (:func:`~zuko_tpu_torch.utils.gauss_legendre`); the log-Jacobian is
    :math:`\log g(x)` exactly (reference: zuko/transforms.py:878-924, the
    UMNN ingredient). The inverse is :class:`MonotonicTransform`'s solve;
    ``phi`` holds the tensors ``g`` depends on."""

    def __init__(self, g: Callable = None, n: int = 32, phi: Iterable[torch.Tensor] = (),
                 **kwargs):
        super().__init__(None, phi, **kwargs)
        if g is not None:
            self.g = g
        self.n = int(n)

    def f(self, x):
        return gauss_legendre(self.g, torch.zeros_like(x), x, n=self.n)

    def call_and_ladj(self, x):
        return self.f(x), torch.log(self.g(x))

    def inverse_and_ladj(self, y):
        x = self.inverse(y)
        return x, -torch.log(self.g(x))


class SOSPolynomialTransform(UnconstrainedMonotonicTransform):
    r"""Sum-of-squares polynomial transformation (reference:
    zuko/transforms.py:927-963), the univariate of SOSPF: the integrand is
    the mean of :math:`K` squared polynomials of degree :math:`L` in
    :math:`x / B`, plus the minimum slope, integrated exactly by the
    :math:`(L + 1)`-point Gauss-Legendre rule.

    Arguments:
        a: polynomial coefficients, shape ``(*, K, L + 1)``.
        slope: minimum slope.
    """

    def __init__(self, a, slope: float = 1e-3, **kwargs):
        super().__init__(None, n=a.shape[-1], phi=(a,), **kwargs)
        self.a = a
        self.slope = float(slope)

    def g(self, x):
        u = (x / self.bound)[..., None]
        p = self.a[..., -1]  # Horner's rule over the degrees
        for l in range(self.a.shape[-1] - 2, -1, -1):
            p = p * u + self.a[..., l]
        return torch.mean((1 + p) ** 2, dim=-1) + self.slope


class RotationTransform(Transform):
    r"""Rotation :math:`f(x) = R x` with :math:`R = \exp(A - A^T)` orthogonal
    (reference: zuko/transforms.py:1217-1244), the mixing between the layers
    of GF."""

    domain_dim = 1
    codomain_dim = 1

    def __init__(self, A):
        self.R = torch.linalg.matrix_exp(A - A.mT)

    def forward(self, x):
        return torch.einsum("...ij,...j->...i", self.R, x)

    def inverse(self, y):
        return torch.einsum("...ij,...i->...j", self.R, y)

    def call_and_ladj(self, x):
        return self.forward(x), torch.zeros_like(x[..., 0])

    def inverse_and_ladj(self, y):
        return self.inverse(y), torch.zeros_like(y[..., 0])


class AutoregressiveTransform(Transform):
    r"""Autoregressive transformation :math:`y_i = f(x_i | x_{<i})`.

    ``meta`` maps an input vector to a (vectorized univariate) transformation.
    The forward is one hyper-network pass; the inverse is ``passes``
    fixed-point sweeps, exact by triangularity (reference:
    zuko/transforms.py:991-1000)."""

    domain_dim = 1
    codomain_dim = 1

    def __init__(self, meta: Callable, passes: int):
        self.meta = meta
        self.passes = int(passes)

    def forward(self, x):
        return self.meta(x)(x)

    def inverse(self, y):
        x = torch.zeros_like(y)
        for _ in range(self.passes):
            x = self.meta(x).inv(y)
        return x

    def call_and_ladj(self, x):
        return self.meta(x).call_and_ladj(x)

    def inverse_and_ladj(self, y):
        x = self.inverse(y)
        _, ladj = self.meta(x).call_and_ladj(x)
        return x, -ladj


class FreeFormJacobianTransform(Transform):
    r"""Free-form Jacobian transformation (FFJORD, CNF):
    :math:`x(t_1) = x_0 + \int_{t_0}^{t_1} f_\phi(t, x) dt` (reference:
    zuko/transforms.py:1076-1179), integrated by :func:`~zuko_tpu_torch.utils.odeint`.

    The log-Jacobian is the integral of the trace of :math:`\partial_x f`,
    integrated beside ``x`` scaled by ``trace_scale = 1e-2`` (which relaxes
    its error control, as the reference does). The trace is exact, from a
    batched vector-Jacobian product over the identity (``zuko_tpu`` takes
    forward-mode columns: the same trace to roundoff), or Hutchinson's
    :math:`\varepsilon^\top J \varepsilon` with a standard-normal probe
    :math:`\varepsilon` drawn from a generator seeded with ``seed``: the same
    probe on every call at the same shape, as a PRNG key gives.

    Arguments:
        f: the dynamics, called as ``f(t, x, phi)`` (``f(t, x)`` without
            ``phi``).
        t0, t1: the integration bounds.
        phi: the parameters of ``f``, a nest of tuples, lists and dicts whose
            tensors receive gradients.
        exact: exact trace, or Hutchinson's.
        seed: the seed of the Hutchinson probe.
        max_steps: the integrator's budget of accepted steps; running out
            NaN-poisons the output.
    """

    domain_dim = 1
    codomain_dim = 1

    def __init__(self, f: Callable, t0: float = 0.0, t1: float = 1.0, phi=(),
                 atol: float = 1e-6, rtol: float = 1e-5, exact: bool = True, seed: int = None,
                 max_steps: int = 256):
        self.f = f
        self.t0 = float(t0)
        self.t1 = float(t1)
        self.phi = phi
        self.atol = float(atol)
        self.rtol = float(rtol)
        self.exact = bool(exact)
        self.seed = seed
        self.max_steps = int(max_steps)
        self.trace_scale = 1e-2

    def _odeint(self, f, x, t0, t1, phi):
        return odeint(f, x, t0, t1, phi, self.atol, self.rtol, self.max_steps)

    def forward(self, x):
        return self._odeint(self.f, x, self.t0, self.t1, self.phi)

    def inverse(self, y):
        return self._odeint(self.f, y, self.t1, self.t0, self.phi)

    @property
    def inv(self) -> Transform:
        # the reference swaps the bounds: zuko/transforms.py:1129-1138
        return FreeFormJacobianTransform(
            self.f, self.t1, self.t0, self.phi, self.atol, self.rtol, self.exact, self.seed,
            self.max_steps)

    def probe(self, x):
        """The Hutchinson probe at ``x``'s shape: standard-normal draws of a
        generator seeded with ``seed``."""
        if self.seed is None:
            raise ValueError("the Hutchinson trace needs a seed")
        generator = torch.Generator(device=x.device).manual_seed(self.seed)
        return torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)

    def call_and_ladj(self, x):
        return self.augmented(x, None if self.exact else self.probe(x))

    def augmented(self, x, eps=None):
        """``(y, ladj)`` by the integration of ``x`` beside its log-Jacobian,
        with the Hutchinson probe ``eps`` (unused by the exact trace)."""
        scale, exact, f = self.trace_scale, self.exact, self.f
        has_phi = not _empty_phi(self.phi)

        def f_aug(t, state, phi=()):
            xt, _ = state
            create = torch.is_grad_enabled()  # inside a backward pass
            with torch.enable_grad():
                if not xt.requires_grad:
                    xt = xt.detach().requires_grad_()
                dx = f(t, xt, phi) if has_phi else f(t, xt)
                if exact:
                    eye = torch.eye(xt.shape[-1], dtype=xt.dtype, device=xt.device)
                    eye = eye.expand(*xt.shape, xt.shape[-1]).movedim(-1, 0)
                    (jacobian,) = torch.autograd.grad(
                        dx, xt, eye, create_graph=create, is_grads_batched=True)
                    trace = torch.einsum("i...i->...", jacobian)
                else:
                    (vjp,) = torch.autograd.grad(dx, xt, eps, create_graph=create)
                    trace = (vjp * eps).sum(dim=-1)
            if not create:
                dx, trace = dx.detach(), trace.detach()
            return dx, trace * scale

        ladj0 = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        y, ladj = self._odeint(f_aug, (x, ladj0), self.t0, self.t1, self.phi)
        return y, ladj / scale

    def inverse_and_ladj(self, y):
        # the inverse integrates backwards: its forward ladj is the ladj of
        # this transform's inverse
        return self.inv.call_and_ladj(y)
