r"""Bijective transformations with fused log-Jacobians.

Counterpart of ``zuko_tpu/transforms.py``: :class:`Transform` :95,
:class:`ComposedTransform` :197, :class:`DependentTransform` :284,
:class:`MonotonicAffineTransform` :584, :class:`MonotonicRQSTransform` :612
and :class:`AutoregressiveTransform` :1033. Transforms are plain objects
built per call by the lazy modules; they hold tensors, not parameters.

Convention (as in ``zuko_tpu``): ``inverse_and_ladj(y)`` returns the
log-det of the *inverse* map, i.e. minus the forward ladj at
:math:`x = f^{-1}(y)`.
"""

from __future__ import annotations

import math

from typing import Callable, Tuple

import torch
import torch.nn.functional as F

__all__ = [
    "AutoregressiveTransform",
    "ComposedTransform",
    "DependentTransform",
    "Inverse",
    "MonotonicAffineTransform",
    "MonotonicRQSTransform",
    "Transform",
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
