r"""Lazy distributions and transformations — the conditional DSL.

Counterpart of ``zuko_tpu/lazy.py:43-227``: a flow is a parameter-holding
``nn.Module`` whose call ``flow(c)`` builds and returns a distribution bound
to the context ``c`` (reference: zuko/lazy.py:29-49).
"""

from __future__ import annotations

from typing import Callable, Sequence, Union

import torch
import torch.nn as nn

from .distributions import Distribution, NormalizingFlow
from .transforms import ComposedTransform, Transform

__all__ = [
    "Flow",
    "LazyComposedTransform",
    "LazyDistribution",
    "LazyInverse",
    "LazyTransform",
    "UnconditionalDistribution",
    "UnconditionalTransform",
]


class LazyDistribution(nn.Module):
    r"""Abstract module whose forward pass returns a distribution
    (reference: zuko/lazy.py:29-49)."""

    def forward(self, c: torch.Tensor = None) -> Distribution:
        raise NotImplementedError


class LazyTransform(nn.Module):
    r"""Abstract module whose forward pass returns a transformation
    (reference: zuko/lazy.py:52-78)."""

    def forward(self, c: torch.Tensor = None) -> Transform:
        raise NotImplementedError

    @property
    def inv(self) -> "LazyTransform":
        return LazyInverse(self)


class LazyInverse(LazyTransform):
    r"""Lazy inverse: ``forward(c) = transform(c).inv``
    (reference: zuko/lazy.py:81-98). It flips a flow for reverse-KL sampling
    efficiency, ``Flow(flow.transform.inv, flow.base)``; the flipped flow
    shares the original's parameters."""

    def __init__(self, transform: LazyTransform):
        super().__init__()
        self.transform = transform

    def forward(self, c: torch.Tensor = None) -> Transform:
        return self.transform(c).inv

    @property
    def inv(self) -> LazyTransform:
        return self.transform


class LazyComposedTransform(LazyTransform):
    r"""Sequence of lazy transformations composed at call time
    (reference: zuko/lazy.py:101-128)."""

    def __init__(self, *transforms: LazyTransform):
        super().__init__()
        self.transforms = nn.ModuleList(transforms)

    def forward(self, c: torch.Tensor = None) -> Transform:
        return ComposedTransform(*(t(c) for t in self.transforms))


class Flow(LazyDistribution):
    r"""Lazy normalizing flow: ``forward(c)`` returns
    ``NormalizingFlow(transform(c), base(c).expand(c.shape[:-1]))``
    (reference: zuko/lazy.py:131-172). Flows whose structure the fused
    kernels represent return a distribution that routes ``log_prob`` and
    sampling through them (:mod:`zuko_tpu_torch.ops.dispatch`)."""

    def __init__(
        self,
        transform: Union[LazyTransform, Sequence[LazyTransform]],
        base: LazyDistribution,
    ):
        super().__init__()
        if isinstance(transform, (list, tuple)):
            transform = LazyComposedTransform(*transform)
        self.transform = transform
        self.base = base

    def forward(self, c: torch.Tensor = None) -> NormalizingFlow:
        transform = self.transform(c)
        if c is None:
            base = self.base(c)
        else:
            base = self.base(c).expand(c.shape[:-1])

        from .ops.dispatch import fused_dispatch_enabled, maybe_fused_flow

        if fused_dispatch_enabled(self):
            fused = maybe_fused_flow(self, transform, base, c)
            if fused is not None:
                return fused
        return NormalizingFlow(transform, base)


class _Unconditional(nn.Module):
    """Holds a constructor and its arguments; tensor arguments are registered
    as buffers (``buffer=True``) or parameters named ``_0``, ``_1``, ...
    (zuko's names; ``zuko_tpu`` calls them ``args.0``, ``args.1``)."""

    def __init__(self, f: Callable, *args, buffer: bool = False, **kwargs):
        super().__init__()
        self.f = f
        self.kwargs = dict(kwargs)
        self._consts = {}
        for i, arg in enumerate(args):
            if not torch.is_tensor(arg):
                self._consts[i] = arg
            elif buffer:
                self.register_buffer(f"_{i}", arg)
            else:
                self.register_parameter(f"_{i}", nn.Parameter(arg))
        self._nargs = len(args)

    @property
    def args(self) -> list:
        return [
            self._consts[i] if i in self._consts else getattr(self, f"_{i}")
            for i in range(self._nargs)
        ]

    def forward(self, c: torch.Tensor = None):
        return self.f(*self.args, **self.kwargs)


class UnconditionalDistribution(_Unconditional, LazyDistribution):
    r"""Unconditional lazy distribution from a constructor
    (reference: zuko/lazy.py:242-287)."""


class UnconditionalTransform(_Unconditional, LazyTransform):
    r"""Unconditional lazy transformation from a constructor
    (reference: zuko/lazy.py:290-335)."""
