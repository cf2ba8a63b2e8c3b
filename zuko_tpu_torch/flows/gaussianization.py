r"""Gaussianization flows.

Counterpart of ``zuko_tpu/flows/gaussianization.py``:
:class:`ElementWiseTransform` :40 (the per-feature conditioner the
autoregressive recipes fall back to for ``features <= 1``) and the
:class:`GF` recipe :89 with trainable rotations interleaved.
"""

from __future__ import annotations

import math

from typing import Callable, Sequence

import torch
import torch.nn as nn

from ..distributions import DiagNormal
from ..lazy import Flow, LazyTransform, UnconditionalDistribution, UnconditionalTransform
from ..nn import MLP
from ..transforms import (
    DependentTransform,
    GaussianizationTransform,
    MonotonicAffineTransform,
    RotationTransform,
)
from ..utils import resolve_device, unpack

__all__ = ["GF", "ElementWiseTransform"]


class ElementWiseTransform(LazyTransform):
    r"""Lazy element-wise transformation: the per-feature parameters of the
    univariate come from ``MLP(context, features * total)`` if conditional,
    else from bare trainable tensors ``phi.0``, ``phi.1``, ...
    (reference: zuko/flows/gaussianization.py:28-94).

    Example:
        >>> t = ElementWiseTransform(3, 4, device="cpu")
        >>> x = torch.tensor([0.1, 0.3, -1.1])
        >>> c = torch.ones(4)
        >>> y = t(c)(x)
        >>> bool(torch.allclose(t(c).inv(y), x, atol=1e-5))
        True
    """

    def __init__(
        self,
        features: int,
        context: int = 0,
        univariate: Callable = MonotonicAffineTransform,
        shapes: Sequence = ((), ()),
        device=None,
        **kwargs,
    ):
        super().__init__()
        device = resolve_device(device)
        self.univariate = univariate
        self.shapes = tuple(tuple(s) for s in shapes)
        self.total = sum(math.prod(s) for s in self.shapes)

        if context > 0:
            self.hyper = MLP(context, features * self.total, device=device, **kwargs)
            self.phi = None
        else:
            self.hyper = None
            self.phi = nn.ParameterList(
                torch.randn(features, *s, device=device) for s in self.shapes
            )

    def forward(self, c: torch.Tensor = None):
        if c is None:
            phi = list(self.phi)
        else:
            phi = self.hyper(c)
            phi = phi.reshape(phi.shape[:-1] + (-1, self.total))
            phi = unpack(phi, self.shapes)
        return DependentTransform(self.univariate(*phi), 1)


class GF(Flow):
    r"""Gaussianization flow (Meng et al., 2020): element-wise
    :class:`~zuko_tpu_torch.transforms.GaussianizationTransform` layers of
    ``components`` mixture components with trainable
    :class:`~zuko_tpu_torch.transforms.RotationTransform` interleaved
    (reference: zuko/flows/gaussianization.py:97-155). Built on ``device``
    (default ``cuda``; see :func:`zuko_tpu_torch.utils.resolve_device`).

    Example:
        >>> flow = GF(3, transforms=2, device="cpu")
        >>> x = flow(None).sample((5,))
        >>> flow(None).log_prob(x).shape
        torch.Size([5])
    """

    def __init__(
        self,
        features: int,
        context: int = 0,
        transforms: int = 3,
        components: int = 8,
        device=None,
        **kwargs,
    ):
        device = resolve_device(device)
        layers = [
            ElementWiseTransform(
                features=features,
                context=context,
                univariate=GaussianizationTransform,
                shapes=[(components,), (components,)],
                device=device,
                **kwargs,
            )
            for _ in range(transforms)
        ]
        for i in reversed(range(1, len(layers))):
            layers.insert(i, UnconditionalTransform(
                RotationTransform, torch.randn(features, features, device=device),
            ))
        base = UnconditionalDistribution(
            DiagNormal,
            torch.zeros(features, device=device),
            torch.ones(features, device=device),
            buffer=True,
        )
        super().__init__(layers, base)
