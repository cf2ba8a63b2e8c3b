r"""Spline flows.

Counterpart of ``zuko_tpu/flows/spline.py``: :class:`NSF` :30, a MAF recipe
with rational-quadratic-spline univariates, and its circular variant
:class:`NCSF` :75 with the univariate :func:`CircularRQSTransform` :65.
"""

from __future__ import annotations

from functools import partial
from math import pi

import torch

from ..distributions import BoxUniform
from ..lazy import UnconditionalDistribution
from ..transforms import CircularShiftTransform, ComposedTransform, MonotonicRQSTransform
from ..utils import resolve_device
from .autoregressive import MAF

__all__ = ["NCSF", "NSF", "CircularRQSTransform"]


class NSF(MAF):
    r"""Neural spline flow (Durkan et al., 2019).

    A masked autoregressive flow whose univariate transformations are
    monotonic rational-quadratic splines with ``bins`` bins on
    :math:`[-5, 5]` (reference recipe: zuko/flows/spline.py:21-62).
    Out-of-domain features pass through untransformed.

    Example:
        >>> flow = NSF(3, 4, transforms=2, device="cpu")
        >>> x = flow(torch.ones(4)).sample((5,))
        >>> flow(torch.ones(4)).log_prob(x).shape
        torch.Size([5])
    """

    def __init__(self, features, context=0, bins=8, slope=1e-3, **kwargs):
        super().__init__(
            features, context,
            univariate=partial(MonotonicRQSTransform, slope=slope),
            shapes=[(bins,), (bins,), (bins - 1,)],
            **kwargs,
        )


def CircularRQSTransform(*phi, slope: float = 1e-3):
    r"""Spline on the circle: a circular shift by :math:`\pi` followed by a
    rational-quadratic spline on :math:`[-\pi, \pi]` (reference:
    zuko/flows/spline.py:65-72)."""
    return ComposedTransform(
        CircularShiftTransform(bound=pi),
        MonotonicRQSTransform(*phi, bound=pi, slope=slope),
    )


class NCSF(MAF):
    r"""Neural circular spline flow (Rezende et al., 2020): circular splines
    over a box-uniform base on :math:`[-\pi - 10^{-5}, \pi + 10^{-5}]`, whose
    bounds are buffers (reference recipe: zuko/flows/spline.py:75-117).
    Features live on the half-open interval :math:`[-\pi, \pi)`.

    Example:
        >>> flow = NCSF(3, transforms=2, device="cpu")
        >>> x = flow(None).sample((5,))
        >>> flow(None).log_prob(x).shape
        torch.Size([5])
    """

    def __init__(self, features, context=0, bins=8, slope=1e-3, device=None, **kwargs):
        device = resolve_device(device)
        super().__init__(
            features, context,
            univariate=partial(CircularRQSTransform, slope=slope),
            shapes=[(bins,), (bins,), (bins - 1,)],
            device=device,
            **kwargs,
        )
        eps = 1e-5
        self.base = UnconditionalDistribution(
            BoxUniform,
            torch.full((features,), -pi - eps, device=device),
            torch.full((features,), pi + eps, device=device),
            buffer=True,
        )
