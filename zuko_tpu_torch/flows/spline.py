r"""Spline flows.

Counterpart of ``zuko_tpu/flows/spline.py``: :class:`NSF` :30, a MAF recipe
with rational-quadratic-spline univariates. ``NCSF`` comes with a later
slice of the port.
"""

from __future__ import annotations

from functools import partial

from .autoregressive import MAF
from ..transforms import MonotonicRQSTransform

__all__ = ["NSF"]


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
