r"""Polynomial flows.

Counterpart of ``zuko_tpu/flows/polynomial.py``: the sum-of-squares
polynomial flow :class:`SOSPF` :40, whose univariate
:func:`ShiftedSOSPTransform` :23 adds a learned shift to a
:class:`~zuko_tpu_torch.transforms.SOSPolynomialTransform`, with a softclip
between its layers (``_interleave_softclip`` :31), and the Bernstein
polynomial flow :class:`BPF` :78 of
:class:`~zuko_tpu_torch.transforms.BoundedBernsteinTransform` univariates.
"""

from __future__ import annotations

from functools import partial

from ..lazy import UnconditionalTransform
from ..transforms import (
    AdditiveTransform,
    BoundedBernsteinTransform,
    ComposedTransform,
    SoftclipTransform,
    SOSPolynomialTransform,
)
from .autoregressive import MAF

__all__ = ["BPF", "SOSPF", "ShiftedSOSPTransform"]


def ShiftedSOSPTransform(a, constant, slope: float = 1e-3):
    r"""A sum-of-squares polynomial transformation followed by a learned
    shift (reference: zuko/flows/polynomial.py:23-29)."""
    return ComposedTransform(SOSPolynomialTransform(a, slope=slope), AdditiveTransform(constant))


def _interleave_softclip(lazy_transforms, bound: float = 11.0):
    """Insert ``SoftclipTransform(bound)`` between the autoregressive layers,
    which keeps the features inside the polynomials' invertibility domain
    (reference: zuko/flows/polynomial.py:73-76)."""
    for i in reversed(range(1, len(lazy_transforms))):
        lazy_transforms.insert(i, UnconditionalTransform(SoftclipTransform, bound=bound))


class SOSPF(MAF):
    r"""Sum-of-squares polynomial flow (Jaini et al., 2019): the univariate is
    the exact integral of the mean of ``polynomials`` squared polynomials of
    degree ``degree``, plus a shift (reference recipe:
    zuko/flows/polynomial.py:32-76). Invertible on :math:`[-10, 10]`.

    Example:
        >>> flow = SOSPF(3, transforms=2, device="cpu")
        >>> flow(None).log_prob(torch.zeros(5, 3)).shape
        torch.Size([5])
    """

    def __init__(self, features, context=0, degree=4, polynomials=3, slope=1e-3, **kwargs):
        super().__init__(
            features, context,
            univariate=partial(ShiftedSOSPTransform, slope=slope),
            shapes=[(polynomials, degree + 1), ()],
            **kwargs,
        )
        _interleave_softclip(self.transform.transforms)


class BPF(MAF):
    r"""Bernstein polynomial flow (Sick et al., 2020; Arpogaus et al., 2022):
    bounded Bernstein univariates of ``degree + 1`` raw coefficients on
    :math:`[-5, 5]` (reference recipe: zuko/flows/polynomial.py:79-117),
    the identity's line outside.

    Example:
        >>> flow = BPF(3, transforms=2, device="cpu")
        >>> flow(None).log_prob(torch.zeros(5, 3)).shape
        torch.Size([5])
    """

    def __init__(self, features, context=0, degree=16, **kwargs):
        super().__init__(
            features, context,
            univariate=BoundedBernsteinTransform,
            shapes=[(degree + 1,)],
            **kwargs,
        )
