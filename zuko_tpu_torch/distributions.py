r"""Distributions: the flow engine and its base.

Counterpart of ``zuko_tpu/distributions.py``: :class:`Distribution` :147,
:class:`NormalizingFlow` :1126 and :class:`DiagNormal` :1505. Sampling takes
a ``torch.Generator`` instead of a PRNG key: ``sample(sample_shape=(),
generator=None)``. ``sample`` runs without gradients; ``rsample`` is
differentiable.
"""

from __future__ import annotations

import math

from typing import Tuple

import torch

__all__ = ["DiagNormal", "Distribution", "NormalizingFlow"]

Shape = Tuple[int, ...]


class Distribution:
    r"""Abstract distribution: ``batch_shape`` independent instances, each
    over events of shape ``event_shape``."""

    batch_shape: Shape = ()
    event_shape: Shape = ()

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def rsample(self, sample_shape: Shape = (), generator=None) -> torch.Tensor:
        raise NotImplementedError

    def sample(self, sample_shape: Shape = (), generator=None) -> torch.Tensor:
        with torch.no_grad():
            return self.rsample(sample_shape, generator)

    def rsample_and_log_prob(self, sample_shape: Shape = (), generator=None):
        x = self.rsample(sample_shape, generator)
        return x, self.log_prob(x)

    def sample_and_log_prob(self, sample_shape: Shape = (), generator=None):
        with torch.no_grad():
            return self.rsample_and_log_prob(sample_shape, generator)

    def expand(self, batch_shape: Shape) -> "Distribution":
        raise NotImplementedError


class DiagNormal(Distribution):
    r"""Multivariate normal with diagonal covariance, the default flow base
    (reference: zuko/distributions.py:337-363). The last dimension of
    ``loc``/``scale`` is the event."""

    def __init__(self, loc: torch.Tensor, scale: torch.Tensor):
        self.loc, self.scale = torch.broadcast_tensors(loc, scale)

    @property
    def batch_shape(self) -> Shape:
        return tuple(self.loc.shape[:-1])

    @property
    def event_shape(self) -> Shape:
        return tuple(self.loc.shape[-1:])

    def log_prob(self, x):
        z = (x - self.loc) / self.scale
        lp = -0.5 * z**2 - torch.log(self.scale) - 0.5 * math.log(2 * math.pi)
        return lp.sum(dim=-1)

    def rsample(self, sample_shape: Shape = (), generator=None):
        eps = torch.randn(
            tuple(sample_shape) + tuple(self.loc.shape), generator=generator,
            device=self.loc.device, dtype=self.loc.dtype,
        )
        return self.loc + self.scale * eps

    def expand(self, batch_shape: Shape):
        shape = tuple(batch_shape) + self.event_shape
        return DiagNormal(self.loc.expand(shape), self.scale.expand(shape))


class NormalizingFlow(Distribution):
    r"""Pushforward of ``base`` through the inverse of ``transform``:
    :math:`p(x) = p_{base}(f(x)) |\det J_f(x)|`
    (reference: zuko/distributions.py:39-138).

    * ``log_prob`` uses the fused ``call_and_ladj``;
    * ``rsample`` pulls base draws back through :math:`f^{-1}`;
    * ``rsample_and_log_prob`` fuses one inverse pass to produce both.
    """

    def __init__(self, transform, base: Distribution):
        if transform.codomain_dim != len(base.event_shape):
            raise ValueError(
                f"the transform acts on {transform.codomain_dim} event"
                f" dimensions, the base has {len(base.event_shape)}"
            )
        self.transform = transform
        self.base = base

    @property
    def batch_shape(self) -> Shape:
        return self.base.batch_shape

    @property
    def event_shape(self) -> Shape:
        return self.base.event_shape

    def log_prob(self, x):
        z, ladj = self.transform.call_and_ladj(x)
        return self.base.log_prob(z) + ladj

    def rsample(self, sample_shape: Shape = (), generator=None):
        z = self.base.rsample(sample_shape, generator)
        return self.transform.inverse(z)

    def rsample_and_log_prob(self, sample_shape: Shape = (), generator=None):
        z = self.base.rsample(sample_shape, generator)
        x, ladj = self.transform.inverse_and_ladj(z)
        return x, self.base.log_prob(z) - ladj
