r"""Autoregressive flows and transformations.

Counterpart of ``zuko_tpu/flows/autoregressive.py``:
:class:`MaskedAutoregressiveTransform` :56 (the MADE conditioner, with
``order``/``passes`` grouping and custom adjacency; a single feature gets an
:class:`~zuko_tpu_torch.flows.gaussianization.ElementWiseTransform`) and
:class:`MAF` :181.
"""

from __future__ import annotations

import math

from functools import partial
from typing import Callable, Sequence

import numpy as np
import torch

from ..distributions import DiagNormal
from ..lazy import Flow, LazyTransform, UnconditionalDistribution
from ..nn import MaskedMLP
from ..transforms import (
    AutoregressiveTransform,
    DependentTransform,
    MonotonicAffineTransform,
)
from ..utils import broadcast, resolve_device, unpack
from .gaussianization import ElementWiseTransform

__all__ = ["MAF", "MaskedAutoregressiveTransform"]


def dag_diameter(adjacency: np.ndarray) -> int:
    r"""Diameter of a DAG via topological generations; raises on cycles
    (reference: zuko/flows/autoregressive.py:154-185)."""
    adjacency = np.asarray(adjacency, bool)
    generations = 0
    indegree = adjacency.sum(axis=1).tolist()
    zero_indegree = [n for n, d in enumerate(indegree) if d == 0]
    while zero_indegree:
        this_generation, zero_indegree = zero_indegree, []
        for node in this_generation:
            for child in np.nonzero(adjacency[:, node])[0]:
                indegree[child] -= 1
                if indegree[child] == 0:
                    zero_indegree.append(int(child))
        generations += 1
    if any(d != 0 for d in indegree):
        raise ValueError("The graph contains cycles.")
    return generations


class MaskedAutoregressiveTransform(LazyTransform):
    r"""Lazy masked autoregressive transformation (MADE conditioner)
    (reference semantics: zuko/flows/autoregressive.py:24-218).

    The hyper-network's outputs are feature-major: the ``total`` parameters
    of feature ``f`` are outputs ``f * total ... (f + 1) * total - 1``.
    With ``features <= 1`` there is nothing to mask, and the constructor
    returns an :class:`ElementWiseTransform` instead
    (zuko/flows/autoregressive.py:73-86).
    """

    def __new__(cls, features: int = None, context: int = 0, passes: int = None,
                order=None, adjacency=None, *args, **kwargs):
        if features is None or features > 1:
            return super().__new__(cls)
        return ElementWiseTransform(features, context, *args, **kwargs)

    def __init__(
        self,
        features: int,
        context: int = 0,
        passes: int = None,
        order=None,
        adjacency=None,
        univariate: Callable = MonotonicAffineTransform,
        shapes: Sequence = ((), ()),
        device=None,
        **kwargs,
    ):
        super().__init__()
        self.univariate = univariate
        self.shapes = tuple(tuple(s) for s in shapes)
        self.total = sum(math.prod(s) for s in self.shapes)

        if adjacency is None:
            if passes is None:
                passes = features
            order = np.arange(features) if order is None else np.asarray(order, int)
            if order.shape != (features,):
                raise ValueError(f"'order' should be a vector of {features} elements.")
            self.passes = min(max(passes, 1), features)
            order = order // int(math.ceil(features / self.passes))
            adjacency = order[:, None] > order
            adjacency_context = None
        else:
            adjacency = np.asarray(adjacency, bool)
            if adjacency.ndim != 2 or adjacency.shape[0] != features or (
                adjacency.shape[1] not in (features, features + context)
            ):
                raise ValueError(
                    f"'adjacency' should be a ({features}, {features}) or"
                    f" ({features}, {features + context}) matrix."
                )
            adjacency_context = (
                adjacency[:, features:] if adjacency.shape[1] > features else None
            )
            adjacency = adjacency[:, :features]
            if not adjacency.diagonal().all():
                raise ValueError("'adjacency' should have ones on the diagonal.")
            adjacency = adjacency & ~np.eye(features, dtype=bool)
            self.passes = dag_diameter(adjacency)

        if context > 0:
            if adjacency_context is None:
                adjacency_context = np.ones((features, context), bool)
            adjacency = np.concatenate([adjacency, adjacency_context], axis=1)

        adjacency = np.repeat(adjacency, repeats=self.total, axis=0)
        self.hyper = MaskedMLP(adjacency, device=device, **kwargs)

    def meta(self, c, x):
        # reference: zuko/flows/autoregressive.py:207-215
        if c is not None:
            x = torch.cat(broadcast(x, c, ignore=1), dim=-1)
        phi = self.hyper(x)
        phi = phi.reshape(phi.shape[:-1] + (-1, self.total))
        phi = unpack(phi, self.shapes)
        return DependentTransform(self.univariate(*phi), 1)

    def forward(self, c: torch.Tensor = None):
        return AutoregressiveTransform(partial(self.meta, c), self.passes)


class MAF(Flow):
    r"""Masked autoregressive flow (Papamakarios et al., 2017).

    Orders alternate ascending/descending between transformations, or are
    random permutations with ``randperm=True``
    (reference: zuko/flows/autoregressive.py:221-316). Built on
    ``device`` (default ``cuda``; see :func:`zuko_tpu_torch.utils.resolve_device`).
    """

    def __init__(
        self,
        features: int,
        context: int = 0,
        transforms: int = 3,
        randperm: bool = False,
        device=None,
        **kwargs,
    ):
        device = resolve_device(device)
        orders = [np.arange(features), np.arange(features)[::-1]]
        layers = [
            MaskedAutoregressiveTransform(
                features=features,
                context=context,
                order=(
                    torch.randperm(features).numpy() if randperm else orders[i % 2]
                ),
                device=device,
                **kwargs,
            )
            for i in range(transforms)
        ]
        base = UnconditionalDistribution(
            DiagNormal,
            torch.zeros(features, device=device),
            torch.ones(features, device=device),
            buffer=True,
        )
        super().__init__(layers, base)
