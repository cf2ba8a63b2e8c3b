r"""Layers of the MADE hyper-network.

Counterpart of ``zuko_tpu/nn.py``: :class:`Activation` :51, :class:`Linear`
:93, :class:`MaskedLinear` :149, :func:`masked_mlp_masks` :270 and
:class:`MaskedMLP` :329. Weights are ``(out, in)`` and the MADE mask is a
buffer named ``mask``, so parameter names match ``zuko_tpu``'s dotted names
one to one (see :mod:`zuko_tpu_torch.serial`).
"""

from __future__ import annotations

import math

from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn as nn

from .utils import resolve_device

__all__ = [
    "Activation",
    "Linear",
    "MaskedLinear",
    "MaskedMLP",
    "Residual",
    "masked_mlp_masks",
]


class Activation(nn.Module):
    """Wraps an elementwise activation callable as a module."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


class Linear(nn.Module):
    r"""Linear layer :math:`y = x W^T + b`, initialised to
    :math:`U(\pm 1/\sqrt{\text{fan-in}})` (reference: zuko/nn.py:51-119)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        bound = 1 / math.sqrt(in_features)
        self.weight = nn.Parameter(torch.empty(
            out_features, in_features, device=device, dtype=dtype
        ).uniform_(-bound, bound))
        self.bias = nn.Parameter(torch.empty(
            out_features, device=device, dtype=dtype
        ).uniform_(-bound, bound)) if bias else None
        self.in_features = int(in_features)
        self.out_features = int(out_features)

    def forward(self, x):
        y = x @ self.weight.T
        return y if self.bias is None else y + self.bias


class MaskedLinear(Linear):
    r"""Masked linear layer :math:`y = x (W \odot A)^T + b`
    (reference: zuko/nn.py:202-218). The adjacency is the buffer ``mask``.
    For a tensor on the GPU the forward runs the ``masked_linear`` kernel
    (:func:`zuko_tpu_torch.ops.masked_linear.masked_linear`, float32 only)."""

    def __init__(self, adjacency, device=None, dtype=torch.float32):
        adjacency = np.asarray(adjacency, bool)
        out_features, in_features = adjacency.shape
        super().__init__(in_features, out_features, device=device, dtype=dtype)
        self.register_buffer(
            "mask", torch.as_tensor(adjacency, dtype=dtype, device=self.weight.device)
        )

    def forward(self, x):
        if x.is_cuda:  # the kernel, or an error: never the plain version
            from .ops.masked_linear import masked_linear

            return masked_linear(x, self.weight, self.mask, self.bias)
        y = x @ (self.mask * self.weight).T
        return y if self.bias is None else y + self.bias


class Residual(nn.Module):
    r"""Residual block :math:`y = x + f(x)` (reference: zuko/nn.py:195-199)."""

    def __init__(self, *layers: nn.Module):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x):
        y = x
        for layer in self.layers:
            y = layer(y)
        return x + y


def masked_mlp_masks(
    adjacency: np.ndarray,
    hidden_features: Sequence[int] = (64, 64),
    residual: bool = False,
):
    r"""Host-side construction of MADE masks from an adjacency matrix.

    Follows the reference algorithm exactly (zuko/nn.py:271-313): merge output
    rows with identical dependencies, build the precedence matrix
    :math:`P_{ij} = [A A^T]_{ij} = \sum_k A_{jk}`, tile hidden units over
    reachable rows, and restore duplicated outputs at the last layer. Returns a
    list of per-layer masks; for ``residual=True``, entries may be
    ``("residual", mask)`` markers.

    Raises:
        ValueError: if the adjacency leads to a null Jacobian.
    """
    adjacency = np.asarray(adjacency, bool)
    out_features, in_features = adjacency.shape

    adjacency, inverse = np.unique(adjacency, axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)

    # P_ij = 1 iff row i's dependencies include row j's dependencies
    precedence = (
        adjacency.astype(np.int64) @ adjacency.astype(np.int64).T
        == adjacency.sum(axis=-1)
    )

    masks = []
    indices = None

    for i, features in enumerate((*hidden_features, out_features)):
        if i > 0:
            mask = precedence[:, indices]
        else:
            mask = adjacency

        if (~mask).all():
            raise ValueError("The adjacency matrix leads to a null Jacobian.")

        if i < len(hidden_features):
            reachable = np.nonzero(mask.sum(axis=-1))[0]
            indices = reachable[np.arange(features) % len(reachable)]
            mask = mask[indices]
        else:
            mask = mask[inverse]

        masks.append(("linear", mask))

        if residual and i < len(hidden_features):
            if 0 < i and mask.shape[0] == mask.shape[1]:
                masks.pop()
            res_mask = precedence[indices, :][:, indices]
            masks.append(("residual", res_mask))

    return masks


class MaskedMLP(nn.Module):
    r"""MADE-style masked MLP: the Jacobian entry :math:`\partial y_i /
    \partial x_j` is null wherever :math:`A_{ij} = 0`
    (reference: zuko/nn.py:221-318).

    Example:
        >>> adjacency = np.tril(np.ones((3, 3)), -1).astype(bool)
        >>> adjacency[0, 0] = True
        >>> net = MaskedMLP(adjacency, (16, 32), device="cpu")
        >>> net(torch.zeros(3)).shape
        torch.Size([3])
    """

    def __init__(
        self,
        adjacency,
        hidden_features: Sequence[int] = (64, 64),
        activation: Callable = None,
        residual: bool = False,
        device=None,
    ):
        super().__init__()
        if activation is None:
            activation = torch.relu

        specs = masked_mlp_masks(adjacency, hidden_features, residual)
        layers = []
        for i, (kind, mask) in enumerate(specs):
            last = i == len(specs) - 1
            if kind == "linear":
                layers.append(MaskedLinear(mask, device=device))
                if not last and not residual:
                    layers.append(Activation(activation))
            else:
                layers.append(Residual(
                    MaskedLinear(mask, device=device),
                    Activation(activation),
                    MaskedLinear(mask, device=device),
                ))
        self.layers = nn.ModuleList(layers)
        adjacency = np.asarray(adjacency, bool)
        self.out_features = int(adjacency.shape[0])
        self.in_features = int(adjacency.shape[1])

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x
