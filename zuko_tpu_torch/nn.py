r"""Layers of the hyper-networks.

Counterpart of ``zuko_tpu/nn.py``: :class:`Activation` :51,
:class:`TwoWayELU` :61, :class:`LayerNorm` :79, :class:`Linear` :93 (with its
``stack`` of independent operators), :class:`MonotonicLinear` :142,
:class:`MaskedLinear` :149, :class:`MLP` :187, :class:`MonotonicMLP` :245,
:func:`masked_mlp_masks` :270 and :class:`MaskedMLP` :329. Weights are ``(out, in)``, the MADE mask is a buffer named ``mask``
and every stack keeps its modules under ``layers``, so parameter names
match ``zuko_tpu``'s dotted names one to one (see
:mod:`zuko_tpu_torch.serial`).
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
    "LayerNorm",
    "Linear",
    "MLP",
    "MaskedLinear",
    "MaskedMLP",
    "MonotonicLinear",
    "MonotonicMLP",
    "Residual",
    "TwoWayELU",
    "masked_mlp_masks",
]


class Activation(nn.Module):
    """Wraps an elementwise activation callable as a module."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


class TwoWayELU(nn.Module):
    r"""Splits the channels in two halves and applies :math:`\text{ELU}(x)`
    to the first, :math:`-\text{ELU}(-x)` to the second: the activation of
    :class:`MonotonicMLP` (reference: zuko/nn.py:335-353, a ``torch.nn.ELU``,
    so ``alpha`` scales :math:`e^x - 1`). ``inplace`` is accepted and
    ignored."""

    def __init__(self, alpha: float = 1.0, inplace: bool = False):
        super().__init__()
        self.alpha = float(alpha)

    def forward(self, x):
        x0, x1 = torch.chunk(x, 2, dim=-1)
        return torch.cat(
            [nn.functional.elu(x0, self.alpha), -nn.functional.elu(-x1, self.alpha)], dim=-1
        )


class LayerNorm(nn.Module):
    r"""Standardizes features along a dimension: no affine parameters,
    unbiased variance (reference: zuko/nn.py:25-48)."""

    def __init__(self, dim: int = -1, eps: float = 1e-5):
        super().__init__()
        self.dim = dim
        self.eps = float(eps)

    def forward(self, x):
        variance, mean = torch.var_mean(x, dim=self.dim, keepdim=True, correction=1)
        return (x - mean) / torch.sqrt(variance + self.eps)


class Linear(nn.Module):
    r"""Linear layer :math:`y = x W^T + b`, initialised to
    :math:`U(\pm 1/\sqrt{\text{fan-in}})`, optionally a ``stack`` of
    independent operators: a weight ``(stack, out, in)`` applied to inputs
    ``(..., stack, in)`` (reference: zuko/nn.py:51-119)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 stack: int = None, device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        shape = () if stack is None else (stack,)
        bound = 1 / math.sqrt(in_features)
        self.weight = nn.Parameter(torch.empty(
            *shape, out_features, in_features, device=device, dtype=dtype
        ).uniform_(-bound, bound))
        self.bias = nn.Parameter(torch.empty(
            *shape, out_features, device=device, dtype=dtype
        ).uniform_(-bound, bound)) if bias else None
        self.in_features = int(in_features)
        self.out_features = int(out_features)

    def _matrix(self):
        return self.weight

    def forward(self, x):
        W = self._matrix()
        y = x @ W.T if W.dim() == 2 else torch.einsum("...ij,...j->...i", W, x)
        return y if self.bias is None else y + self.bias


class MonotonicLinear(Linear):
    r"""Linear layer with positive weights, :math:`y = x |W|^T + b`
    (reference: zuko/nn.py:321-332)."""

    def _matrix(self):
        return self.weight.abs()


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


class MLP(nn.Module):
    r"""Multi-layer perceptron (reference: zuko/nn.py:122-192): linear
    layers of widths ``hidden_features`` with ``activation`` (default ReLU)
    and, with ``normalize``, a :class:`LayerNorm` between them. Further
    keyword arguments go to every :class:`Linear`.

    Example:
        >>> net = MLP(64, 1, (32, 16), activation=torch.nn.functional.elu, device="cpu")
        >>> net(torch.ones(64)).shape
        torch.Size([1])
    """

    def __init__(
        self,
        in_features: int,
        out_features: int,
        hidden_features: Sequence[int] = (64, 64),
        activation: Callable = None,
        normalize: bool = False,
        **kwargs,
    ):
        super().__init__()
        if activation is None:
            activation = torch.relu
        widths = [in_features, *hidden_features, out_features]
        layers = []
        for i, (before, after) in enumerate(zip(widths[:-1], widths[1:])):
            layers.append(self._make_linear(before, after, **kwargs))
            if i < len(widths) - 2:
                layers.append(self._make_activation(activation))
                if normalize:
                    layers.append(LayerNorm())
        self.layers = nn.ModuleList(layers)
        self.in_features = int(in_features)
        self.out_features = int(out_features)

    @staticmethod
    def _make_linear(before, after, **kwargs):
        return Linear(before, after, **kwargs)

    @staticmethod
    def _make_activation(activation):
        return Activation(activation)

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class MonotonicMLP(MLP):
    r"""MLP whose Jacobian is positive: :class:`MonotonicLinear` layers with
    :class:`TwoWayELU` between them and no normalisation (reference:
    zuko/nn.py:356-392), the network of NAF's univariates.

    Example:
        >>> net = MonotonicMLP(3, 4, (16, 32), device="cpu")
        >>> J = torch.autograd.functional.jacobian(net, torch.zeros(3))
        >>> bool((J > 0).all())
        True
    """

    def __init__(self, *args, **kwargs):
        kwargs["activation"] = None
        kwargs["normalize"] = False
        super().__init__(*args, **kwargs)

    @staticmethod
    def _make_linear(before, after, **kwargs):
        return MonotonicLinear(before, after, **kwargs)

    @staticmethod
    def _make_activation(activation):
        return TwoWayELU()


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
