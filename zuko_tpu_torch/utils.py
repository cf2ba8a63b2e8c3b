r"""Tensor helpers and the device rule.

Counterpart of ``zuko_tpu/utils.py`` (``broadcast`` :85, ``unpack`` :116).
"""

from __future__ import annotations

import math

from typing import Sequence, Tuple, Union

import torch

__all__ = ["broadcast", "resolve_device", "unpack"]


def resolve_device(device=None) -> torch.device:
    r"""The device rule of the package: ``None`` means ``cuda``, and asking
    for ``cuda`` without a card raises instead of dropping to the CPU.
    Pass ``device="cpu"`` to build on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "zuko_tpu_torch builds on the GPU by default and no CUDA device is"
            " available; pass device='cpu' to build on the CPU"
        )
    return device


def broadcast(*tensors: torch.Tensor, ignore: Union[int, Sequence[int]] = 0):
    r"""Broadcast tensors together, ignoring a number of trailing dimensions
    (reference semantics: zuko/utils.py:212-244).

    Example:
        >>> x, y = broadcast(torch.ones(2, 3), torch.ones(5, 1, 4), ignore=1)
        >>> x.shape, y.shape
        (torch.Size([5, 2, 3]), torch.Size([5, 2, 4]))
    """
    if isinstance(ignore, int):
        ignore = [ignore] * len(tensors)
    dims = [t.dim() - i for t, i in zip(tensors, ignore)]
    common = torch.broadcast_shapes(*(t.shape[:d] for t, d in zip(tensors, dims)))
    return [t.expand(common + t.shape[d:]) for t, d in zip(tensors, dims)]


def unpack(x: torch.Tensor, shapes: Sequence[Tuple[int, ...]]):
    r"""Split the last dimension of ``x`` into chunks of ``prod(shape)``
    elements, each reshaped to ``x.shape[:-1] + shape``
    (reference semantics: zuko/utils.py:596-622).

    Example:
        >>> a, b = unpack(torch.arange(10.0).reshape(2, 5), [(3,), (2,)])
        >>> a.shape, b.shape
        (torch.Size([2, 3]), torch.Size([2, 2]))
    """
    sizes = [math.prod(s) for s in shapes]
    chunks = torch.split(x, sizes, dim=-1)
    return [c.reshape(c.shape[:-1] + tuple(s)) for c, s in zip(chunks, shapes)]
