r"""Masked linear layer (MADE): plain PyTorch version and the CUDA kernel that
replaces the TPU kernel.

Counterpart of ``zuko_tpu/ops/masked_linear.py``. The ``masked_linear``
kernel (``csrc/masked_linear.cu``) replaces ``_masked_linear_pallas`` (:99,
``pallas_call`` at :116): ``x (W ⊙ M)ᵀ + b`` with the mask multiplied into
the weight tiles inside the kernel, so the masked weight matrix is never
written to device memory.

:func:`masked_linear` takes the plain version for a tensor that lies on the
CPU, and launches the kernel (or raises) for a CUDA tensor; the unfused
hyper-network (:class:`zuko_tpu_torch.nn.MaskedLinear`) calls it for every
CUDA tensor. The backward is not a kernel (as ``_masked_linear_tpu_bwd`` :85 is not):
it is :func:`_masked_linear_bwd`, plain PyTorch. The kernel's product runs
on the tensor cores as a 3-pass TF32 split (float32 accuracy; no plain
TF32).

:func:`plan_masked_linear` sets the kernel's launch from the shapes: its
persistent blocks, the rows of a tile and the inputs of a chunk, so that the
masked weights stay in shared memory whenever they fit.
"""

from __future__ import annotations

import contextlib
import functools

from typing import NamedTuple

import torch

from ._common import LAUNCHES, check_cuda_f32, sm_count

__all__ = ["masked_linear", "plan_masked_linear"]

_WARPS = 8  # 256 threads a block


def _budget(per_sm):
    """A block's shared memory when ``per_sm`` blocks share an SM's 233,472
    bytes, 1 KB a block reserved."""
    return (233472 - per_sm * 1024) // per_sm


class LinearPlan(NamedTuple):
    """The launch of ``masked_linear``: ``nt`` tiles of 8 outputs a warp and
    ``wc`` warps across the outputs (a chunk of ``8 nt wc``), ``rows`` a
    tile, ``kc`` inputs a chunk (all of them when the weights stay in shared
    memory, ``resident``, with two x tiles; else one), ``blocks`` persistent
    blocks and the shared memory of one."""

    nt: int
    wc: int
    rows: int
    kc: int
    blocks: int
    shared_bytes: int
    resident: bool


@functools.lru_cache(maxsize=256)
def plan_masked_linear(n, in_f, out_f, sms):
    """The launch for ``n`` rows of ``in_f -> out_f`` on a card of ``sms``
    streaming multiprocessors. One warp across the outputs up to 64 of them
    (tiles of 128 rows), else two (tiles of 64 rows, chunks of at most 256
    outputs). A block's shared memory (``shared_floats`` in
    ``csrc/masked_linear.cu``): the masked weights of a chunk split into
    their TF32 parts (twice the weights, inputs rounded up to 8) and its
    bias, and two x tiles (one for chunked weights), rows of inputs rounded
    up to 8 and padded by 4 floats. Two blocks an SM (what the kernel's
    registers allow) where that fits, else one; past that, chunks of inputs
    (multiples of 8) small enough for two."""
    wc = 1 if out_f <= 64 else 2
    nt = -(-out_f // 8) if wc == 1 else min(-(-out_f // 16), 16)
    cn, rows = 8 * nt * wc, 16 * _WARPS // wc
    resident = out_f <= cn

    def nbytes(kc, nb):
        kp = -(-kc // 8) * 8
        return 4 * (2 * kp * cn + cn + nb * rows * (kp + 4))

    kc, nb = in_f, 2 if resident else 1
    fits = [per_sm for per_sm in (2, 1) if nbytes(in_f, nb) <= _budget(per_sm)]
    per_sm = fits[0] if fits else 2
    if not fits:
        nb = 1
        kc = (_budget(2) // 4 - cn - 4 * rows) // (2 * cn + rows) // 8 * 8
    blocks = max(1, min(-(-n // rows), per_sm * sms))
    return LinearPlan(nt, wc, rows, kc, blocks, nbytes(kc, nb), nb == 2)


def _masked_linear_math(x, weight, mask, bias=None):
    """Plain version: ``x @ (mask * weight).T + bias`` over any leading
    batch dimensions."""
    y = x @ (mask * weight).T
    return y if bias is None else y + bias


def _masked_linear_bwd(g, x, weight, mask, has_bias):
    """The layer's pullback ``g (..., Out) -> (dx, dW, db)``: ``dx = g (M ⊙
    W)``, ``dW = (gᵀ x) ⊙ M``, ``db = Σ g``; the mask has no gradient."""
    dx = g @ (mask * weight)
    g2 = g.reshape(-1, g.shape[-1])
    dw = (g2.T @ x.reshape(-1, x.shape[-1])) * mask
    db = g2.sum(dim=0) if has_bias else None
    return dx, dw, db


def _masked_linear_kernel(x, weight, mask, bias):
    from ._build import check_launch, load_library

    out_f, in_f = weight.shape
    if x.shape[-1] != in_f or mask.shape != weight.shape or (
        bias is not None and bias.shape != (out_f,)
    ):
        raise ValueError(
            f"masked_linear: shapes x {tuple(x.shape)}, weight {tuple(weight.shape)},"
            f" mask {tuple(mask.shape)} do not match"
        )
    tensors = [x, weight, mask] + ([] if bias is None else [bias])
    check_cuda_f32("masked_linear", tensors)
    # leading batch dimensions are flattened, as the TPU wrapper does
    x2 = x if x.dim() == 2 else x.reshape(-1, in_f)
    x2, weight, mask = x2.contiguous(), weight.contiguous(), mask.contiguous()
    bias = None if bias is None else bias.contiguous()
    y = torch.empty(x2.shape[0], out_f, device=x.device, dtype=torch.float32)
    plan = plan_masked_linear(x2.shape[0], in_f, out_f, sm_count(x.device))
    lib = load_library("masked_linear")
    # the launch goes to x's card (a context switch only where it is not current)
    switch = x.device.index != torch.cuda.current_device()
    with torch.cuda.device(x.device) if switch else contextlib.nullcontext():
        rc = lib.masked_linear_f32(
            x2.data_ptr(), weight.data_ptr(), mask.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(),
            x2.shape[0], in_f, out_f, plan.kc, plan.blocks,
            torch.cuda.current_stream().cuda_stream,
        )
    check_launch("masked_linear", lib, "masked_linear", rc)
    LAUNCHES["masked_linear"] += 1
    return y if x.dim() == 2 else y.reshape(x.shape[:-1] + (out_f,))


class _MaskedLinearFunction(torch.autograd.Function):
    """Kernel forward, plain backward (:func:`_masked_linear_bwd`)."""

    @staticmethod
    def forward(ctx, x, weight, mask, bias):
        ctx.save_for_backward(x, weight, mask)
        ctx.has_bias = bias is not None
        return _masked_linear_kernel(x, weight, mask, bias)

    @staticmethod
    def backward(ctx, g):
        dx, dw, db = _masked_linear_bwd(g, *ctx.saved_tensors, ctx.has_bias)
        return dx, dw, None, db


def masked_linear(x, weight, mask, bias=None):
    r"""``x @ (mask * weight).T + bias`` for ``x (..., In)``, ``weight`` and
    ``mask (Out, In)``, ``bias (Out,)`` or ``None``: the ``masked_linear``
    kernel for a CUDA tensor (float32; differentiable through its
    ``autograd.Function``), the plain version for a CPU tensor."""
    if not x.is_cuda:
        return _masked_linear_math(x, weight, mask, bias)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad or (
            bias is not None and bias.requires_grad)):
        return _MaskedLinearFunction.apply(x, weight, mask, bias)
    return _masked_linear_kernel(x, weight, mask, bias)  # nothing to differentiate
