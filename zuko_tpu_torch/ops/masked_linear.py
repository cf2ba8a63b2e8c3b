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
it is :func:`_masked_linear_bwd`, plain PyTorch.
"""

from __future__ import annotations

import torch

from ._common import LAUNCHES, check_cuda_f32

__all__ = ["masked_linear"]


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
    x2, weight, mask = x.reshape(-1, in_f).contiguous(), weight.contiguous(), mask.contiguous()
    bias = None if bias is None else bias.contiguous()
    y = torch.empty(x2.shape[0], out_f, device=x.device, dtype=torch.float32)
    lib = load_library("masked_linear")
    with torch.cuda.device(x.device):
        rc = lib.masked_linear_f32(
            x2.data_ptr(), weight.data_ptr(), mask.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(),
            x2.shape[0], in_f, out_f, torch.cuda.current_stream().cuda_stream,
        )
    check_launch("masked_linear", lib, "masked_linear", rc)
    LAUNCHES["masked_linear"] += 1
    return y.reshape(x.shape[:-1] + (out_f,))


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
    return _MaskedLinearFunction.apply(x, weight, mask, bias)
