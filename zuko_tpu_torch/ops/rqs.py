r"""Element-wise rational-quadratic spline (forward / inverse and the
log-Jacobian): plain PyTorch version and the CUDA kernel that replaces the
TPU kernel.

Counterpart of ``zuko_tpu/ops/rqs.py``. The ``rqs`` kernel (``csrc/rqs.cu``)
replaces ``_pallas_rqs`` (:92, ``pallas_call`` at :106): given each element's
``K + 1`` horizontal, vertical and derivative knots, the bin search, the
rational-quadratic evaluation (or its closed-form inverse) and the
log-Jacobian in one pass, for any number of bins (the knots are read where
they lie). Its arithmetic is the device code the whole-flow kernels use
(``csrc/rqs.cuh``).

:func:`rqs_forward` and :func:`rqs_inverse` take the plain version for a
tensor that lies on the CPU, and launch the kernel (or raise) for a CUDA
tensor; the unfused spline transform calls them for every CUDA tensor. The
backward is not a
kernel (``zuko_tpu/ops/rqs.py:174`` is not either): it differentiates the
plain version.
"""

from __future__ import annotations

import torch

from ._common import LAUNCHES, check_cuda_f32

__all__ = ["rqs_forward", "rqs_inverse"]

def _rqs_math(x, hs, vs, ds, inverse: bool):
    """Plain version on flat elements (counterpart of ``_rqs_math`` :34):
    ``x (m,)``, ``hs, vs, ds (m, K + 1)`` -> ``(out (m,), ladj (m,))``. An
    element outside ``[knot_0, knot_K)`` passes through with ``ladj = 0``;
    the inverse's ``ladj`` is that of the inverse map."""
    K = hs.shape[-1] - 1
    seq = vs if inverse else hs
    k = torch.sum(seq < x[:, None], dim=-1) - 1
    mask = (0 <= k) & (k < K)
    k = (k % K)[:, None]

    def take(arr, idx):
        return torch.gather(arr, -1, idx)[:, 0]

    x0, x1 = take(hs, k), take(hs, k + 1)
    y0, y1 = take(vs, k), take(vs, k + 1)
    d0, d1 = take(ds, k), take(ds, k + 1)
    s = (y1 - y0) / (x1 - x0)

    if not inverse:
        z = torch.where(mask, (x - x0) / (x1 - x0), 0.0)
    else:
        y_ = torch.where(mask, x - y0, 0.0)
        a = (y1 - y0) * (s - d0) + y_ * (d0 + d1 - 2 * s)
        b = (y1 - y0) * d0 - y_ * (d0 + d1 - 2 * s)
        c = -s * y_
        disc = torch.clamp(b**2 - 4 * a * c, min=0.0)
        z = torch.where(mask, 2 * c / (-b - torch.sqrt(disc)), 0.0)

    z1 = z * (1 - z)
    denom = s + (d0 + d1 - 2 * s) * z1
    jac = s**2 * (2 * s * z1 + d0 * (1 - z) ** 2 + d1 * z**2) / denom**2
    log_jac = torch.log(jac)

    if not inverse:
        out = y0 + (y1 - y0) * (s * z**2 + d0 * z1) / denom
        ladj = torch.where(mask, log_jac, 0.0)
    else:
        out = x0 + z * (x1 - x0)
        ladj = torch.where(mask, -log_jac, 0.0)
    return torch.where(mask, out, x), ladj


def _flat(x, hs, vs, ds):
    """Broadcast ``x`` against the knots' batch shape (as ``_dispatch``
    :125) and flatten: ``(shape, x (m,), hs, vs, ds (m, K + 1))``."""
    shape = torch.broadcast_shapes(x.shape, hs.shape[:-1], vs.shape[:-1], ds.shape[:-1])
    kp1 = hs.shape[-1]
    if vs.shape[-1] != kp1 or ds.shape[-1] != kp1 or kp1 < 2:
        raise ValueError("rqs: the knot arrays must share their last size, K + 1 >= 2")
    return (shape, x.expand(shape).reshape(-1),
            *(k.expand(shape + (kp1,)).reshape(-1, kp1) for k in (hs, vs, ds)))


def _math_nd(x, hs, vs, ds, inverse):
    """The plain version over arbitrary batch shapes."""
    shape, *flat = _flat(x, hs, vs, ds)
    out, ladj = _rqs_math(*flat, inverse)
    return out.reshape(shape), ladj.reshape(shape)


def _rqs_bwd(cotangents, inputs, inverse, needs):
    """Pullback of the plain version: ``cotangents = (g_out, g_ladj)`` ->
    one gradient (or ``None`` where ``needs`` is false) per input."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(need) for t, need in zip(inputs, needs)]
        outs = _math_nd(*ins, inverse)
        wrt = [t for t in ins if t.requires_grad]
        grads = iter(torch.autograd.grad(outs, wrt, cotangents, allow_unused=True))
    return tuple(next(grads) if t.requires_grad else None for t in ins)


def _rqs_kernel(x, hs, vs, ds, inverse):
    from ._build import check_launch, load_library

    name = "rqs_inverse" if inverse else "rqs_forward"
    check_cuda_f32(name, [x, hs, vs, ds])
    shape, *flat = _flat(x, hs, vs, ds)
    xf, hf, vf, df = (t.contiguous() for t in flat)
    K = hf.shape[-1] - 1
    out, ladj = torch.empty_like(xf), torch.empty_like(xf)
    lib = load_library("rqs")
    with torch.cuda.device(x.device):
        rc = lib.rqs_f32(
            xf.data_ptr(), hf.data_ptr(), vf.data_ptr(), df.data_ptr(),
            out.data_ptr(), ladj.data_ptr(), K, xf.numel(), int(inverse),
            torch.cuda.current_stream().cuda_stream,
        )
    check_launch(name, lib, "rqs", rc)
    LAUNCHES[name] += 1
    return out.reshape(shape), ladj.reshape(shape)


class _RQSFunction(torch.autograd.Function):
    """Kernel forward; the backward differentiates the plain version
    (:func:`_rqs_bwd`)."""

    @staticmethod
    def forward(ctx, inverse, x, hs, vs, ds):
        ctx.inverse = inverse
        ctx.save_for_backward(x, hs, vs, ds)
        return _rqs_kernel(x, hs, vs, ds, inverse)

    @staticmethod
    def backward(ctx, g_out, g_ladj):
        grads = _rqs_bwd((g_out, g_ladj), ctx.saved_tensors, ctx.inverse,
                         ctx.needs_input_grad[1:])
        return (None, *grads)


def _rqs(x, horizontal, vertical, derivatives, inverse):
    if not x.is_cuda:
        return _math_nd(x, horizontal, vertical, derivatives, inverse)
    return _RQSFunction.apply(inverse, x, horizontal, vertical, derivatives)


def rqs_forward(x, horizontal, vertical, derivatives):
    r"""Spline forward and its log-Jacobian, ``x (*)`` against knots
    ``(*, K + 1)`` (broadcast): the ``rqs`` kernel for a CUDA tensor
    (float32; differentiable through its ``autograd.Function``), the plain
    version for a CPU tensor."""
    return _rqs(x, horizontal, vertical, derivatives, False)


def rqs_inverse(y, horizontal, vertical, derivatives):
    r"""Spline inverse and the log-Jacobian of the inverse map; see
    :func:`rqs_forward`."""
    return _rqs(y, horizontal, vertical, derivatives, True)
