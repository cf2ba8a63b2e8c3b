r"""What every kernel wrapper shares: the launch counts and the input check."""

from __future__ import annotations

import torch

__all__ = ["LAUNCHES", "PlainBackward", "check_cuda_f32", "reset_launches"]

#: Kernel launches per wrapper (and per sampling mode), counted where the
#: kernel is launched and nowhere else.
LAUNCHES = {
    "nsf_density": 0,
    "nsf_apply": 0,
    "nsf_sample": 0,
    "nsf_sample_log_prob": 0,
    "nsf_sample_raw": 0,
    "masked_linear": 0,
    "rqs_forward": 0,
    "rqs_inverse": 0,
    "gf_density": 0,
    "gf_sample": 0,
    "gf_sample_log_prob": 0,
    "naf_density": 0,
    "naf_sample": 0,
    "naf_sample_log_prob": 0,
}


def reset_launches():
    """Set every launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class PlainBackward(torch.autograd.Function):
    """A density kernel's forward, its plain version's backward:
    ``apply(x, kernel, math, statics, *params)`` returns ``kernel(x, params,
    *statics)``; the backward recomputes ``math(x, params, *statics)`` on the
    saved inputs and differentiates it, as ``zuko_tpu``'s ``_gf_bwd`` and
    ``_naf_density_bwd`` do. There is no backward kernel."""

    @staticmethod
    def forward(ctx, x, kernel, math, statics, *params):
        ctx.math, ctx.statics = math, statics
        ctx.save_for_backward(x, *params)
        return kernel(x, params, *statics)

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        needs = ctx.needs_input_grad
        with torch.enable_grad():
            x_ = x.detach().requires_grad_(needs[0])
            ps = [p.detach().requires_grad_(needs[4 + i]) for i, p in enumerate(params)]
            out = ctx.math(x_, ps, *ctx.statics)
            wrt = [t for t in [x_, *ps] if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, g, allow_unused=True))
        dx = next(grads) if needs[0] else None
        return (dx, None, None, None, *(next(grads) if p.requires_grad else None for p in ps))


def check_cuda_f32(name, tensors):
    """Raise unless every tensor is a float32 tensor on the GPU."""
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: all inputs must be on the GPU")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32 only, got {t.dtype}")

