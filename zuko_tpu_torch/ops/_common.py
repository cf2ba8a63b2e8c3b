r"""What every kernel wrapper shares: the launch counts and the input check."""

from __future__ import annotations

import torch

__all__ = ["LAUNCHES", "check_cuda_f32", "reset_launches"]

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
}


def reset_launches():
    """Set every launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def check_cuda_f32(name, tensors):
    """Raise unless every tensor is a float32 tensor on the GPU."""
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: all inputs must be on the GPU")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32 only, got {t.dtype}")

