r"""zuko_tpu_torch — the PyTorch/CUDA port of ``zuko_tpu`` for NVIDIA Hopper.

The package mirrors ``zuko_tpu``'s module names. Flows are ``nn.Module``s
built on the GPU by default (``device=None`` means ``cuda``; without a card
they raise, pass ``device="cpu"`` for the CPU). ``flow(c)`` returns a
distribution whose ``log_prob``, ``sample`` and ``sample_and_log_prob`` run
through hand-written CUDA kernels when the flow lies on the GPU
(:mod:`zuko_tpu_torch.ops`). Sampling takes a ``torch.Generator``:
``sample(sample_shape=(), generator=None)``; ``rsample`` is its
differentiable form. :mod:`zuko_tpu_torch.parallel` trains a flow by maximum
likelihood or reverse KL.

Example:
    >>> flow = NSF(3, 5, transforms=3, device="cpu")
    >>> c = torch.ones(5)
    >>> x = flow(c).sample((64,))
    >>> flow(c).log_prob(x).shape
    torch.Size([64])
"""

from . import data, parallel
from .distributions import NormalizingFlow
from .flows import BPF, CNF, GF, MAF, NAF, NCSF, NSF, SOSPF, UNAF, Flow
from .parallel import make_mle_step, make_reverse_kl_step, train_mle
from .serial import load_params

__all__ = [
    "BPF",
    "CNF",
    "Flow",
    "GF",
    "MAF",
    "NAF",
    "NCSF",
    "NSF",
    "NormalizingFlow",
    "SOSPF",
    "UNAF",
    "data",
    "load_params",
    "make_mle_step",
    "make_reverse_kl_step",
    "parallel",
    "train_mle",
]
