r"""What every kernel wrapper shares: the launch counts, the input check and
the plan of a whole-flow kernel's tier."""

from __future__ import annotations

import functools

from typing import NamedTuple

import torch

__all__ = [
    "LAUNCHES", "KernelPlan", "NSF_MODES", "PlainBackward", "RowChunkedBackward", "SHARED_BYTES",
    "WORKSPACE_BYTES", "check_cuda_f32", "narrow_plan", "reset_launches", "sm_count", "wide_plan",
    "workspace",
]

#: The NSF kernels' univariate modes that count under names of their own.
NSF_MODES = ("crqs", "sosp", "bernstein")

#: The whole-flow kernels (and their modes), each in a narrow and a wide tier.
WHOLE_FLOW = (
    "nsf_density", "nsf_apply", "nsf_sample", "nsf_sample_log_prob", "nsf_sample_raw",
    *(name for mode in NSF_MODES for name in (
        f"nsf_density_{mode}", f"nsf_apply_{mode}", f"nsf_sample_{mode}",
        f"nsf_sample_{mode}_log_prob", f"nsf_sample_{mode}_raw")),
    "gf_density", "gf_sample", "gf_sample_log_prob",
    "naf_density", "naf_sample", "naf_sample_log_prob",
    "naf_density_umnn", "naf_sample_umnn", "naf_sample_umnn_log_prob",
    "cnf_density", "cnf_sample", "cnf_sample_log_prob", "cnf_adjoint", "cnf_adjoint_log_prob",
)

#: Kernel launches per wrapper (and per mode and tier, the wide tier's under
#: ``<name>_wide``), counted where the kernel is launched and nowhere else.
LAUNCHES = {
    **{name: 0 for name in WHOLE_FLOW},
    "masked_linear": 0,
    "rqs_forward": 0,
    "rqs_inverse": 0,
    **{f"{name}_wide": 0 for name in WHOLE_FLOW},
}

#: The wide tier's workspace is taken in chunks of rows of at most this many
#: bytes (one block of rows more when a row alone is larger).
WORKSPACE_BYTES = 1 << 30
_BLOCK = 128  # rows of a block in every whole-flow kernel
#: The shared memory one block may take on an H100 (227 KB, with
#: ``cudaFuncSetAttribute`` past 48 KB).
SHARED_BYTES = 232448


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of the CUDA ``device`` (read once)."""
    return _sm_count(torch.cuda.current_device() if device.index is None else device.index)


class KernelPlan(NamedTuple):
    """How a whole-flow kernel takes a call, from the shapes alone: the tier
    (``wide``), the floats of a row's state in the wide tier's workspace
    (``slots``), the rows of one launch (``chunk_rows``), the workspace's
    bytes and those of the wide tier's descriptor buffer."""

    wide: bool
    slots: int
    chunk_rows: int
    workspace_bytes: int
    desc_bytes: int


def narrow_plan(rows: int) -> KernelPlan:
    """The narrow tier: one launch, no workspace."""
    return KernelPlan(False, 0, rows, 0, 0)


def wide_plan(slots: int, rows: int, desc_bytes: int) -> KernelPlan:
    """The wide tier: ``slots`` floats a row, in chunks of whole blocks of
    rows that keep the workspace within :data:`WORKSPACE_BYTES`."""
    most = max(_BLOCK, WORKSPACE_BYTES // (4 * slots) // _BLOCK * _BLOCK)
    chunk = min(most, max(_BLOCK, -(-rows // _BLOCK) * _BLOCK))
    return KernelPlan(True, slots, chunk, 4 * slots * chunk, desc_bytes)


def workspace(plan: KernelPlan, device):
    """``(workspace, descriptor buffer)`` of a wide plan on ``device``
    (``None`` for a narrow one): allocated with ``torch.empty``, so one that
    does not fit raises torch's own out-of-memory error."""
    if not plan.wide:
        return None, None
    return (torch.empty(plan.workspace_bytes // 4, dtype=torch.float32, device=device),
            torch.empty(plan.desc_bytes, dtype=torch.uint8, device=device))


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


class RowChunkedBackward(PlainBackward):
    """:class:`PlainBackward` whose backward runs the plain version on
    chunks of :attr:`CHUNK` rows and sums the parameters' gradients over the
    chunks in float64, for a flow whose parameters are the same for every
    row (a NAF or UNAF). Measured on an H100 for the flagship NAF's MLE
    gradient at 262,144 rows: the one float32 pass over all rows is off by
    1.5e-4 of the largest gradient (the float32 sums over the rows), chunks
    of 16,384 rows by 2.2e-6, for 12% more time; and the graph of one chunk
    is what has to fit (a UNAF's holds 17 integrand evaluations a feature
    and layer)."""

    CHUNK = 1 << 14

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        needs = ctx.needs_input_grad
        ps = [p.detach().requires_grad_(needs[4 + i]) for i, p in enumerate(params)]
        wanted = [p for p in ps if p.requires_grad]
        sums = [None] * len(wanted)
        dxs = []
        for xs, gs in zip(x.split(RowChunkedBackward.CHUNK), g.split(RowChunkedBackward.CHUNK)):
            with torch.enable_grad():
                x_ = xs.detach().requires_grad_(needs[0])
                out = ctx.math(x_, ps, *ctx.statics)
                wrt = ([x_] if needs[0] else []) + wanted
                grads = torch.autograd.grad(out, wrt, gs, allow_unused=True) if wrt else ()
            if needs[0]:
                dxs.append(grads[0])
                grads = grads[1:]
            for i, gp in enumerate(grads):
                if gp is not None:
                    sums[i] = gp.double() if sums[i] is None else sums[i] + gp
        it = iter(s if s is None else s.to(p.dtype) for s, p in zip(sums, wanted))
        return (torch.cat(dxs) if needs[0] else None, None, None, None,
                *(next(it) if p.requires_grad else None for p in ps))


def check_cuda_f32(name, tensors):
    """Raise unless every tensor is a float32 tensor on the GPU."""
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: all inputs must be on the GPU")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32 only, got {t.dtype}")

