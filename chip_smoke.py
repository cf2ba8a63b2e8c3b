#!/usr/bin/env python3
r"""Smoke run of the PyTorch port (``zuko_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the CUDA kernels from ``zuko_tpu_torch/ops/csrc`` into ``build/``,
then drives the port's two main paths through the public API.

**Serving**: the flagship NSF (D=6, 3 transforms, 64x64 MADE, K=8, float32,
the committed ``zuko_tpu_torch/assets/nsf_flagship.npz`` weights) and a
conditional NSF(3, 5) through ``flow(c).log_prob``, ``.sample`` and
``.sample_and_log_prob``.

**Training**, at the flagship's width from seeded random weights, steps of
262,144 rows: (a) maximum likelihood (``make_mle_step``) on the samples the
serving phase drew; (b) reverse KL through the IFT
(``make_reverse_kl_step``) on a ring energy; (c) the same through the
inverted flow ``Flow(flow.transform.inv, flow.base)``, whose ``log_prob``
is then read at its own samples; (d) maximum likelihood on the unfused path
(``ZUKO_TPU_TORCH_FUSED_DISPATCH=0``), whose layers run the per-op kernels,
followed by a draw from the trained flow.

It checks:

* the flagship density through the kernel against ``tools/nsf_truth_f64.npz``
  (max |diff| <= 1e-4);
* every kernel against its plain PyTorch version in float64 on the card:
  the whole-flow kernels at 1M rows for both flows and for a MAF (the
  kernels' affine branch): density, log q, the apply's ``T(x)`` and every
  sum of ladjs max <= 1e-4; samples max <= 1e-3, median <= 1e-5 (the
  spline's minimum slope 1e-3 can amplify float32 rounding a thousandfold in
  the inverse); log q also against the density kernel at the returned
  points; the raw-mode solve also by its round trip through the apply
  kernel; ``masked_linear`` at the flagship's three layer shapes and a
  ragged one, relative to each output's magnitude sum |x||W| + |b| <= 1e-5;
  ``rqs_forward`` / ``rqs_inverse`` at 6M elements, a tenth of them outside
  the spline's domain, and their round trip; and each of them again, under
  the same tolerances, at the 262,144 rows the training steps give it;
* the gradient through each ``autograd.Function`` (kernel forward, plain
  float32 backward) against float64 plain autograd at 262,144 rows: each
  parameter's largest |diff| over its largest |gradient| <= 1e-4, each
  input's gradient normwise <= 1e-3. This holds the Functions' wiring and
  their float32 backward, not the kernels;
* that each main path launched its kernels (launch counts, zeroed just
  before each phase and read just after it), and that every training loss
  is finite and falls (mean of the last 5 steps below the first 5).

Then it times each kernel, its plain version (float32, on the card), its
bound and, for ``masked_linear``, the one PyTorch call that computes the
same function; one training step of each of (a)-(d) on the host clock; and
prints the card's name and power limit, one JSON line ``{"kernels": [...]}``
and, last, ``{"ok": true, "device": {...}}``. Any failed check raises, so
the script exits non-zero and prints no result; it also fails without a CUDA
device and outside a checkout of the repository.
"""

import copy
import json
import math
import os
import statistics
import subprocess
import sys
import time

from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
ROWS = 1 << 20
GRAD_ROWS = 1 << 18
TRAIN_STEPS, UNFUSED_STEPS = 20, 5
# the per-op kernels take a fraction of a millisecond, and the card's clock
# is still rising over the first few launches after host work: more runs
PER_OP_RUNS = 21
# NVIDIA H100 SXM data sheet (700 W): float32 outside the tensor cores, and
# HBM3. The bound of a kernel is the larger of its operations over the first
# and its bytes (inputs read once, outputs written once) over the second.
FP32_PEAK = 67e12
HBM_RATE = 3.35e12
TOL_DENSITY = 1e-4
TOL_SAMPLE_MAX, TOL_SAMPLE_MEDIAN = 1e-3, 1e-5
TOL_LINEAR = 1e-5
# Gradients against float64: each parameter's largest |diff| over its
# largest |gradient|; the input gradient normwise, since at the few rows
# where the spline's slope nears its floor the derivative of its log-slope
# loses digits in float32 (a 2e-2 max-wise error at 262,144 rows on the CPU
# came with 1.1e-4 normwise).
TOL_GRAD_PARAMS, TOL_GRAD_INPUT = 1e-4, 1e-3
# The gradient of a solve x = T^-1(z) with respect to z divides by the
# spline's slope, as small as 1e-3, so float32 rounding in x and in the slope
# is amplified a thousandfold at the few rows near the floor: 2.1e-3 normwise
# (0.18 max-wise) at 262,144 rows on an H100, with the parameters' gradients
# of the same run at 6e-5.
TOL_GRAD_SOLVE_INPUT = 1e-2
CSRC = "zuko_tpu_torch/ops/csrc/"


def check(ok, message):
    if not ok:
        raise RuntimeError(f"chip_smoke: {message}")


def time_ms(fn, runs):
    """Per-run device times (CUDA events, each run synchronised) after one
    warm-up run, and their median."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), times


def host_ms(fn, runs):
    """Host-clock times between two synchronisations, after one warm-up
    run, and their median."""
    times = []
    for _ in range(runs + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times[1:]), times[1:]


def fmt(times):
    return ["%.3f" % t for t in times]


def spline_ops(univ, K):
    """Operations of one univariate evaluation (forward or inverse),
    counted from the kernel's source: for the spline, 4 per raw parameter
    (slope clamp), 4 per softmax entry, 3 per knot, 1 per derivative exp,
    and :func:`rqs_ops` for the evaluation."""
    if univ == "affine":
        return 6
    return 4 * (3 * K - 1) + 4 * 2 * K + 3 * 2 * K + (K - 1) + rqs_ops(K)


def rqs_ops(K):
    """Operations of one spline evaluation given its knots: K + 1 bin
    compares and about 25 for the rational function and its log or its
    root."""
    return (K + 1) + 25


def hyper_ops(ps):
    """Operations of one hyper-net pass, counted from its masks: the
    multiply-adds of the entries the MADE mask keeps, plus the biases. The
    kernel also multiplies the masked-out zeros; the function does not need
    them."""
    return sum(2 * int(M.sum().item()) + b.numel() for b, M in zip(ps[1::3], ps[2::3]))


def bound(ops, nbytes):
    t_ops, t_bytes = ops / FP32_PEAK, nbytes / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def compare_grads(label, got, want, n_inputs=1, tol_input=TOL_GRAD_INPUT):
    """Hold float32 gradients ``got`` against float64 ``want``: the first
    ``n_inputs`` entries are inputs (normwise), the rest parameters
    (max-relative)."""
    diffs = [(a.double() - b, b) for a, b in zip(got, want)]
    input_norm = max((d.norm() / b.norm().clamp_min(1e-30)).item() for d, b in diffs[:n_inputs])
    input_max = max(
        (d.abs().max() / b.abs().max().clamp_min(1e-30)).item() for d, b in diffs[:n_inputs])
    params_max = max(
        ((d.abs().max() / b.abs().max().clamp_min(1e-30)).item() for d, b in diffs[n_inputs:]),
        default=0.0)
    print(f"{label} gradient (Function, f32) vs f64 plain autograd:"
          f" parameters worst max-relative {params_max:.3e}; inputs normwise"
          f" {input_norm:.3e}, max-relative {input_max:.3e}")
    check(all(bool(torch.isfinite(a).all()) for a in got), f"{label} gradient is not finite")
    check(params_max <= TOL_GRAD_PARAMS, f"{label} gradient (parameters)")
    check(input_norm <= tol_input, f"{label} gradient (inputs)")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import zuko_tpu_torch as zt

    from zuko_tpu_torch import ops
    from zuko_tpu_torch.lazy import Flow
    from zuko_tpu_torch.ops import _build, ift, masked_linear, nsf_fused, rqs
    from zuko_tpu_torch.ops.dispatch import (
        FusedAutoregressiveFlow,
        FusedInvertedAutoregressiveFlow,
    )
    from zuko_tpu_torch.transforms import MonotonicRQSTransform

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    t_start = time.perf_counter()

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)

    # 2. build every kernel from the sources in the checkout
    t0 = time.perf_counter()
    reports = _build.build_all(force=True)
    print(f"build: {time.perf_counter() - t0:.1f} s ({', '.join(reports)})")
    check(set(reports) == {"nsf_fused", "masked_linear", "rqs"}, f"built {sorted(reports)}")
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  {name}: {line.strip()}")

    # the flagship (committed zuko_tpu weights) and a conditional NSF
    flagship = zt.NSF(6, 0, transforms=3, device=dev)
    zt.load_params(flagship, ROOT / "zuko_tpu_torch" / "assets" / "nsf_flagship.npz")
    torch.manual_seed(0)
    conditional = zt.NSF(3, 5, transforms=3, device=dev)
    maf = zt.MAF(6, 0, transforms=3, device=dev)  # the kernels' affine branch
    truth = np.load(ROOT / "tools" / "nsf_truth_f64.npz")
    gen = torch.Generator(device=dev).manual_seed(0)
    x_truth = torch.as_tensor(truth["x"], device=dev)
    x_big = torch.randn(ROWS, 6, generator=gen, device=dev)
    cx_big = torch.randn(ROWS, 3, generator=gen, device=dev)
    c_big = torch.randn(ROWS, 5, generator=gen, device=dev)
    c_few = torch.randn(1024, 5, generator=gen, device=dev)

    # 3. serve through the public API; counts zeroed just before, read after
    served = ("nsf_density", "nsf_sample", "nsf_sample_log_prob")
    ops.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        dist = flagship(None)
        lp_truth = dist.log_prob(x_truth)
        lp_big = dist.log_prob(x_big)
        xs = dist.sample((ROWS,), generator=gen)
        xs_l, lq = dist.sample_and_log_prob((ROWS,), generator=gen)
        cdist = conditional(c_big)
        clp = cdist.log_prob(cx_big)
        cfew = conditional(c_few)
        cxs = cfew.sample((4,), generator=gen)
        cxs_l, clq = cfew.sample_and_log_prob((4,), generator=gen)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = {name: ops.LAUNCHES[name] for name in served}
    print(f"serving phase: {serve_s:.3f} s, launches {launches}")
    check(isinstance(dist, FusedAutoregressiveFlow) and isinstance(cdist, FusedAutoregressiveFlow),
          "flows on the GPU did not dispatch to the fused kernels")
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched by the served path")
    shapes = [
        (lp_truth, (4096,)), (lp_big, (ROWS,)), (xs, (ROWS, 6)), (xs_l, (ROWS, 6)),
        (lq, (ROWS,)), (clp, (ROWS,)), (cxs, (4, 1024, 3)), (cxs_l, (4, 1024, 3)),
        (clq, (4, 1024)),
    ]
    for t, shape in shapes:
        check(tuple(t.shape) == shape, f"shape {tuple(t.shape)} != {shape}")
        check(bool(torch.isfinite(t).all()), "non-finite values on the served path")
    err_truth = (lp_truth.double() - torch.as_tensor(truth["lp"], device=dev)).abs()
    print(f"flagship log_prob vs f64 truth: max {err_truth.max().item():.3e}"
          f" median {err_truth.median().item():.3e}")
    check(err_truth.max().item() <= TOL_DENSITY, "flagship density vs f64 truth")

    # 4-5. every whole-flow kernel (both univariate branches) against its
    # plain version, float64 on the card
    def plain_args(flow, dtype):
        params, layout, cfg = nsf_fused._flatten_flow(flow)
        params = [p.detach().to(dtype) for p in params]
        F = params[-3].shape[0] // nsf_fused._univ_size(cfg["univ"], cfg["bins"])
        return params, layout, (F, cfg["bins"], cfg["bound"], cfg["slope"], cfg["univ"])

    def leaves(ps0):
        # every third entry is a mask: no gradient
        return [p.detach().clone().requires_grad_(i % 3 != 2) for i, p in enumerate(ps0)]

    def grads_of(ps):
        return [p.grad for p in ps if p.requires_grad]

    errors = {}  # (kernel, rows) -> largest |diff| against plain float64

    def note_error(name, diff, rows=ROWS):
        errors[name, rows] = max(errors.get((name, rows), 0.0), diff.max().item())

    def check_samples(label, diff):
        check(diff.max().item() <= TOL_SAMPLE_MAX, f"{label} (max)")
        check(diff.median().item() <= TOL_SAMPLE_MEDIAN, f"{label} (median)")

    def hold_values(label, name, values, tols, report=None):
        """Hold a kernel's outputs at the training steps' rows, ``values =
        [kernel's, plain float64's]``, to ``tols`` (``None``: the sample
        tolerances), and note the error of output ``report`` (default: the
        largest) under the kernel's ``name``."""
        diffs = [(a.double() - b).abs() for a, b in zip(*values)]
        print(f"{label} at {GRAD_ROWS} rows vs plain f64: max"
              f" {['%.3e' % d.max().item() for d in diffs]}")
        for d, tol in zip(diffs, tols):
            if tol is None:
                check_samples(f"{label} at {GRAD_ROWS} rows", d)
            else:
                check(d.max().item() <= tol, f"{label} at {GRAD_ROWS} rows vs plain")
        for d in diffs if report is None else [diffs[report]]:
            note_error(name, d, GRAD_ROWS)

    for label, flow, xc in (
        ("flagship", flagship, x_big),
        ("conditional", conditional, torch.cat([cx_big, c_big], dim=1)),
        ("maf", maf, x_big),
    ):
        params, layout, st = plain_args(flow, torch.float32)
        p64, _, _ = plain_args(flow, torch.float64)
        F = st[0]
        with torch.no_grad():
            k_lp = nsf_fused.nsf_density(xc, params, layout, *st)
            r_lp = nsf_fused._full_math(xc.double(), p64, layout, *st)
            d = (k_lp.double() - r_lp).abs()
            print(f"{label} density vs plain f64: max {d.max().item():.3e} median {d.median().item():.3e}")
            check(d.max().item() <= TOL_DENSITY, f"{label} density vs plain")
            note_error("nsf_density", d)

            k_y, k_sl = nsf_fused.nsf_apply(xc, params, layout, *st)
            r_y, r_sl = nsf_fused._full_math(xc.double(), p64, layout, *st, raw=True)
            dy, dsl = (k_y.double() - r_y).abs(), (k_sl.double() - r_sl).abs()
            print(f"{label} apply vs plain f64: y max {dy.max().item():.3e},"
                  f" sum ladj max {dsl.max().item():.3e} median {dsl.median().item():.3e}")
            check(dy.max().item() <= TOL_DENSITY, f"{label} apply y vs plain")
            check(dsl.max().item() <= TOL_DENSITY, f"{label} apply sum ladj vs plain")
            note_error("nsf_apply", torch.maximum(dy.amax(dim=1), dsl))

            zc = torch.cat([torch.randn(ROWS, F, generator=gen, device=dev), xc[:, F:]], dim=1)
            k_x = nsf_fused.nsf_sample(zc, params, layout, *st)
            k_xl, k_lq = nsf_fused.nsf_sample(zc, params, layout, *st, want_log_prob=True)
            k_u, k_rl = nsf_fused.nsf_sample(zc, params, layout, *st, want_log_prob="raw")
            r_x, r_lq = nsf_fused._sample_math(zc.double(), p64, layout, *st, want_log_prob=True)
            # in float64 the bare sum is log q less the base term, to 1e-15
            z64 = zc[:, :F].double()
            r_rl = r_lq + 0.5 * (z64**2).sum(dim=1) + 0.5 * F * math.log(2 * math.pi)
            dx = (k_x.double() - r_x).abs()
            dxl = (k_xl.double() - r_x).abs()
            du = (k_u.double() - r_x).abs()
            dlq = (k_lq.double() - r_lq).abs()
            drl = (k_rl.double() - r_rl).abs()
            print(f"{label} sample x vs plain f64: max {dx.max().item():.3e}"
                  f" median {dx.median().item():.3e}; with log q: x max {dxl.max().item():.3e},"
                  f" log q max {dlq.max().item():.3e} median {dlq.median().item():.3e};"
                  f" raw: x max {du.max().item():.3e}, sum ladj max {drl.max().item():.3e}")
            for diff in (dx, dxl, du):
                check_samples(f"{label} samples vs plain", diff)
            check(dlq.max().item() <= TOL_DENSITY, f"{label} log q vs plain")
            check(drl.max().item() <= TOL_DENSITY, f"{label} raw sum ladj vs plain")
            # log q against the density kernel at the returned points
            lp_at = nsf_fused.nsf_density(
                torch.cat([k_xl, zc[:, F:]], dim=1).contiguous(), params, layout, *st)
            dself = (k_lq - lp_at).abs()
            print(f"{label} log q vs density kernel at x: max {dself.max().item():.3e}")
            check(dself.max().item() <= TOL_DENSITY, f"{label} log q vs density kernel")
            # the round trip: the apply kernel at the raw solve's output
            # returns the target and the same sum of ladjs
            b_y, b_sl = nsf_fused.nsf_apply(
                torch.cat([k_u, zc[:, F:]], dim=1).contiguous(), params, layout, *st)
            dback, dbl = (b_y - zc[:, :F]).abs(), (b_sl - k_rl).abs()
            print(f"{label} apply(raw solve) vs target: max {dback.max().item():.3e}"
                  f" median {dback.median().item():.3e}; sum ladj max {dbl.max().item():.3e}")
            check_samples(f"{label} round trip", dback)
            check(dbl.max().item() <= TOL_DENSITY, f"{label} round trip sum ladj")
            note_error("nsf_sample", dx)
            note_error("nsf_sample_log_prob", dlq)
            note_error("nsf_sample_raw", drl)

        # at the training steps' rows: each Function's forward (the kernel)
        # against plain float64, and its gradient (float32 plain backward)
        # against float64 plain autograd, which holds which gradient reaches
        # which input and the float32 backward's accuracy
        xg = xc[:GRAD_ROWS]
        # a loss of means, as training has: cotangents of random sign would
        # make each parameter's gradient a cancelling sum, which the few
        # rows near the spline's slope floor then dominate
        weights = torch.arange(1, F + 1, device=dev) / F
        density, applied, values = [], [], []
        for fn, ps0, dtype in ((nsf_fused.nsf_density, params, torch.float32),
                               (nsf_fused._full_math, p64, torch.float64)):
            ps, xr = leaves(ps0), xg.to(dtype, copy=True).requires_grad_(True)
            lp = fn(xr, ps, layout, *st)
            lp.mean().backward()
            density.append([xr.grad] + grads_of(ps))
            values.append([lp.detach()])
        hold_values(f"{label} density", "nsf_density", values, [TOL_DENSITY])
        compare_grads(f"{label} density", *density)
        values = []
        for fn, kw, ps0, dtype in ((nsf_fused.nsf_apply, {}, params, torch.float32),
                                   (nsf_fused._full_math, {"raw": True}, p64, torch.float64)):
            ps, xr = leaves(ps0), xg.to(dtype, copy=True).requires_grad_(True)
            y, sl = fn(xr, ps, layout, *st, **kw)
            ((y * weights.to(dtype)).sum(dim=1).mean() + sl.mean()).backward()
            applied.append([xr.grad] + grads_of(ps))
            values.append([y.detach(), sl.detach()])
        hold_values(f"{label} apply", "nsf_apply", values, [TOL_DENSITY, TOL_DENSITY])
        compare_grads(f"{label} apply", *applied)

        # the IFT: sampling kernel forward, three-sweep backward; the
        # reference differentiates the unrolled plain solve, in chunks of
        # rows to bound its graph
        zg = zc[:GRAD_ROWS]
        for mode in (True, "raw"):
            ps, zr = leaves(params), zg.clone().requires_grad_(True)
            out_x, out_l = ift._IFTFunction.apply(zr, (layout, *st), mode, *ps)
            (out_l.mean() + (out_x**2).sum(dim=1).mean()).backward()
            got = [zr.grad] + grads_of(ps)
            ps, zgrads, ref = leaves(p64), [], []
            for chunk in zg.double().split(GRAD_ROWS // 4):
                zr = chunk.clone().requires_grad_(True)
                ref_x, ref_l = nsf_fused._sample_math(zr, ps, layout, *st, want_log_prob=mode)
                ((ref_l.sum() + (ref_x**2).sum()) / GRAD_ROWS).backward()
                zgrads.append(zr.grad)
                ref.append((ref_x.detach(), ref_l.detach()))
            hold_values(f"{label} solve ({'raw' if mode == 'raw' else 'log q'})",
                        "nsf_sample_raw" if mode == "raw" else "nsf_sample_log_prob",
                        [[out_x.detach(), out_l.detach()], [torch.cat(t) for t in zip(*ref)]],
                        [None, TOL_DENSITY], report=1)
            compare_grads(f"{label} IFT ({'raw' if mode == 'raw' else 'log q'})",
                          got, [torch.cat(zgrads)] + grads_of(ps),
                          tol_input=TOL_GRAD_SOLVE_INPUT)

    # 6. the per-op kernels against their plain versions, float64 on the card
    fparams, flayout, fst = plain_args(flagship, torch.float32)
    F, K = fst[0], fst[1]
    layer_shapes = []  # the flagship's first layer: 6 -> 64, 64 -> 64, 64 -> 138
    for i in range(3):
        W, b, M = fparams[3 * i : 3 * i + 3]
        layer_shapes.append((f"{W.shape[1]}->{W.shape[0]}", W, M, b))
    ragged_w = torch.randn(91, 37, generator=gen, device=dev)
    ragged_m = (torch.rand(91, 37, generator=gen, device=dev) < 0.5).float()

    def linear_inputs(rows):
        xin = [x_big[:rows]] + [torch.randn(rows, 64, generator=gen, device=dev) for _ in "12"]
        return [(name, x, W, M, b) for x, (name, W, M, b) in zip(xin, layer_shapes)]

    with torch.no_grad():
        cases = [(ROWS, *case) for case in linear_inputs(ROWS)] + [
            # leading batch dimensions, nothing a multiple of a tile, no bias
            (ROWS, "ragged 7x14289x37->91",
             torch.randn(7, 14289, 37, generator=gen, device=dev), ragged_w, ragged_m, None),
        ] + [(GRAD_ROWS, *case) for case in linear_inputs(GRAD_ROWS)]
        for rows, name, x, W, M, b in cases:
            name = f"{name} at {rows} rows"
            k_y = masked_linear.masked_linear(x, W, M, b)
            bias64 = 0.0 if b is None else b.double()
            r_y = x.double() @ (M * W).double().T + bias64
            scale = x.double().abs() @ (M * W).double().abs().T + abs(bias64)
            d = (k_y.double() - r_y).abs() / scale.clamp_min(1e-30)
            check(k_y.shape == r_y.shape, f"masked_linear {name} shape")
            print(f"masked_linear {name} vs plain f64: max |diff| {(k_y.double() - r_y).abs().max().item():.3e},"
                  f" relative to sum |x||W| + |b| max {d.max().item():.3e}")
            check(d.max().item() <= TOL_LINEAR, f"masked_linear {name} vs plain")
            note_error("masked_linear", (k_y.double() - r_y).abs(), rows)

        # 6M elements; 3 * randn leaves a tenth of them outside [-5, 5]
        spline = MonotonicRQSTransform(
            torch.randn(ROWS, F, K, generator=gen, device=dev),
            torch.randn(ROWS, F, K, generator=gen, device=dev),
            torch.randn(ROWS, F, K - 1, generator=gen, device=dev),
        )
        knots = (spline.horizontal, spline.vertical, spline.derivatives)
        knots64 = tuple(k.double() for k in knots)
        x_rqs = 3 * torch.randn(ROWS, F, generator=gen, device=dev)
        outside = (x_rqs.abs() > 5).float().mean().item()
        k_y, k_l = rqs.rqs_forward(x_rqs, *knots)
        r_y, r_l = rqs._math_nd(x_rqs.double(), *knots64, False)
        dy, dl = (k_y.double() - r_y).abs(), (k_l.double() - r_l).abs()
        print(f"rqs_forward vs plain f64 ({x_rqs.numel()} elements, {outside:.3f} outside):"
              f" y max {dy.max().item():.3e}, ladj max {dl.max().item():.3e}")
        check(0.05 < outside < 0.2, "rqs: share of out-of-domain elements")
        check(bool((k_y[x_rqs.abs() > 5] == x_rqs[x_rqs.abs() > 5]).all()),
              "rqs_forward: out-of-domain elements must pass through")
        check(dy.max().item() <= TOL_DENSITY and dl.max().item() <= TOL_DENSITY,
              "rqs_forward vs plain")
        note_error("rqs_forward", torch.maximum(dy, dl))
        k_x, k_li = rqs.rqs_inverse(x_rqs, *knots)
        r_x, r_li = rqs._math_nd(x_rqs.double(), *knots64, True)
        dx, dli = (k_x.double() - r_x).abs(), (k_li.double() - r_li).abs()
        print(f"rqs_inverse vs plain f64: x max {dx.max().item():.3e} median"
              f" {dx.median().item():.3e}, ladj max {dli.max().item():.3e}")
        check_samples("rqs_inverse vs plain", dx)
        check(dli.max().item() <= TOL_SAMPLE_MAX, "rqs_inverse ladj vs plain")
        note_error("rqs_inverse", dx)
        back, l_back = rqs.rqs_inverse(k_y, *knots)
        dback, dlb = (back - x_rqs).abs(), (l_back + k_l).abs()
        print(f"rqs inverse(forward(x)) vs x: max {dback.max().item():.3e} median"
              f" {dback.median().item():.3e}; ladj sum max {dlb.max().item():.3e}")
        check_samples("rqs round trip", dback)
        check(dlb.max().item() <= TOL_SAMPLE_MAX, "rqs round trip ladj")
        for name, fn, inverse in (("rqs_forward", rqs.rqs_forward, False),
                                  ("rqs_inverse", rqs.rqs_inverse, True)):
            hold_values(name, name, [
                fn(x_rqs[:GRAD_ROWS], *(k[:GRAD_ROWS] for k in knots)),
                rqs._math_nd(x_rqs[:GRAD_ROWS].double(), *(k[:GRAD_ROWS] for k in knots64),
                             inverse),
            ], [None, TOL_SAMPLE_MAX] if inverse else [TOL_DENSITY, TOL_DENSITY],
                report=0 if inverse else None)
        del spline, knots64, r_y, r_l, r_x, r_li

    # their gradients through the Functions, at 262,144 rows
    name, x, W, M, b = linear_inputs(GRAD_ROWS)[2]
    g = torch.randn(GRAD_ROWS, W.shape[0], generator=gen, device=dev) / GRAD_ROWS
    linear = []
    for fn, dtype in ((masked_linear.masked_linear, torch.float32),
                      (masked_linear._masked_linear_math, torch.float64)):
        xr, Wr, br = (t.detach().to(dtype, copy=True).requires_grad_(True) for t in (x, W, b))
        (fn(xr, Wr, M.to(dtype), br) * g.to(dtype)).sum().backward()
        linear.append([xr.grad, Wr.grad, br.grad])
    compare_grads(f"masked_linear {name}", *linear)
    ga = torch.randn(GRAD_ROWS, F, generator=gen, device=dev) / GRAD_ROWS
    gb = torch.randn(GRAD_ROWS, F, generator=gen, device=dev) / GRAD_ROWS
    splined = []
    for fn, dtype in ((rqs.rqs_forward, torch.float32),
                      (lambda *args: rqs._math_nd(*args, False), torch.float64)):
        ins = [t[:GRAD_ROWS].detach().to(dtype, copy=True).requires_grad_(True)
               for t in (x_rqs, *knots)]
        y, ladj = fn(*ins)
        ((y * ga.to(dtype)).sum() + (ladj * gb.to(dtype)).sum()).backward()
        splined.append([t.grad for t in ins])
    compare_grads("rqs_forward", *splined, n_inputs=4)
    del knots

    # 7. train through the public API, at the flagship's width from seeded
    # weights; counts zeroed just before each run, read just after
    def ring(x):
        return -((x.norm(dim=-1) - 2.0) ** 2) / 0.1

    def fresh():
        torch.manual_seed(1)
        return zt.NSF(6, 0, transforms=3, device=dev)

    def run(label, step_fn, state, args, steps):
        losses = []
        for i in range(steps):
            state, loss = step_fn(state, *args(i))
            losses.append(float(loss))
        print(f"training {label}: losses {['%.4f' % v for v in losses]}")
        check(all(math.isfinite(v) for v in losses), f"training {label}: non-finite loss")
        if steps >= 10:
            check(statistics.mean(losses[-5:]) < statistics.mean(losses[:5]),
                  f"training {label}: the loss did not fall")
        else:
            check(losses[-1] < losses[0], f"training {label}: the loss did not fall")
        return state, losses

    def counts_after(label, due, none=()):
        counts = dict(ops.LAUNCHES)
        print(f"training {label}: launches { {k: v for k, v in counts.items() if v} }")
        for name in due:
            check(counts[name] > 0, f"training {label} did not launch {name}")
        for name in none:
            check(counts[name] == 0, f"training {label} launched {name}")
        return counts

    batches = xs.split(GRAD_ROWS)  # the samples the serving phase drew
    batch = lambda i: (batches[i % len(batches)],)  # noqa: E731
    generator = lambda i: (gen,)  # noqa: E731
    step_fns, trained = {}, {}

    flow_a = fresh()
    flow_d = copy.deepcopy(flow_a)
    ops.reset_launches()
    init_fn, step_fns["mle"] = zt.make_mle_step(flow_a, lr=1e-3)
    trained["mle"], losses_a = run("(a) MLE", step_fns["mle"], init_fn(), batch, TRAIN_STEPS)
    train_launches = counts_after("(a) MLE", ["nsf_density"])

    flow_b = fresh()
    ops.reset_launches()
    init_fn, step_fns["rkl"] = zt.make_reverse_kl_step(flow_b, ring, n_samples=GRAD_ROWS, lr=1e-3)
    check(isinstance(flow_b(None), FusedAutoregressiveFlow), "(b) did not dispatch")
    trained["rkl"], _ = run("(b) reverse KL, IFT", step_fns["rkl"], init_fn(), generator, TRAIN_STEPS)
    counts = counts_after("(b) reverse KL, IFT", ["nsf_sample_log_prob"])
    train_launches["nsf_sample_log_prob"] = counts["nsf_sample_log_prob"]

    flow_c = fresh()
    inverted = Flow(flow_c.transform.inv, flow_c.base)
    ops.reset_launches()
    init_fn, step_fns["rkl_inv"] = zt.make_reverse_kl_step(
        inverted, ring, n_samples=GRAD_ROWS, lr=1e-3)
    check(isinstance(inverted(None), FusedInvertedAutoregressiveFlow), "(c) did not dispatch")
    trained["rkl_inv"], _ = run("(c) reverse KL, inverted flow", step_fns["rkl_inv"], init_fn(),
                                generator, TRAIN_STEPS)
    with torch.no_grad():  # the trained density at its own samples: the solve
        x_inv, lq_inv = inverted(None).sample_and_log_prob((GRAD_ROWS,), gen)
        lp_inv = inverted(None).log_prob(x_inv)
    d = (lp_inv - lq_inv).abs()
    print(f"inverted flow log_prob at its samples vs their log q: max {d.max().item():.3e}")
    check(d.max().item() <= TOL_SAMPLE_MAX, "inverted flow log_prob vs log q")
    counts = counts_after("(c) reverse KL, inverted flow", ["nsf_apply", "nsf_sample_raw"])
    train_launches.update({k: counts[k] for k in ("nsf_apply", "nsf_sample_raw")})

    # (d) the unfused path: dispatch switched off for the phase and its timing
    before = os.environ.get("ZUKO_TPU_TORCH_FUSED_DISPATCH")
    os.environ["ZUKO_TPU_TORCH_FUSED_DISPATCH"] = "0"
    try:
        ops.reset_launches()
        init_fn, step_fns["mle_unfused"] = zt.make_mle_step(flow_d, lr=1e-3)
        check(type(flow_d(None)) is zt.NormalizingFlow, "(d) dispatched to the fused kernels")
        trained["mle_unfused"], losses_d = run(
            "(d) MLE, unfused, per-op kernels", step_fns["mle_unfused"], init_fn(), batch,
            UNFUSED_STEPS)
        with torch.no_grad():
            x_d = flow_d(None).sample((GRAD_ROWS,), gen)
        check(bool(torch.isfinite(x_d).all()) and x_d.shape == (GRAD_ROWS, 6), "(d) samples")
        counts = counts_after("(d) MLE, unfused, per-op kernels",
                              ["masked_linear", "rqs_forward", "rqs_inverse"], none=served)
        train_launches.update(
            {k: counts[k] for k in ("masked_linear", "rqs_forward", "rqs_inverse")})
        print(f"first loss: fused {losses_a[0]:.6f}, unfused with per-op kernels {losses_d[0]:.6f}")
        check(abs(losses_a[0] - losses_d[0]) <= 1e-4, "(a) and (d) start from different losses")

        # one step of each, host clock; (d) inside its switch
        step_ms = {}

        def time_step(key, args, forward):
            """Time the step, count its launches, and time the forward of
            its loss alone (without gradients)."""
            state = trained[key]
            ops.reset_launches()

            def one():
                nonlocal state
                state, _ = step_fns[key](state, *args(0))

            step_ms[key] = host_ms(one, 5)
            counts = {k: v // 6 for k, v in ops.LAUNCHES.items() if v}
            with torch.no_grad():
                forward_ms[key] = host_ms(forward, 5)[0]
            return counts

        forward_ms = {}
        per_step = {"mle_unfused": time_step(
            "mle_unfused", batch, lambda: flow_d(None).log_prob(batches[0]).mean())}
    finally:
        if before is None:
            del os.environ["ZUKO_TPU_TORCH_FUSED_DISPATCH"]
        else:
            os.environ["ZUKO_TPU_TORCH_FUSED_DISPATCH"] = before
    per_step.update({
        "mle": time_step("mle", batch, lambda: flow_a(None).log_prob(batches[0]).mean()),
        "rkl": time_step(
            "rkl", generator, lambda: flow_b(None).sample_and_log_prob((GRAD_ROWS,), gen)),
        "rkl_inv": time_step(
            "rkl_inv", generator, lambda: inverted(None).sample_and_log_prob((GRAD_ROWS,), gen)),
    })

    # 8. times: kernel, plain version (float32 on the card), bound, library
    weight_bytes = 4 * sum(p.numel() for i, p in enumerate(fparams) if i % 3 != 2)
    univ = fst[4]
    # one pass of each AR layer: its masked hyper-net and F univariates
    passes = [
        (hyper_ops(ps) + F * spline_ops(univ, K), min(p, F))
        for ps, p in nsf_fused._split_layers(fparams, flayout)
    ]
    density_ops = sum(n for n, _ in passes)
    sample_ops = sum(n * sweeps for n, sweeps in passes)
    # name -> (source, the pallas_call it replaces)
    origin = {
        "nsf_density": (CSRC + "nsf_fused.cu", "zuko_tpu/ops/nsf_fused.py:1842"),
        "nsf_apply": (CSRC + "nsf_fused.cu", "zuko_tpu/ops/nsf_fused.py:2183"),
        "nsf_sample": (CSRC + "nsf_fused.cu", "zuko_tpu/ops/nsf_fused.py:1658"),
        "nsf_sample_log_prob": (CSRC + "nsf_fused.cu", "zuko_tpu/ops/nsf_fused.py:1658"),
        "nsf_sample_raw": (CSRC + "nsf_fused.cu", "zuko_tpu/ops/nsf_fused.py:1658"),
        "masked_linear": (CSRC + "masked_linear.cu", "zuko_tpu/ops/masked_linear.py:116"),
        "rqs_forward": (CSRC + "rqs.cu", "zuko_tpu/ops/rqs.py:106"),
        "rqs_inverse": (CSRC + "rqs.cu", "zuko_tpu/ops/rqs.py:106"),
    }

    def flow_work(rows):
        """name -> (kernel, plain, operations, bytes) of the whole-flow
        kernels at ``rows`` rows of the flagship."""
        x, z = x_big[:rows], torch.randn(rows, F, generator=gen, device=dev)
        args = (fparams, flayout, *fst)
        return {
            "nsf_density": (
                lambda: nsf_fused.nsf_density(x, *args),
                lambda: nsf_fused._full_math(x, *args),
                rows * density_ops, 4 * rows * (F + 1) + weight_bytes),
            "nsf_apply": (
                lambda: nsf_fused.nsf_apply(x, *args),
                lambda: nsf_fused._full_math(x, *args, raw=True),
                rows * density_ops, 4 * rows * (2 * F + 1) + weight_bytes),
            "nsf_sample": (
                lambda: nsf_fused.nsf_sample(z, *args),
                lambda: nsf_fused._sample_math(z, *args),
                rows * sample_ops, 4 * rows * 2 * F + weight_bytes),
            "nsf_sample_log_prob": (
                lambda: nsf_fused.nsf_sample(z, *args, want_log_prob=True),
                lambda: nsf_fused._sample_math(z, *args, want_log_prob=True),
                rows * (sample_ops + density_ops), 4 * rows * (2 * F + 1) + weight_bytes),
            "nsf_sample_raw": (
                lambda: nsf_fused.nsf_sample(z, *args, want_log_prob="raw"),
                lambda: nsf_fused._sample_math(z, *args, want_log_prob="raw"),
                rows * (sample_ops + density_ops), 4 * rows * (2 * F + 1) + weight_bytes),
        }

    timed = {}  # (name, rows) -> dict of times

    def time_kernel(name, rows, kernel, plain, n_ops, nbytes, library=None, note="", runs=5):
        """Time one kernel at one shape into ``timed[name, rows, note]``."""
        k_ms, k_runs = time_ms(kernel, runs)
        p_ms, p_runs = time_ms(plain, max(3, runs // 2))
        l_ms = None if library is None else time_ms(library, runs)[0]
        b_ms, b_by = bound(n_ops, nbytes)
        timed[name, rows, note] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                                   "bound_by": b_by, "library_ms": l_ms}
        print(f"{' '.join(filter(None, [name, note]))} at {rows} rows: kernel {k_ms:.3f} ms {fmt(k_runs)},"
              f" plain {p_ms:.3f} ms {fmt(p_runs)},"
              + ("" if l_ms is None else f" library {l_ms:.3f} ms,")
              + f" bound {b_ms:.4f} ms ({b_by}: {n_ops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB),"
              f" {rows / k_ms / 1e3:.2f} M rows/s")

    with torch.no_grad():
        for rows in (ROWS, GRAD_ROWS):
            for name, work in flow_work(rows).items():
                time_kernel(name, rows, *work)
        # one hyper-net pass of the unfused step: the three layer shapes
        linear_total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
        for name, x, W, M, b in linear_inputs(GRAD_ROWS):
            out_f, in_f = W.shape
            time_kernel(
                "masked_linear", GRAD_ROWS,
                lambda: masked_linear.masked_linear(x, W, M, b),
                lambda: masked_linear._masked_linear_math(x, W, M, b),
                GRAD_ROWS * (2 * int(M.sum().item()) + out_f),
                4 * (GRAD_ROWS * (in_f + out_f) + 2 * W.numel() + out_f),
                library=lambda: torch.nn.functional.linear(x, M * W, b), note=name,
                runs=PER_OP_RUNS,
            )
            for key in linear_total:
                linear_total[key] += timed["masked_linear", GRAD_ROWS, name][key]
        # the bytes bound every shape, so the sum's bound is the bytes' too
        timed["masked_linear", GRAD_ROWS, ""] = {**linear_total, "bound_by": "bytes"}
        check(all(timed["masked_linear", GRAD_ROWS, name]["bound_by"] == "bytes"
                  for name, *_ in layer_shapes), "masked_linear: a shape is bound by operations")
        print(f"masked_linear, the three shapes together: {linear_total}")
        # the spline of one layer of the unfused step: rows x F elements
        spline = MonotonicRQSTransform(
            torch.randn(GRAD_ROWS, F, K, generator=gen, device=dev),
            torch.randn(GRAD_ROWS, F, K, generator=gen, device=dev),
            torch.randn(GRAD_ROWS, F, K - 1, generator=gen, device=dev),
        )
        knots = (spline.horizontal, spline.vertical, spline.derivatives)
        x_el = x_rqs[:GRAD_ROWS]
        m = x_el.numel()
        for name, fn, inverse in (("rqs_forward", rqs.rqs_forward, False),
                                  ("rqs_inverse", rqs.rqs_inverse, True)):
            time_kernel(name, GRAD_ROWS, lambda: fn(x_el, *knots),
                        lambda: rqs._math_nd(x_el, *knots, inverse),
                        m * rqs_ops(K), 4 * m * (1 + 3 * (K + 1) + 2),
                        note=f"({m} elements)", runs=PER_OP_RUNS)
    timed.update({(name, GRAD_ROWS, ""): timed[name, GRAD_ROWS, f"({m} elements)"]
                  for name in ("rqs_forward", "rqs_inverse")})
    ms = {name: timed[name, ROWS, ""]["ms"] for name in served}
    check(ms["nsf_sample_log_prob"] >= ms["nsf_sample"] >= ms["nsf_density"],
          f"rates out of order (slp <= sample <= density): {ms}")

    # a training step beside the kernels it launches (their times at the
    # step's shapes, times the launches of one step)
    for key, label in (("mle", "(a) MLE"), ("rkl", "(b) reverse KL, IFT"),
                       ("rkl_inv", "(c) reverse KL, inverted flow"),
                       ("mle_unfused", "(d) MLE, unfused, per-op kernels")):
        s_ms, s_runs = step_ms[key]
        k_ms = sum(timed[name, GRAD_ROWS, ""]["ms"] * count / (3 if name == "masked_linear" else 1)
                   for name, count in per_step[key].items())
        print(f"training step {label}: {s_ms:.3f} ms {fmt(s_runs)}, launches per step"
              f" {per_step[key]}, their kernels {k_ms:.3f} ms, kernel share {k_ms / s_ms:.3f},"
              f" forward alone {forward_ms[key]:.3f} ms, {GRAD_ROWS / s_ms / 1e3:.3f} M rows/s")

    # a served request end to end (host clock, synchronised): building
    # flow(None), extraction, weight packing and base draws around the kernel
    requests = {
        "nsf_density": lambda: flagship(None).log_prob(x_big),
        "nsf_sample": lambda: flagship(None).sample((ROWS,), generator=gen),
        "nsf_sample_log_prob": lambda: flagship(None).sample_and_log_prob(
            (ROWS,), generator=gen),
    }
    with torch.no_grad():
        for name, request in requests.items():
            r_ms, r_runs = host_ms(request, 5)
            print(f"served request {name}: {r_ms:.3f} ms {fmt(r_runs)},"
                  f" kernel share {ms[name] / r_ms:.3f}")

    # the old kernels at the serving shape, the new ones at the training
    # step's; launches from the phase that drives each
    kernels = []
    for name, (source, replaces) in origin.items():
        rows = ROWS if name in served else GRAD_ROWS
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name] if name in served else train_launches[name],
            "max_abs_err": errors[name, rows], "rows": rows, **timed[name, rows, ""],
            "max_abs_err_at_rows": {str(r): e for (n, r), e in errors.items() if n == name},
        })
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
