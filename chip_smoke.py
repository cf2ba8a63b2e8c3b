#!/usr/bin/env python3
r"""Smoke run of the PyTorch port (``zuko_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the CUDA kernels from ``zuko_tpu_torch/ops/csrc`` into ``build/``,
serves the flagship NSF (D=6, 3 transforms, 64x64 MADE, K=8, float32, the
committed ``zuko_tpu_torch/assets/nsf_flagship.npz`` weights) and a
conditional NSF(3, 5) through ``flow(c).log_prob``, ``.sample`` and
``.sample_and_log_prob``, and checks:

* the flagship density through the kernel against ``tools/nsf_truth_f64.npz``
  (max |diff| <= 1e-4);
* every kernel against its plain PyTorch version in float64 on the card, at
  1M rows, for both flows and for a MAF (the kernels' affine branch):
  density max <= 1e-4; samples max <= 1e-3, median <= 1e-5 (the spline's
  minimum slope 1e-3 can amplify float32 rounding a thousandfold in the
  inverse); log q max <= 1e-4, also against the density kernel at the
  returned points; and the density's gradient through the kernel's
  ``autograd.Function`` against float64 plain autograd (the backward is the
  plain version's, so this holds the Function's wiring and its float32
  backward, not the kernel);
* that the served path launched every kernel (launch counts, zeroed just
  before the serving phase and read just after it).

Then it times each kernel, its plain version (float32, on the card) and its
bound at 1M rows, and prints the card's name and power limit, one JSON line
``{"kernels": [...]}`` and, last, ``{"ok": true, "device": {...}}``. Any
failed check raises, so the script exits non-zero and prints no result; it
also fails without a CUDA device and outside a checkout of the repository.
"""

import json
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
# NVIDIA H100 SXM data sheet (700 W): float32 outside the tensor cores, and
# HBM3. The bound of a kernel is the larger of its operations over the first
# and its bytes (inputs read once, outputs written once) over the second.
FP32_PEAK = 67e12
HBM_RATE = 3.35e12
TOL_DENSITY = 1e-4
TOL_SAMPLE_MAX, TOL_SAMPLE_MEDIAN = 1e-3, 1e-5
# Gradients against float64: each parameter's largest |diff| over its
# largest |gradient|; the input gradient normwise, since at the few rows
# where the spline's slope nears its floor the derivative of its log-slope
# loses digits in float32 (a 2e-2 max-wise error at 262,144 rows on the CPU
# came with 1.1e-4 normwise).
TOL_GRAD_PARAMS, TOL_GRAD_INPUT = 1e-4, 1e-3


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


def spline_ops(univ, K):
    """Operations of one univariate evaluation (forward or inverse),
    counted from the kernel's source: for the spline, 4 per raw parameter
    (slope clamp), 4 per softmax entry, 3 per knot, 1 per derivative exp,
    K + 1 bin compares and about 25 for the rational function and its log
    or its root."""
    if univ == "affine":
        return 6
    return 4 * (3 * K - 1) + 4 * 2 * K + 3 * 2 * K + (K - 1) + (K + 1) + 25


def hyper_ops(ps):
    """Operations of one hyper-net pass, counted from its masks: the
    multiply-adds of the entries the MADE mask keeps, plus the biases. The
    kernel also multiplies the masked-out zeros; the function does not need
    them."""
    return sum(2 * int(M.sum().item()) + b.numel() for b, M in zip(ps[1::3], ps[2::3]))


def bound(ops, nbytes):
    t_ops, t_bytes = ops / FP32_PEAK, nbytes / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import zuko_tpu_torch as zt

    from zuko_tpu_torch.ops import _build, nsf_fused
    from zuko_tpu_torch.ops.dispatch import FusedAutoregressiveFlow

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)

    # 2. build every kernel from the sources in the checkout
    t0 = time.perf_counter()
    reports = _build.build_all(force=True)
    print(f"build: {time.perf_counter() - t0:.1f} s")
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
    nsf_fused.reset_launches()
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
    launches = dict(nsf_fused.LAUNCHES)
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

    # 4-5. every kernel (both univariate branches) against its plain
    # version, float64 on the card
    def plain_args(flow, dtype):
        params, layout, cfg = nsf_fused._flatten_flow(flow)
        params = [p.detach().to(dtype) for p in params]
        F = params[-3].shape[0] // nsf_fused._univ_size(cfg["univ"], cfg["bins"])
        return params, layout, (F, cfg["bins"], cfg["bound"], cfg["slope"], cfg["univ"])

    errors = {}

    def note_error(name, diff):
        errors[name] = max(errors.get(name, 0.0), diff.max().item())
    for label, flow, xc in (
        ("flagship", flagship, x_big),
        ("conditional", conditional, torch.cat([cx_big, c_big], dim=1)),
        ("maf", maf, x_big),
    ):
        params, layout, st = plain_args(flow, torch.float32)
        p64, _, _ = plain_args(flow, torch.float64)
        with torch.no_grad():
            k_lp = nsf_fused.nsf_density(xc, params, layout, *st)
            r_lp = nsf_fused._full_math(xc.double(), p64, layout, *st)
            d = (k_lp.double() - r_lp).abs()
            print(f"{label} density vs plain f64: max {d.max().item():.3e} median {d.median().item():.3e}")
            check(d.max().item() <= TOL_DENSITY, f"{label} density vs plain")
            note_error("nsf_density", d)

            F = st[0]
            zc = torch.cat([torch.randn(ROWS, F, generator=gen, device=dev), xc[:, F:]], dim=1)
            k_x = nsf_fused.nsf_sample(zc, params, layout, *st)
            k_xl, k_lq = nsf_fused.nsf_sample(zc, params, layout, *st, want_log_prob=True)
            r_x, r_lq = nsf_fused._sample_math(zc.double(), p64, layout, *st, want_log_prob=True)
            dx = (k_x.double() - r_x).abs()
            dxl = (k_xl.double() - r_x).abs()
            dlq = (k_lq.double() - r_lq).abs()
            print(f"{label} sample x vs plain f64: max {dx.max().item():.3e}"
                  f" median {dx.median().item():.3e}; with log q: x max {dxl.max().item():.3e},"
                  f" log q max {dlq.max().item():.3e} median {dlq.median().item():.3e}")
            for diff in (dx, dxl):
                check(diff.max().item() <= TOL_SAMPLE_MAX, f"{label} samples vs plain (max)")
                check(diff.median().item() <= TOL_SAMPLE_MEDIAN, f"{label} samples vs plain (median)")
            check(dlq.max().item() <= TOL_DENSITY, f"{label} log q vs plain")
            # log q against the density kernel at the returned points
            lp_at = nsf_fused.nsf_density(
                torch.cat([k_xl, zc[:, F:]], dim=1).contiguous(), params, layout, *st)
            dself = (k_lq - lp_at).abs()
            print(f"{label} log q vs density kernel at x: max {dself.max().item():.3e}")
            check(dself.max().item() <= TOL_DENSITY, f"{label} log q vs density kernel")
            note_error("nsf_sample", dx)
            note_error("nsf_sample_log_prob", dlq)

        # the density's gradient through the kernel's autograd.Function
        # (kernel forward, float32 plain backward) against float64 plain
        # autograd: this holds which gradient reaches which input, and the
        # float32 backward's accuracy; it cannot see the kernel's arithmetic
        xg = xc[:GRAD_ROWS]
        grads = []
        for fn, ps0, dtype in ((nsf_fused.nsf_density, params, torch.float32),
                               (nsf_fused._full_math, p64, torch.float64)):
            # every third entry is a mask: no gradient
            ps = [p.detach().clone().requires_grad_(i % 3 != 2) for i, p in enumerate(ps0)]
            xr = xg.to(dtype, copy=True).requires_grad_(True)
            fn(xr, ps, layout, *st).mean().backward()
            grads.append([xr.grad] + [p.grad for p in ps if p.requires_grad])
        diffs = [(a.double() - b, b) for a, b in zip(*grads)]
        input_norm = (diffs[0][0].norm() / diffs[0][1].norm()).item()
        input_max = (diffs[0][0].abs().max() / diffs[0][1].abs().max()).item()
        params_max = max(
            (d.abs().max() / b.abs().max().clamp_min(1e-30)).item() for d, b in diffs[1:]
        )
        print(f"{label} density gradient (Function, f32) vs f64 plain autograd:"
              f" parameters worst max-relative {params_max:.3e}; input normwise"
              f" {input_norm:.3e}, max-relative {input_max:.3e}")
        check(params_max <= TOL_GRAD_PARAMS, f"{label} density gradient (parameters)")
        check(input_norm <= TOL_GRAD_INPUT, f"{label} density gradient (input)")

    # 7. times at 1M rows: kernel, plain version (float32 on the card), bound
    params, layout, st = plain_args(flagship, torch.float32)
    F, K, _, _, univ = st
    weight_bytes = 4 * sum(p.numel() for i, p in enumerate(params) if i % 3 != 2)
    # one pass of each AR layer: its masked hyper-net and F univariates
    passes = [
        (hyper_ops(ps) + F * spline_ops(univ, K), min(p, F))
        for ps, p in nsf_fused._split_layers(params, layout)
    ]
    density_ops = sum(ops for ops, _ in passes)
    sample_ops = sum(ops * sweeps for ops, sweeps in passes)
    zc = torch.randn(ROWS, F, generator=gen, device=dev)
    work = {
        "nsf_density": (
            lambda: nsf_fused.nsf_density(x_big, params, layout, *st),
            lambda: nsf_fused._full_math(x_big, params, layout, *st),
            ROWS * density_ops,
            4 * ROWS * (F + 1) + weight_bytes,
        ),
        "nsf_sample": (
            lambda: nsf_fused.nsf_sample(zc, params, layout, *st),
            lambda: nsf_fused._sample_math(zc, params, layout, *st),
            ROWS * sample_ops,
            4 * ROWS * 2 * F + weight_bytes,
        ),
        "nsf_sample_log_prob": (
            lambda: nsf_fused.nsf_sample(zc, params, layout, *st, want_log_prob=True),
            lambda: nsf_fused._sample_math(zc, params, layout, *st, want_log_prob=True),
            ROWS * (sample_ops + density_ops),
            4 * ROWS * (2 * F + 1) + weight_bytes,
        ),
    }
    kernels, ms = [], {}
    with torch.no_grad():
        for name, (kernel, plain, ops, nbytes) in work.items():
            k_ms, k_runs = time_ms(kernel, 5)
            p_ms, p_runs = time_ms(plain, 3)
            b_ms, b_by = bound(ops, nbytes)
            ms[name] = k_ms
            print(f"{name}: kernel {k_ms:.3f} ms {['%.3f' % t for t in k_runs]},"
                  f" plain {p_ms:.3f} ms {['%.3f' % t for t in p_runs]},"
                  f" bound {b_ms:.4f} ms ({b_by}: {ops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB),"
                  f" {ROWS / k_ms / 1e3:.2f} M rows/s")
            kernels.append({
                "name": name, "route": "cuda",
                "source": "zuko_tpu_torch/ops/csrc/nsf_fused.cu",
                "replaces": "zuko_tpu/ops/nsf_fused.py:1842" if name == "nsf_density"
                else "zuko_tpu/ops/nsf_fused.py:1658",
                "launches": launches[name], "max_abs_err": errors[name],
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None,
            })
    check(ms["nsf_sample_log_prob"] >= ms["nsf_sample"] >= ms["nsf_density"],
          f"rates out of order (slp <= sample <= density): {ms}")

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
            times = []
            for _ in range(6):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                request()
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t0))
            r_ms = statistics.median(times[1:])
            print(f"served request {name}: {r_ms:.3f} ms {['%.3f' % t for t in times[1:]]},"
                  f" kernel share {ms[name] / r_ms:.3f}")

    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
