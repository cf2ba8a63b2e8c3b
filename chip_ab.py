#!/usr/bin/env python3
r"""Time the kernels of two checkouts on one GPU, in turns.

Run from the root of a checkout, with the parent's checkout (``git archive``
unpacked into a directory ``.gitignore`` lists) as the argument::

    python3 chip_ab.py PARENT_DIR [CHANGE_DIR]

It builds the kernels of each tree with that tree's own ``ops/_build.py``
(both trees at once) into that tree's ``build/``, then, in a process of its
own for each tree, in the order parent, change, change, parent, times with
``chip_smoke.time_ms`` (the median after a warm-up), one JSON line a
process:

* the flagship NSF's ``nsf_density`` and ``nsf_sample`` (without log q, with
  it, raw) at 1M and 262,144 rows, 5 runs;
* ``masked_linear`` at the flagship MADE's three layer shapes at 262,144
  rows: 21 runs of 20 queued calls (``ml_...``) and 21 runs of one call
  (``ml_..._single``);
* the flagship UNAF's ``naf_sample`` without and with log q at 65,536 and
  16,384 rows, and its ``naf_density`` at 262,144, 3 runs;
* the flagship NAF's ``naf_sample`` without and with log q at 65,536 and
  262,144 rows, 3 runs;
* the flagship CNF's ``cnf_adjoint`` with the log-q cotangent and without a
  trace at 16,384 rows, the inputs of a step of (l) (``chip_smoke.py``):
  samples ``cnf_sample`` draws with log q from seeded base draws, the
  cotangents of ``mean(lq) - mean(ring(x))``, 5 runs; its ``cnf_density``
  at 65,536 rows and ``cnf_sample`` with log q at 16,384, 3 runs.

``CHANGE_DIR`` defaults to this checkout. Two trees are compared only within
one call, on one card.
"""

import json
import subprocess
import sys

from pathlib import Path

ROOT = Path(__file__).resolve().parent


def build(trees):
    """Every tree's kernels into its build/, by its own ``_build.build_all``,
    all trees at once."""
    jobs = [subprocess.Popen([sys.executable, "-c",
                              "from zuko_tpu_torch.ops import _build; _build.build_all()"],
                             cwd=tree) for tree in trees]
    if any(job.wait() != 0 for job in jobs):
        raise SystemExit("chip_ab: a build failed")


def time_tree(tree):
    """One JSON line: the tree's kernel times (ms)."""
    import torch

    from chip_smoke import time_ms  # this checkout's, before the tree joins the path

    sys.path.insert(0, str(tree))

    import zuko_tpu_torch as zt

    from zuko_tpu_torch.ops import _build, cnf_fused, masked_linear, naf_fused, nsf_fused

    assert Path(_build.__file__).resolve().is_relative_to(tree), _build.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    assets = tree / "zuko_tpu_torch" / "assets"
    flow = zt.load_params(zt.NSF(6, 0, transforms=3, device=dev), assets / "nsf_flagship.npz")
    params, layout, cfg = nsf_fused._flatten_flow(flow)
    st = nsf_fused._statics(cfg, 6)
    ps = [p.detach() for p in params]
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"tree": str(tree)}
    with torch.no_grad():
        for rows in (1 << 20, 1 << 18):
            x = torch.randn(rows, 6, generator=gen, device=dev)
            for name, mode in (("density", None), ("sample", False), ("sample_log_prob", True),
                               ("sample_raw", "raw")):
                def fn():
                    if mode is None:
                        return nsf_fused.nsf_density(x, ps, layout, *st)
                    return nsf_fused.nsf_sample(x, ps, layout, *st, want_log_prob=mode)

                out[f"{name}@{rows}"] = round(time_ms(fn, 5)[0], 3)
        lins = [m for m in flow.transform.transforms[0].hyper.modules()
                if type(m).__name__ == "MaskedLinear"]
        for lin in lins:
            W, M, b = lin.weight.detach(), lin.mask, lin.bias.detach()
            x = torch.randn(1 << 18, W.shape[1], generator=gen, device=dev)
            key = f"ml_{W.shape[1]}->{W.shape[0]}"
            out[key] = round(time_ms(lambda: masked_linear.masked_linear(x, W, M, b), 21, 20)[0], 4)
            out[key + "_single"] = round(
                time_ms(lambda: masked_linear.masked_linear(x, W, M, b), 21)[0], 4)
        for label, cls in (("unaf", zt.UNAF), ("naf", zt.NAF)):
            nflow = zt.load_params(cls(6, 0, transforms=3, signal=16, device=dev),
                                   assets / f"{label}_flagship.npz")
            nps, nlayout, F, S = naf_fused._flatten_naf(nflow)
            nps = [p.detach() for p in nps]
            for rows in (1 << 16, 1 << 14 if label == "unaf" else 1 << 18):
                z = torch.randn(rows, 6, generator=gen, device=dev)
                for name, want in (("sample", False), ("sample_log_prob", True)):
                    out[f"{label}_{name}@{rows}"] = round(time_ms(
                        lambda: naf_fused.naf_sample(z, nps, nlayout, F, S, want), 3)[0], 3)
            if label == "unaf":
                x = torch.randn(1 << 18, 6, generator=gen, device=dev)
                out[f"unaf_density@{1 << 18}"] = round(time_ms(
                    lambda: naf_fused.naf_density(x, nps, nlayout, F, S), 3)[0], 3)
        cflow = zt.load_params(zt.CNF(6, device=dev), assets / "cnf_flagship.npz")
        cps, _, ccfg = cnf_fused._flatten_cnf(cflow, cflow.transform(None), None)
        cps = [p.detach() for p in cps]
        x = torch.randn(1 << 16, 6, generator=gen, device=dev)
        out[f"cnf_density@{1 << 16}"] = round(time_ms(
            lambda: cnf_fused.cnf_density(x, None, cps, None, ccfg), 3)[0], 3)
        rows = 1 << 14
        z = torch.randn(rows, 6, generator=gen, device=dev)
        out[f"cnf_sample_log_prob@{rows}"] = round(time_ms(
            lambda: cnf_fused.cnf_sample(z, None, cps, None, ccfg, True), 3)[0], 3)
        x, _ = cnf_fused.cnf_sample(z, None, cps, None, ccfg, True)
    # (l)'s cotangents: mean(lq) - mean(ring(x)), ring(x) = -(|x| - 2)^2 / 0.1
    xr = x.clone().requires_grad_(True)
    (((xr.norm(dim=-1) - 2.0) ** 2 / 0.1).mean()).backward()
    gx, glq = xr.grad.contiguous(), torch.full((rows,), 1.0 / rows, device=dev)
    with torch.no_grad():
        for name, lq in (("cnf_adjoint_log_prob", glq), ("cnf_adjoint", None)):
            out[f"{name}@{rows}"] = round(time_ms(
                lambda: cnf_fused.cnf_adjoint(x, gx, lq, None, cps, None, ccfg), 5)[0], 3)
    print(json.dumps(out), flush=True)


def main():
    if len(sys.argv) >= 3 and sys.argv[1] == "--time":
        time_tree(Path(sys.argv[2]).resolve())
        return 0
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 1
    parent = Path(sys.argv[1]).resolve()
    change = Path(sys.argv[2]).resolve() if len(sys.argv) == 3 else ROOT
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    build([parent, change])
    for tree in (parent, change, change, parent):
        subprocess.run([sys.executable, __file__, "--time", str(tree)], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
