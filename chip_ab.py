#!/usr/bin/env python3
r"""Time the flagship NSF kernels of two checkouts on one GPU, in turns.

Run from the root of a checkout, with the parent's checkout (``git archive``
unpacked into a directory ``.gitignore`` lists) as the argument::

    python3 chip_ab.py PARENT_DIR [CHANGE_DIR]

It builds the kernels of each tree with that tree's own ``ops/_build.py``
(both trees at once) into that tree's ``build/``, then times the flagship NSF's
``nsf_density`` and ``nsf_sample`` (without log q, with it, raw) at 1M and
262,144 rows in a process of its own for each tree, in the order parent,
change, change, parent: the median of 5 CUDA-event timings after a warm-up
(``chip_smoke.time_ms``), one JSON line a process. ``CHANGE_DIR`` defaults to this checkout. Two trees
are compared only within one call, on one card.
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
    """One JSON line: the tree's NSF kernel times (ms)."""
    import torch

    from chip_smoke import time_ms  # this checkout's, before the tree joins the path

    sys.path.insert(0, str(tree))

    import zuko_tpu_torch as zt

    from zuko_tpu_torch.ops import _build, nsf_fused

    assert Path(_build.__file__).resolve().is_relative_to(tree), _build.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    flow = zt.load_params(zt.NSF(6, 0, transforms=3, device=dev),
                          tree / "zuko_tpu_torch" / "assets" / "nsf_flagship.npz")
    params, layout, cfg = nsf_fused._flatten_flow(flow)
    st = nsf_fused._statics(cfg, 6)
    ps = [p.detach() for p in params]
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"tree": str(tree)}
    for rows in (1 << 20, 1 << 18):
        x = torch.randn(rows, 6, generator=gen, device=dev)
        for name, mode in (("density", None), ("sample", False), ("sample_log_prob", True),
                           ("sample_raw", "raw")):
            def fn():
                if mode is None:
                    return nsf_fused.nsf_density(x, ps, layout, *st)
                return nsf_fused.nsf_sample(x, ps, layout, *st, want_log_prob=mode)

            out[f"{name}@{rows}"] = round(time_ms(fn, 5)[0], 3)
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
