#!/usr/bin/env python3
r"""Time the kernels and the IFT training steps of checkouts on one GPU, in turns.

Run from the root of a checkout, with the parent's checkout (``git archive``
unpacked into a directory ``.gitignore`` lists) as the argument::

    python3 chip_ab.py [--steps] PARENT_DIR [CHANGE_DIR ...]

It builds the kernels of each tree with that tree's own ``ops/_build.py``
(all trees at once) into that tree's ``build/``, prints each tree's ptxas
report of the NSF, GF and CNF kernels (registers, spills, stack frame and
shared memory of each entry point) and whether the SASS of each NSF
kernel (the samplers ``nsf_sample_tiled`` and ``nsf_sample_kernel``, the
densities ``nsf_density_kernel`` and ``nsf_density_tiled``) and of each GF
kernel (``gf_density_kernel``, ``gf_sample_kernel``, ``gf_sample_tiled``)
that two trees both build is each tree's as the first tree's, instruction
for instruction (``cuobjdump -sass``), and how many SASS instructions one
``erff`` takes (a probe kernel built with the kernels' flags, with and
without it), then, in a process of its own for each tree, in the order
given and back (parent, change, change, parent), times with
``chip_smoke.time_ms`` (the median after a warm-up), one JSON line a
process:

* the flagship NSF's ``nsf_density``, ``nsf_apply`` and ``nsf_sample``
  (without log q, with it, raw) at 1M and 262,144 rows, and a seeded
  MAF(6)'s ``nsf_density`` and ``nsf_apply`` at 1M and 262,144 rows and
  ``nsf_sample`` in the three modes at 1M rows, 5 runs; where the tree
  plans a tiled density (``nsf_fused.density_tile_rows``), the flagship's
  ``nsf_density`` and ``nsf_apply`` at 1M rows at each tile of 32, 64 and
  128 rows (``tile<R>_...``), and so the NCSF's, SOSPF's and BPF's where
  the tree plans their tiled density (``ncsf_tile<R>_...``,
  ``sospf_tile<R>_...``, ``bpf_tile<R>_...``);
* the NCSF, SOSPF and BPF flagships' ``nsf_density`` and ``nsf_apply``
  (the ``crqs``, ``sosp`` and ``bernstein`` modes of K1 and K2) at the 1M
  rows they are served at and at the 65,536 of steps (m), (o) and (q), 3
  runs; on the host clock (``chip_smoke.host_ms``, 21 runs) the density
  at 65,536 rows and each of the two weight buffers its wrapper builds a
  call (``_pack_weights``, ``_tiled_weights``);
* the NCSF, SOSPF and BPF flagships' ``nsf_sample`` (the ``crqs``,
  ``sosp`` and ``bernstein`` modes of K3) in the three modes (without log
  q, with it, raw): NCSF's at the 1M rows it is served at and at the
  16,384 of step (n), on draws of its box base (uniform on [-pi, pi]);
  SOSPF's at the 262,144 rows it is served at and at the 16,384 of (p);
  BPF's at 262,144, 65,536 and 16,384; 3 runs;
* the flagship GF's (``tools/gf_truth_f64.npz``) ``gf_density`` (K6) and
  ``gf_sample`` (K7) without and with log q at 1M and 262,144 rows, and a
  seeded GF(6, 4)'s under a batched context (a context a row) at 1M rows,
  5 runs (``gf_...``, ``gf_batched_...``); where the tree tiles the GF
  sampler (``gf_fused._GF_TILE``), the flagship's ``gf_sample`` in both
  modes at 1M rows at each tile of 32, 64 and 128 rows
  (``gf_tile<R>_...``);
* ``masked_linear`` at the flagship MADE's three layer shapes at 262,144
  rows: 21 runs of 20 queued calls (``ml_...``) and 21 runs of one call
  (``ml_..._single``);
* the flagship UNAF's ``naf_sample`` without and with log q at 65,536 and
  16,384 rows, and its ``naf_density`` at 262,144, 3 runs;
* the flagship NAF's ``naf_sample`` without and with log q at 65,536 and
  262,144 rows, and its ``naf_density`` at 1M and 262,144 rows, 3 runs;
* the flagship CNF's ``cnf_adjoint`` with the log-q cotangent and without a
  trace at 16,384 rows, the inputs of a step of (l) (``chip_smoke.py``):
  samples ``cnf_sample`` draws with log q from seeded base draws, the
  cotangents of ``mean(lq) - mean(ring(x))``, 5 runs; its ``cnf_density``
  at 262,144 and 65,536 rows and ``cnf_sample`` without and with log q at
  262,144 and 16,384, 3 runs;
* K10's log-densities on seeded inputs, the cases of ``chip_smoke.py``
  phase 13: the flagship at 262,144 rows, a seeded CNF(6, 4) with a
  context a row at 65,536, the same with Hutchinson's trace and a probe,
  the flagship at a ragged 65,499 rows and at 4,097 (one row in the last
  tile); saved in the tree's ``build/``, and once every tree has run, each
  case's largest difference from the first tree's (the parent's) is
  printed with whether it is bit for bit;
* on the host clock between synchronisations (``chip_smoke.host_ms``, the
  median of 9 after a warm-up), a training step through each IFT from the
  flagship's weights: the reverse-KL steps of ``chip_smoke.py`` on its ring
  energy, (b) NSF at 262,144 draws, (h) NAF at 65,536, (j) UNAF, (n) NCSF,
  (p) SOSPF and (r) BPF at 16,384 (``step_...``); step (l), reverse KL
  through the flagship CNF's sampler with log q and its continuous adjoint
  at 16,384 draws; step (k), the flagship CNF's maximum-likelihood step
  at 65,536 seeded standard-normal rows; steps (m), (o) and (q), the
  flagship NCSF's, SOSPF's and BPF's maximum-likelihood steps at 65,536 of
  their own samples; the flagship NSF's (a) maximum-likelihood step on
  262,144 of its samples and (c) reverse KL through its inverted flow
  ``Flow(flow.transform.inv, flow.base)`` at 262,144 draws; and the
  flagship GF's (e) maximum-likelihood step on 262,144 of its samples and
  (f) reverse KL through its IFT at 262,144 draws.

``CHANGE_DIR`` defaults to this checkout; with more than one, each is timed
in turn after the parent. With ``--steps`` first it times the steps alone,
three times in that order and back (parent, change, change, parent, parent,
...: six processes a tree), whose host-clock times vary between processes
more than the kernels' do; ``--steps=a,c,m`` times those steps alone.
``--series=o`` (or ``--series=o,m``) takes those steps in the same six
processes a tree and prints, for each step and process, the host-clock
time of each of 30 runs after a warm-up, the machine's CPU steal and load
over them, and over 5 more runs under ``torch.profiler`` the host's time
a step, the card's busy time a step (the sum of the kernels' own times)
and the host's busiest operations. Trees are compared only within one
call, on one card.
"""

import functools
import json
import os
import re
import subprocess
import sys
import time

from pathlib import Path

ROOT = Path(__file__).resolve().parent
K10_FILE = "chip_ab_k10.pt"  # a tree's K10 log-densities, in its build/


def build(trees):
    """Every tree's kernels into its build/, by its own ``_build.build_all``,
    all trees at once; prints each tree's ptxas report of the NSF and CNF
    kernels (registers, spills, stack frame and shared memory of each entry
    point), and whether each NSF sampler of each later tree is the first
    tree's instruction for instruction."""
    report = ("from zuko_tpu_torch.ops import _build; r = _build.build_all(force=True);"
              " print(r.get('nsf_fused', '') + r.get('gf_fused', '') + r.get('cnf_fused', ''))")
    jobs = [subprocess.Popen([sys.executable, "-c", report], cwd=tree, stdout=subprocess.PIPE,
                             text=True) for tree in trees]
    for tree, job in zip(trees, jobs):
        log, _ = job.communicate()
        if job.returncode != 0:
            raise SystemExit("chip_ab: a build failed")
        for line in log.splitlines():
            if any(k in line for k in ("Compiling entry", "registers", "spill", "smem")):
                print(f"{tree.name}: {line.strip()}")
    for library in ("nsf_fused", "gf_fused"):
        first = sass(trees[0], library)
        for tree in trees[1:]:
            other = sass(tree, library)
            print(f"SASS of {library}: only in {trees[0].name}: {sorted(set(first) - set(other))};"
                  f" only in {tree.name}: {sorted(set(other) - set(first))}")
            for name, code in first.items():
                if name in other:
                    same = other[name] == code
                    differ = [(a, b) for a, b in zip(code, other[name]) if a != b]
                    print(f"SASS of {name}, {tree.name} vs {trees[0].name}: {len(code)} lines,"
                          f" identical {same}" + ("" if same else
                                                  f" ({len(differ)} differ of {len(other[name])};"
                                                  f" the first: {differ[:1]})"))
    erff_sass(trees[0])


_CUDA = os.environ.get("CUDA_HOME", "/usr/local/cuda")
# the kernels of each library whose SASS is compared
_SASS_KERNELS = {
    "nsf_fused": ("nsf_sample_tiled", "nsf_sample_kernel", "nsf_density_kernel",
                  "nsf_density_tiled"),
    "gf_fused": ("gf_density_kernel", "gf_sample_kernel", "gf_sample_tiled"),
}


def sass(tree, library):
    """The SASS of the tree's kernels of ``library`` (``_SASS_KERNELS``),
    by mangled name: their instruction lines with their encodings."""
    dump = subprocess.run([os.path.join(_CUDA, "bin", "cuobjdump"), "-sass",
                           str(tree / "build" / f"lib{library}.so")],
                          capture_output=True, text=True, check=True).stdout
    # the anonymous namespace's mangled name carries a hash of the source
    # file: compare without it
    unhash = functools.partial(re.sub, r"_GLOBAL__N__\w+?_cu_[0-9a-f]+", "_GLOBAL__N_")
    functions, name = {}, None
    for line in dump.splitlines():
        if "Function :" in line:
            name = unhash(line.split("Function :")[1].strip())
            # the tiled Bernstein sampler was nsf_sample_tiled<mode, 24> (the
            # registers) before the template took the univariate, <mode,
            # kBernstein = 4> since: pair the two
            name = re.sub(r"(nsf_sample_tiledILi\d)ELi24EE", r"\1ELi4EE", name)
            # the tiled density was nsf_density_tiled<kRaw> (affine and RQS)
            # before the template took the univariate, <kRaw, 0> since
            name = re.sub(r"(nsf_density_tiledILb[01])EEEv", r"\1ELi0EEEv", name)
            name = name if any(k in name for k in _SASS_KERNELS[library]) else None
            if name:
                functions[name] = []
        elif name and line.strip().startswith("/*"):
            # an instruction's line or its encoding's second half; the
            # padding before the encoding follows the file's longest line
            functions[name].append(unhash(" ".join(line.split())))
    return functions


def erff_sass(tree):
    """How many SASS instructions one ``erff`` takes, as the kernels are
    built (``_build._FLAGS``): a probe kernel ``y = erff(x * c)`` against
    ``y = x * c``, each an element a thread, their instructions counted
    without the ``NOP`` padding; the ``MUFU`` among them printed beside."""
    probe = tree / "build" / "erff_probe.cu"
    probe.write_text(
        "extern \"C\" __global__ void plain(const float* x, float* y) {\n"
        "  const int i = threadIdx.x; y[i] = x[i] * 0.70710678f; }\n"
        "extern \"C\" __global__ void with_erff(const float* x, float* y) {\n"
        "  const int i = threadIdx.x; y[i] = erff(x[i] * 0.70710678f); }\n")
    cubin = probe.with_suffix(".cubin")
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]
    subprocess.run([os.path.join(_CUDA, "bin", "nvcc"), *flags, "-cubin", "-o", str(cubin),
                    str(probe)], check=True)
    dump = subprocess.run([os.path.join(_CUDA, "bin", "cuobjdump"), "-sass", str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in dump.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = [0, 0]
        elif name and re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(\S+)", line):
            op = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?(\S+)", line).group(1)
            if op != "NOP":
                counts[name][0] += 1
                counts[name][1] += op.startswith("MUFU")
    (n_erff, mufu), (n_plain, _) = counts["with_erff"], counts["plain"]
    print(f"erff: {n_erff - n_plain} SASS instructions ({n_erff} with it, {n_plain} without;"
          f" MUFU {mufu}), nvcc {' '.join(flags)}")


def time_tree(tree, steps_only=None):
    """One JSON line: the tree's kernel and step times (ms), or with
    ``steps_only`` (``--steps`` or ``--steps=a,c,...``) its step times
    alone."""
    import torch

    from chip_smoke import host_ms, time_ms  # this checkout's, before the tree joins the path

    sys.path.insert(0, str(tree))

    import zuko_tpu_torch as zt

    from zuko_tpu_torch.ops import _build, cnf_fused, gf_fused, masked_linear, naf_fused, nsf_fused

    assert Path(_build.__file__).resolve().is_relative_to(tree), _build.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    assets = tree / "zuko_tpu_torch" / "assets"
    if steps_only:
        only = steps_only.partition("=")[2]
        if steps_only.startswith("--series"):
            print(json.dumps({"tree": str(tree), **step_series(
                zt, assets, dev, host_ms, only.split(","))}), flush=True)
            return
        print(json.dumps({"tree": str(tree), **time_ift_steps(
            zt, assets, dev, host_ms, only.split(",") if only else None)}), flush=True)
        return
    flow = zt.load_params(zt.NSF(6, 0, transforms=3, device=dev), assets / "nsf_flagship.npz")
    params, layout, cfg = nsf_fused._flatten_flow(flow)
    st = nsf_fused._statics(cfg, 6)
    ps = [p.detach() for p in params]
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"tree": str(tree)}
    with torch.no_grad():
        for rows in (1 << 20, 1 << 18):
            x = torch.randn(rows, 6, generator=gen, device=dev)
            for name, mode in (("density", None), ("apply", "apply"), ("sample", False),
                               ("sample_log_prob", True), ("sample_raw", "raw")):
                def fn():
                    if mode is None:
                        return nsf_fused.nsf_density(x, ps, layout, *st)
                    if mode == "apply":
                        return nsf_fused.nsf_apply(x, ps, layout, *st)
                    return nsf_fused.nsf_sample(x, ps, layout, *st, want_log_prob=mode)

                out[f"{name}@{rows}"] = round(time_ms(fn, 5)[0], 3)
        if hasattr(nsf_fused, "density_tile_rows"):  # a tree with the tiled density
            x = torch.randn(1 << 20, 6, generator=gen, device=dev)
            out.update(tile_sweep(nsf_fused, time_ms, "", x, ps, layout, st))
        torch.manual_seed(0)
        maf = zt.MAF(6, 0, transforms=3, device=dev)
        mps, mlayout, mcfg = nsf_fused._flatten_flow(maf)
        mps, mst = [p.detach() for p in mps], nsf_fused._statics(mcfg, 6)
        for rows in (1 << 20, 1 << 18):
            x = torch.randn(rows, 6, generator=gen, device=dev)
            for name, fn in (("density", nsf_fused.nsf_density), ("apply", nsf_fused.nsf_apply)):
                out[f"maf_{name}@{rows}"] = round(time_ms(
                    lambda: fn(x, mps, mlayout, *mst), 5)[0], 3)
        x = torch.randn(1 << 20, 6, generator=gen, device=dev)
        for name, mode in (("sample", False), ("sample_log_prob", True), ("sample_raw", "raw")):
            out[f"maf_{name}@{1 << 20}"] = round(time_ms(
                lambda: nsf_fused.nsf_sample(x, mps, mlayout, *mst, want_log_prob=mode), 5)[0], 3)
        # K3's other modes at the rows their serving paths sample and their
        # reverse-KL steps draw, on draws of the flow's base: NCSF at 1M and
        # (n)'s 16,384, SOSPF at 262,144 and (p)'s 16,384, BPF at 262,144,
        # 65,536 and (r)'s 16,384
        modes = {False: "sample", True: "sample_log_prob", "raw": "sample_raw"}
        for key, make, rows in (("ncsf", zt.NCSF, (1 << 20, 1 << 14)),
                                ("sospf", zt.SOSPF, (1 << 18, 1 << 14)),
                                ("bpf", zt.BPF, (1 << 18, 1 << 16, 1 << 14))):
            pflow = zt.load_params(make(6, 0, transforms=3, device=dev),
                                   assets / f"{key}_flagship.npz")
            pps, playout, pcfg = nsf_fused._flatten_flow(pflow)
            pps, pst = [p.detach() for p in pps], nsf_fused._statics(pcfg, 6)
            # K1 and K2 in the mode, at the served 1M rows and the 65,536
            # of steps (m), (o), (q), on draws of the base (inside its box);
            # where the tree plans the mode's tiled density, at 1M rows at
            # each tile
            for n in (1 << 20, 1 << 16):
                z = nsf_fused._base_draws((pps, playout, pcfg), (n,), None, gen, pcfg["base"])[1]
                for name, fn in (("density", nsf_fused.nsf_density),
                                 ("apply", nsf_fused.nsf_apply)):
                    out[f"{key}_{name}@{n}"] = round(time_ms(
                        lambda: fn(z, pps, playout, *pst), 3)[0], 3)
            # on the host clock (synchronised, 21 runs): the density at
            # 65,536 rows, and the two weight buffers the wrapper builds a
            # call, the packed one (every tier) and the tiled tier's
            out[f"{key}_density_host@{1 << 16}"] = round(host_ms(
                lambda: nsf_fused.nsf_density(z, pps, playout, *pst), 21)[0], 3)
            out[f"{key}_pack_weights_host"] = round(host_ms(
                lambda: nsf_fused._pack_weights(pps, playout, 6, 0, pcfg["bins"], pcfg["univ"]),
                21)[0], 3)
            out[f"{key}_tiled_weights_host"] = round(host_ms(
                lambda: nsf_fused._tiled_weights(pps, playout), 21)[0], 3)
            # the merged predicate (since the sum of squares' density is
            # tiled), or the density's own before
            tiled = getattr(nsf_fused, "_tiled", None) or getattr(nsf_fused, "_density_tiled", None)
            if tiled is not None and tiled(pcfg["univ"], pcfg["bins"]):
                z = nsf_fused._base_draws((pps, playout, pcfg), (1 << 20,), None, gen,
                                          pcfg["base"])[1]
                out.update(tile_sweep(nsf_fused, time_ms, f"{key}_", z, pps, playout, pst))
            for n in rows:
                z = nsf_fused._base_draws((pps, playout, pcfg), (n,), None, gen, pcfg["base"])[1]
                for mode, name in modes.items():
                    out[f"{key}_{name}@{n}"] = round(time_ms(
                        lambda: nsf_fused.nsf_sample(z, pps, playout, *pst, want_log_prob=mode),
                        3)[0], 3)
        out.update(time_gf(zt, gf_fused, tree, dev, gen, time_ms))
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
            for rows in (1 << 18,) if label == "unaf" else (1 << 20, 1 << 18):
                x = torch.randn(rows, 6, generator=gen, device=dev)
                out[f"{label}_density@{rows}"] = round(time_ms(
                    lambda: naf_fused.naf_density(x, nps, nlayout, F, S), 3)[0], 3)
        cflow = zt.load_params(zt.CNF(6, device=dev), assets / "cnf_flagship.npz")
        cps, _, ccfg = cnf_fused._flatten_cnf(cflow, cflow.transform(None), None)
        cps = [p.detach() for p in cps]
        for rows in (1 << 18, 1 << 16):
            x = torch.randn(rows, 6, generator=gen, device=dev)
            out[f"cnf_density@{rows}"] = round(time_ms(
                lambda: cnf_fused.cnf_density(x, None, cps, None, ccfg), 3)[0], 3)
        for rows in (1 << 18, 1 << 14):  # the serving rows, then (l)'s
            z = torch.randn(rows, 6, generator=gen, device=dev)
            for name, want in (("cnf_sample", False), ("cnf_sample_log_prob", True)):
                out[f"{name}@{rows}"] = round(time_ms(
                    lambda: cnf_fused.cnf_sample(z, None, cps, None, ccfg, want), 3)[0], 3)
        x, _ = cnf_fused.cnf_sample(z, None, cps, None, ccfg, True)
        torch.save(k10_log_densities(zt, cnf_fused, cflow, cps, ccfg, dev),
                   tree / "build" / K10_FILE)
    # (l)'s cotangents: mean(lq) - mean(ring(x)), ring(x) = -(|x| - 2)^2 / 0.1
    xr = x.clone().requires_grad_(True)
    (((xr.norm(dim=-1) - 2.0) ** 2 / 0.1).mean()).backward()
    gx, glq = xr.grad.contiguous(), torch.full((rows,), 1.0 / rows, device=dev)
    with torch.no_grad():
        for name, lq in (("cnf_adjoint_log_prob", glq), ("cnf_adjoint", None)):
            out[f"{name}@{rows}"] = round(time_ms(
                lambda: cnf_fused.cnf_adjoint(x, gx, lq, None, cps, None, ccfg), 5)[0], 3)
    out.update(time_ift_steps(zt, assets, dev, host_ms))
    print(json.dumps(out), flush=True)


def gf_trained(zt, tree, dev):
    """The flagship GF of ``chip_smoke.py``: ``GF(6, 0, transforms=3,
    components=8)`` with the trained parameters of ``tools/gf_truth_f64.npz``
    and the standard-normal base."""
    import numpy as np

    truth = np.load(tree / "tools" / "gf_truth_f64.npz")
    weights = {k: truth[k] for k in truth.files if k not in ("x", "lp")}
    weights.update({"base.args.0": np.zeros(6, np.float32),
                    "base.args.1": np.ones(6, np.float32)})
    return zt.load_params(zt.GF(6, 0, transforms=3, components=8, device=dev), weights)


def time_gf(zt, gf_fused, tree, dev, gen, time_ms):
    """K6 and K7 (ms): the flagship GF's density and sampler in both modes at
    1M and 262,144 rows, a seeded GF(6, 4)'s under a batched context at 1M
    rows, and where the tree tiles the sampler its tile sweep at 1M rows."""
    import torch

    out = {}
    gf = gf_trained(zt, tree, dev)
    torch.manual_seed(2)
    cond = zt.GF(6, 4, transforms=3, device=dev)
    cases = [("gf", gf, None, rows) for rows in (1 << 20, 1 << 18)]
    cases.append(("gf_batched", cond, torch.randn(1 << 20, 4, generator=gen, device=dev), 1 << 20))
    for key, flow, c, rows in cases:
        params, layout, F, _ = gf_fused._flatten_gf(flow, c)
        params = gf_fused._row_params([p.detach() for p in params], layout, (rows,))
        x = torch.randn(rows, F, generator=gen, device=dev)
        out[f"{key}_density@{rows}"] = round(time_ms(
            lambda: gf_fused.gf_density(x, params, layout, F), 5)[0], 3)
        for name, want in (("sample", False), ("sample_log_prob", True)):
            out[f"{key}_{name}@{rows}"] = round(time_ms(
                lambda: gf_fused.gf_sample(x, params, layout, F, want), 5)[0], 3)
        if key == "gf" and rows == 1 << 20 and hasattr(gf_fused, "_GF_TILE"):
            tile = gf_fused._GF_TILE
            try:
                for R in (32, 64, 128):
                    gf_fused._GF_TILE = R
                    for name, want in (("sample", False), ("sample_log_prob", True)):
                        out[f"gf_tile{R}_{name}@{rows}"] = round(time_ms(
                            lambda: gf_fused.gf_sample(x, params, layout, F, want), 5)[0], 3)
            finally:
                gf_fused._GF_TILE = tile
    return out


def tile_sweep(nsf_fused, time_ms, prefix, x, ps, layout, st):
    """``nsf_density`` and ``nsf_apply`` at the rows ``x`` at each tile of
    32, 64 and 128 rows (``<prefix>tile<R>_...``), 5 runs."""
    out, tile_rows = {}, nsf_fused.density_tile_rows
    try:
        for R in (32, 64, 128):
            nsf_fused.density_tile_rows = lambda *a, R=R: R
            for name, fn in (("density", nsf_fused.nsf_density), ("apply", nsf_fused.nsf_apply)):
                out[f"{prefix}tile{R}_{name}@{x.shape[0]}"] = round(time_ms(
                    lambda: fn(x, ps, layout, *st), 5)[0], 3)
    finally:
        nsf_fused.density_tile_rows = tile_rows
    return out


def k10_log_densities(zt, cnf_fused, cflow, cps, ccfg, dev):
    """K10's log-densities (on the CPU) of phase 13's cases on inputs and
    weights made from seeds, the same in every tree."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(14)
    c = torch.randn(1 << 16, 4, generator=gen, device=dev)
    cases = {}
    for exact, seed in ((True, 40), (False, 41)):
        torch.manual_seed(seed)
        flow = zt.CNF(6, 4, exact=exact, device=dev)
        params, _, cfg = cnf_fused._flatten_cnf(flow, flow.transform(c[:1], generator=gen), c[:1])
        eps = None if exact else torch.randn(1 << 16, 6, generator=gen, device=dev)
        cases["conditional" if exact else "hutchinson"] = (
            [p.detach() for p in params], cfg, torch.randn(1 << 16, 6, generator=gen, device=dev),
            c, eps)
    for label, rows in (("flagship", 1 << 18), ("ragged", (1 << 16) - 37), ("one_row", 4097)):
        cases[label] = (cps, ccfg, torch.randn(rows, 6, generator=gen, device=dev), None, None)
    with torch.no_grad():
        return {label: cnf_fused.cnf_density(x, eps, params, cc, cfg).cpu()
                for label, (params, cfg, x, cc, eps) in cases.items()}


def compare_k10(trees):
    """Each tree's K10 log-densities against the first tree's: the largest
    difference of each case and whether it is bit for bit."""
    import torch

    first = torch.load(trees[0] / "build" / K10_FILE)
    for tree in trees[1:]:
        other = torch.load(tree / "build" / K10_FILE)
        for label, lp in first.items():
            print(f"K10 log-densities, {label} ({lp.shape[0]} rows), {tree.name} vs"
                  f" {trees[0].name}: max |diff| {(other[label] - lp).abs().max().item():.3e},"
                  f" bit for bit {torch.equal(other[label], lp)}")


def ift_steps(zt, assets, dev):
    """The training steps of ``chip_smoke.py``'s kinds from the flagships'
    weights, tag -> (flagship, rows, a function that makes the step's
    ``(step_fn, state, args)``): the reverse-KL steps through the IFT on its
    ring energy and (l)'s through the CNF's continuous adjoint, (k), (m),
    (o), (q), (a), (c), (e) and (f)."""
    import torch

    from zuko_tpu_torch.lazy import Flow

    def ring(x):
        return -((x.norm(dim=-1) - 2.0) ** 2) / 0.1

    def load(key, make):
        return zt.load_params(make(), assets / f"{key}_flagship.npz")

    def samples(flow, rows):
        with torch.no_grad():
            return flow(None).sample((rows,), generator=torch.Generator(device=dev).manual_seed(0))

    def reverse_kl(flow, rows):
        init_fn, step_fn = zt.make_reverse_kl_step(flow, ring, n_samples=rows, lr=1e-3)
        return step_fn, init_fn(), (torch.Generator(device=dev).manual_seed(0),)

    def mle(flow, x=None, rows=None):
        """Maximum likelihood on ``x``, or on ``rows`` of the flow's own
        samples."""
        x = samples(flow, rows) if x is None else x
        init_fn, step_fn = zt.make_mle_step(flow, lr=1e-3)
        return step_fn, init_fn(), (x,)

    def family(make):
        return lambda: make(6, 0, transforms=3, device=dev)

    nsf = lambda: zt.NSF(6, 0, transforms=3, device=dev)  # noqa: E731
    gf = lambda: gf_trained(zt, assets.parents[1], dev)  # noqa: E731
    steps = {  # tag -> (key, rows, the step's (step_fn, state, args))
        "b": ("nsf", 1 << 18, lambda: reverse_kl(load("nsf", nsf), 1 << 18)),
        "h": ("naf", 1 << 16, lambda: reverse_kl(load("naf", lambda: zt.NAF(
            6, 0, transforms=3, signal=16, device=dev)), 1 << 16)),
        "j": ("unaf", 1 << 14, lambda: reverse_kl(load("unaf", lambda: zt.UNAF(
            6, 0, transforms=3, signal=16, device=dev)), 1 << 14)),
        "n": ("ncsf", 1 << 14, lambda: reverse_kl(load("ncsf", family(zt.NCSF)), 1 << 14)),
        "p": ("sospf", 1 << 14,
              lambda: reverse_kl(load("sospf", family(zt.SOSPF)), 1 << 14)),
        "r": ("bpf", 1 << 14, lambda: reverse_kl(load("bpf", family(zt.BPF)), 1 << 14)),
        # (l): reverse KL through the flagship CNF's sampler and its adjoint
        "l": ("cnf", 1 << 14, lambda: reverse_kl(load("cnf", lambda: zt.CNF(6, device=dev)),
                                                 1 << 14)),
        # (k): maximum likelihood on the flagship CNF at seeded rows
        "k": ("cnf", 1 << 16, lambda: mle(load("cnf", lambda: zt.CNF(6, device=dev)), torch.randn(
            1 << 16, 6, generator=torch.Generator(device=dev).manual_seed(0), device=dev))),
        # (m), (o), (q): maximum likelihood on the NCSF, SOSPF and BPF at
        # 65,536 of their own samples
        **{tag: (key, 1 << 16, lambda key=key, make=make: mle(load(key, family(make)),
                                                             rows=1 << 16))
           for tag, key, make in (("m", "ncsf", zt.NCSF), ("o", "sospf", zt.SOSPF),
                                  ("q", "bpf", zt.BPF))},
        # (a), (c): the flagship NSF's maximum likelihood on 262,144 of its
        # samples, and reverse KL through its inverted flow
        "a": ("nsf", 1 << 18, lambda: mle(load("nsf", nsf), rows=1 << 18)),
        "c": ("nsf_inv", 1 << 18, lambda: (lambda f: reverse_kl(
            Flow(f.transform.inv, f.base), 1 << 18))(load("nsf", nsf))),
        # (e), (f): the flagship GF's maximum likelihood on 262,144 of its
        # samples, and reverse KL through its IFT
        "e": ("gf", 1 << 18, lambda: mle(gf(), rows=1 << 18)),
        "f": ("gf", 1 << 18, lambda: reverse_kl(gf(), 1 << 18)),
    }
    return steps


def stepper(make):
    """One call of the step that ``make`` builds, its state carried."""
    step_fn, state, args = make()

    def one():
        nonlocal state
        state, _ = step_fn(state, *args)

    return one


def time_ift_steps(zt, assets, dev, host_ms, only=None):
    """The training steps of :func:`ift_steps` (ms, host clock, the median
    of 9 after a warm-up); with ``only``, those tags alone."""
    out = {}
    for tag, (key, rows, make) in ift_steps(zt, assets, dev).items():
        if only is None or tag in only:
            out[f"step_{tag}_{key}@{rows}"] = round(host_ms(stepper(make), 9)[0], 3)
    return out


def cpu_times():
    """The machine's CPU time so far, (total, steal), in clock ticks
    (``/proc/stat``)."""
    with open("/proc/stat") as f:
        ticks = [int(v) for v in f.readline().split()[1:]]
    return sum(ticks[:8]), ticks[7]


def step_series(zt, assets, dev, host_ms, only, runs=30, profiled=5):
    """Each step of ``only`` (tags of :func:`ift_steps`) ``runs`` times
    after a warm-up: each run's host-clock ms between synchronisations, the
    machine's CPU steal share and load average over them; then ``profiled``
    runs under ``torch.profiler``: the host's ms a step, the card's busy ms
    a step (the kernels' own times summed), and a table of the host's
    busiest operations on standard error."""
    import torch

    out = {}
    for tag, (key, rows, make) in ift_steps(zt, assets, dev).items():
        if tag not in only:
            continue
        one = stepper(make)
        total0, steal0 = cpu_times()
        series = host_ms(one, runs)[1]
        total1, steal1 = cpu_times()
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(profiled):
                one()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        events = prof.key_averages()
        busy = sum(getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0) for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA)
        print(events.table(sort_by="self_cpu_time_total", row_limit=12), file=sys.stderr)
        out[f"series_{tag}_{key}@{rows}"] = {
            "host_ms": [round(t, 3) for t in series],
            "steal": round((steal1 - steal0) / max(1, total1 - total0), 4),
            "loadavg": os.getloadavg(),
            "profiled_host_ms": round(wall / profiled, 3),
            "profiled_busy_ms": round(busy / 1e3 / profiled, 3),
        }
    return out


def main():
    if len(sys.argv) >= 3 and sys.argv[1] == "--time":
        time_tree(Path(sys.argv[2]).resolve(), *sys.argv[3:4])
        return 0
    args = sys.argv[1:]
    steps_only = args[0] if args and args[0].startswith(("--steps", "--series")) else None
    args = args[steps_only is not None:]
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 1
    trees = [Path(arg).resolve() for arg in args] + ([ROOT] if len(args) == 1 else [])
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    build(trees)
    for tree in (trees + trees[::-1]) * (3 if steps_only else 1):
        subprocess.run([sys.executable, __file__, "--time", str(tree)]
                       + ([steps_only] if steps_only else []), check=True)
    if not steps_only:
        compare_k10(trees)
    return 0


if __name__ == "__main__":
    sys.exit(main())
