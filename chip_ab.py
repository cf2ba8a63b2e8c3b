#!/usr/bin/env python3
r"""Time the kernels and the IFT training steps of checkouts on one GPU, in turns.

Run from the root of a checkout, with the parent's checkout (``git archive``
unpacked into a directory ``.gitignore`` lists) as the argument::

    python3 chip_ab.py [--steps] PARENT_DIR [CHANGE_DIR ...]

It builds the kernels of each tree with that tree's own ``ops/_build.py``
(all trees at once) into that tree's ``build/``, prints each tree's ptxas
report of the NSF and CNF kernels (registers, spills, stack frame and
shared memory of each entry point) and whether the SASS of each NSF
kernel (the samplers ``nsf_sample_tiled`` and ``nsf_sample_kernel``, the
densities ``nsf_density_kernel`` and ``nsf_density_tiled``) that two
trees both build is each tree's as the first tree's, instruction for
instruction (``cuobjdump -sass``), then, in a process of its own for each
tree, in the order given and back (parent, change, change, parent), times
with ``chip_smoke.time_ms`` (the median after a warm-up), one JSON line a
process:

* the flagship NSF's ``nsf_density``, ``nsf_apply`` and ``nsf_sample``
  (without log q, with it, raw) at 1M and 262,144 rows, and a seeded
  MAF(6)'s ``nsf_density`` and ``nsf_apply`` at 1M and 262,144 rows and
  ``nsf_sample`` in the three modes at 1M rows, 5 runs; where the tree
  plans a tiled density (``nsf_fused.density_tile_rows``), the flagship's
  ``nsf_density`` and ``nsf_apply`` at 1M rows at each tile of 32, 64 and
  128 rows (``tile<R>_...``), and so the NCSF's and BPF's where the tree
  plans their tiled density (``ncsf_tile<R>_...``, ``bpf_tile<R>_...``);
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
  at 65,536 seeded standard-normal rows; steps (m) and (q), the flagship
  NCSF's and BPF's maximum-likelihood steps at 65,536 of their own
  samples; and the flagship NSF's (a)
  maximum-likelihood step on 262,144 of its samples and (c) reverse KL
  through its inverted flow ``Flow(flow.transform.inv, flow.base)`` at
  262,144 draws.

``CHANGE_DIR`` defaults to this checkout; with more than one, each is timed
in turn after the parent. With ``--steps`` first it times the steps alone,
three times in that order and back (parent, change, change, parent, parent,
...: six processes a tree), whose host-clock times vary between processes
more than the kernels' do. Trees are compared only within one call, on one
card.
"""

import functools
import json
import os
import re
import subprocess
import sys

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
              " print(r.get('nsf_fused', '') + r.get('cnf_fused', ''))")
    jobs = [subprocess.Popen([sys.executable, "-c", report], cwd=tree, stdout=subprocess.PIPE,
                             text=True) for tree in trees]
    for tree, job in zip(trees, jobs):
        log, _ = job.communicate()
        if job.returncode != 0:
            raise SystemExit("chip_ab: a build failed")
        for line in log.splitlines():
            if any(k in line for k in ("Compiling entry", "registers", "spill", "smem")):
                print(f"{tree.name}: {line.strip()}")
    first = nsf_sass(trees[0])
    for tree in trees[1:]:
        other = nsf_sass(tree)
        print(f"SASS: only in {trees[0].name}: {sorted(set(first) - set(other))}; only in"
              f" {tree.name}: {sorted(set(other) - set(first))}")
        for name, code in first.items():
            if name in other:
                same = other[name] == code
                differ = [(a, b) for a, b in zip(code, other[name]) if a != b]
                print(f"SASS of {name}, {tree.name} vs {trees[0].name}: {len(code)} lines,"
                      f" identical {same}" + ("" if same else
                                              f" ({len(differ)} differ of {len(other[name])};"
                                              f" the first: {differ[:1]})"))


def nsf_sass(tree):
    """The SASS of the tree's NSF kernels (``nsf_sample_tiled``,
    ``nsf_sample_kernel``, ``nsf_density_kernel``, ``nsf_density_tiled``),
    by mangled name: their instruction lines with their encodings."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    dump = subprocess.run([cuobjdump, "-sass", str(tree / "build" / "libnsf_fused.so")],
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
            kernels = ("nsf_sample_tiled", "nsf_sample_kernel", "nsf_density_kernel",
                       "nsf_density_tiled")
            name = name if any(k in name for k in kernels) else None
            if name:
                functions[name] = []
        elif name and line.strip().startswith("/*"):
            # an instruction's line or its encoding's second half; the
            # padding before the encoding follows the file's longest line
            functions[name].append(unhash(" ".join(line.split())))
    return functions


def time_tree(tree, steps_only=False):
    """One JSON line: the tree's kernel and step times (ms), or with
    ``steps_only`` its step times alone."""
    import torch

    from chip_smoke import host_ms, time_ms  # this checkout's, before the tree joins the path

    sys.path.insert(0, str(tree))

    import zuko_tpu_torch as zt

    from zuko_tpu_torch.ops import _build, cnf_fused, masked_linear, naf_fused, nsf_fused

    assert Path(_build.__file__).resolve().is_relative_to(tree), _build.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    assets = tree / "zuko_tpu_torch" / "assets"
    if steps_only:
        print(json.dumps({"tree": str(tree), **time_ift_steps(zt, assets, dev, host_ms)}),
              flush=True)
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
            if hasattr(nsf_fused, "_density_tiled") and nsf_fused._density_tiled(
                    pcfg["univ"], pcfg["bins"]):
                z = nsf_fused._base_draws((pps, playout, pcfg), (1 << 20,), None, gen,
                                          pcfg["base"])[1]
                out.update(tile_sweep(nsf_fused, time_ms, f"{key}_", z, pps, playout, pst))
            for n in rows:
                z = nsf_fused._base_draws((pps, playout, pcfg), (n,), None, gen, pcfg["base"])[1]
                for mode, name in modes.items():
                    out[f"{key}_{name}@{n}"] = round(time_ms(
                        lambda: nsf_fused.nsf_sample(z, pps, playout, *pst, want_log_prob=mode),
                        3)[0], 3)
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


def time_ift_steps(zt, assets, dev, host_ms):
    """The reverse-KL steps (ms) through the IFT and (l)'s through the CNF's
    continuous adjoint, from the flagships' weights, on ``chip_smoke.py``'s
    ring energy, and (k), (m), (q), (a) and (c)."""
    import torch

    from zuko_tpu_torch.lazy import Flow

    def ring(x):
        return -((x.norm(dim=-1) - 2.0) ** 2) / 0.1

    out = {}
    for tag, key, make, rows in (
            ("b", "nsf", lambda: zt.NSF(6, 0, transforms=3, device=dev), 1 << 18),
            ("h", "naf", lambda: zt.NAF(6, 0, transforms=3, signal=16, device=dev), 1 << 16),
            ("j", "unaf", lambda: zt.UNAF(6, 0, transforms=3, signal=16, device=dev), 1 << 14),
            ("n", "ncsf", lambda: zt.NCSF(6, 0, transforms=3, device=dev), 1 << 14),
            ("p", "sospf", lambda: zt.SOSPF(6, 0, transforms=3, device=dev), 1 << 14),
            ("r", "bpf", lambda: zt.BPF(6, 0, transforms=3, device=dev), 1 << 14)):
        flow = zt.load_params(make(), assets / f"{key}_flagship.npz")
        init_fn, step_fn = zt.make_reverse_kl_step(flow, ring, n_samples=rows, lr=1e-3)
        state, gen = init_fn(), torch.Generator(device=dev).manual_seed(0)

        def one():
            nonlocal state
            state, _ = step_fn(state, gen)

        out[f"step_{tag}_{key}@{rows}"] = round(host_ms(one, 9)[0], 3)
    # (l): reverse KL through the flagship CNF's sampler and its adjoint
    flow = zt.load_params(zt.CNF(6, device=dev), assets / "cnf_flagship.npz")
    init_fn, step_fn = zt.make_reverse_kl_step(flow, ring, n_samples=1 << 14, lr=1e-3)
    state, gen = init_fn(), torch.Generator(device=dev).manual_seed(0)

    def cnf_rkl():
        nonlocal state
        state, _ = step_fn(state, gen)

    out[f"step_l_cnf@{1 << 14}"] = round(host_ms(cnf_rkl, 9)[0], 3)
    # (k): maximum likelihood on the flagship CNF
    flow = zt.load_params(zt.CNF(6, device=dev), assets / "cnf_flagship.npz")
    init_fn, step_fn = zt.make_mle_step(flow, lr=1e-3)
    state = init_fn()
    x = torch.randn(1 << 16, 6, generator=torch.Generator(device=dev).manual_seed(0), device=dev)

    def mle():
        nonlocal state
        state, _ = step_fn(state, x)

    out[f"step_k_cnf@{1 << 16}"] = round(host_ms(mle, 9)[0], 3)
    # (m) and (q): maximum likelihood on the flagship NCSF and BPF at 65,536
    # of their own samples
    for tag, key, make in (("m", "ncsf", zt.NCSF), ("q", "bpf", zt.BPF)):
        flow = zt.load_params(make(6, 0, transforms=3, device=dev), assets / f"{key}_flagship.npz")
        with torch.no_grad():
            x = flow(None).sample((1 << 16,),
                                  generator=torch.Generator(device=dev).manual_seed(0))
        init_fn, step_fn = zt.make_mle_step(flow, lr=1e-3)
        state = init_fn()

        def fam_mle():
            nonlocal state
            state, _ = step_fn(state, x)

        out[f"step_{tag}_{key}@{1 << 16}"] = round(host_ms(fam_mle, 9)[0], 3)
    # (a) and (c): the flagship NSF's maximum-likelihood step on 262,144 of
    # its samples, and reverse KL through its inverted flow
    flow = zt.load_params(zt.NSF(6, 0, transforms=3, device=dev), assets / "nsf_flagship.npz")
    with torch.no_grad():
        x = flow(None).sample((1 << 18,), generator=torch.Generator(device=dev).manual_seed(0))
    init_fn, step_fn = zt.make_mle_step(flow, lr=1e-3)
    state = init_fn()

    def nsf_mle():
        nonlocal state
        state, _ = step_fn(state, x)

    out[f"step_a_nsf@{1 << 18}"] = round(host_ms(nsf_mle, 9)[0], 3)
    flow = zt.load_params(zt.NSF(6, 0, transforms=3, device=dev), assets / "nsf_flagship.npz")
    inverted = Flow(flow.transform.inv, flow.base)
    init_fn, step_fn = zt.make_reverse_kl_step(inverted, ring, n_samples=1 << 18, lr=1e-3)
    state, gen = init_fn(), torch.Generator(device=dev).manual_seed(0)

    def nsf_rkl_inv():
        nonlocal state
        state, _ = step_fn(state, gen)

    out[f"step_c_nsf_inv@{1 << 18}"] = round(host_ms(nsf_rkl_inv, 9)[0], 3)
    return out


def main():
    if len(sys.argv) >= 3 and sys.argv[1] == "--time":
        time_tree(Path(sys.argv[2]).resolve(), sys.argv[3:] == ["--steps"])
        return 0
    args = sys.argv[1:]
    steps_only = args[:1] == ["--steps"]
    args = args[steps_only:]
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
                       + ["--steps"] * steps_only, check=True)
    if not steps_only:
        compare_k10(trees)
    return 0


if __name__ == "__main__":
    sys.exit(main())
