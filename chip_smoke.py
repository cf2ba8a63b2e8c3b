#!/usr/bin/env python3
r"""Smoke run of the PyTorch port (``zuko_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the CUDA kernels from ``zuko_tpu_torch/ops/csrc`` into ``build/``,
then drives the port's main paths through the public API: the flagship NSF,
the Gaussianization flow (GF), the neural autoregressive flow (NAF), the
unconstrained one (UNAF), the continuous normalizing flow (CNF), and the
circular spline (NCSF), sum-of-squares (SOSPF) and Bernstein (BPF) flows
served and trained (the CNF by maximum likelihood and by reverse KL through
its continuous adjoint), and flows past every kernel's narrow limits served
through the kernels' wide tier.

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
  kernel; ``masked_linear`` at the flagship's three layer shapes, a ragged
  one, a row count that is no multiple of its tile, an x one float past an
  aligned address and weights past its planned shared memory (chunks of
  inputs, chunks of outputs), relative to each output's magnitude sum
  |x||W| + |b| <= 1e-5;
  ``rqs_forward`` / ``rqs_inverse`` at 6M elements, a tenth of them outside
  the spline's domain, and their round trip; and each of them again, under
  the same tolerances, at the 262,144 rows the training steps give it;
* K3's tiled tier (the closed-form sampler's narrow tier) for the flagship,
  the conditional NSF(3, 5) and the MAF, planned at tiles of 128 rows, in
  its three modes at 1M rows, 262,144 - 37 and a last tile of one valid
  row, one tiled launch each, against plain float64 and against the wide
  tier on the same draws, both at the limits above (whether it is the wide
  tier's bit for bit is printed);
* K1's and K2's tiled tier (the closed-form density's and apply's narrow
  tier) for the same three flows, planned as a ``TilePlan``, the density,
  the apply's ``T(x)`` and its sum at 1M rows, 262,144 - 37 and a last tile
  of one valid row, one tiled launch each, against plain float64 and
  against the wide tier on the same rows, max <= 1e-4 (the difference from
  the wide tier printed, with whether it is bit for bit);
* the gradient through each ``autograd.Function`` (kernel forward, plain
  float32 backward) against float64 plain autograd at 262,144 rows, and K1's
  again at the parameters and rows step (a) trains on: each parameter's
  largest |diff| over its largest |gradient| <= 1e-4, each input's gradient
  normwise <= 1e-3. This holds the Functions' wiring and their float32
  backward, not the kernels;
* that each main path launched its kernels (launch counts, zeroed just
  before each phase and read just after it), and that every training loss
  is finite and falls (mean of the last 5 steps below the first 5).

**The Gaussianization flow**: ``GF(6, 0, transforms=3, components=8)`` with
the trained parameters of ``tools/gf_truth_f64.npz`` served at 1M rows
(``log_prob``, ``sample``, ``sample_and_log_prob``), a conditional ``GF(6, 4,
transforms=3)`` from seeded weights under a batched context of 1M rows
(density) or 1024 rows x 4 draws (sampling), then trained from the trained
parameters at 262,144 rows a step: (e) maximum likelihood on the samples the
NSF serving phase drew, (f) reverse KL through the GF tier of the IFT on the
ring energy. Its checks:

* the density through the kernel against ``lp`` of ``tools/gf_truth_f64.npz``
  (median <= 1e-5, max <= 5e-4);
* ``gf_density`` and ``gf_sample`` against their plain versions in float64 at
  1M and 262,144 rows, unconditional and with per-row parameters, and at
  ``GF(21, transforms=2)`` and ``GF(64, transforms=3)`` (parameters damped
  by 0.3) for the rotation products at real widths. A density, or a log q,
  is held to median <= 1e-5 and, over the rows where no layer's output
  passes |y| = 3.5, to max <= 5e-4; the saturated rows apart, to 0.1 (see
  ``GF_SATURATED``); both limits times F / 6 for wider flows. Samples are
  held by quantiles (median <= 1e-5, 95th percentile <= 1e-2), ``x`` of
  ``sample`` and of ``sample_and_log_prob`` must be equal, the round trip
  ``T(x)`` in float64 against ``z`` over the rows that plain float64 itself
  solves to median <= 1e-5 and 99th percentile <= 1e-3, and log q over the
  solved, unsaturated rows (median <= 1e-5; against the density kernel at
  the returned points median <= 1e-4). The share of pegged rows is printed:
  the trained parameters saturate, and three quarters of standard-normal
  draws peg at the bracket in float64 as well. In the ``kernels`` line the GF
  kernels' ``max_abs_err`` is the largest error over the unsaturated rows
  (density) or the solved, unsaturated rows (samples, log q);
* the sampler's tiled tier (its narrow tier: a tile of 128 rows, one
  thread a (row, feature) pair, the pair's mixture in registers), planned
  for the flagship, GF(6, 4) under a batched context, GF(21) and GF(64),
  and held against the wide tier on the same draws in both modes, one
  tiled launch each, at 1M rows, 262,144 - 37 and 16 tiles + 1 (the last
  tile one valid row): the rows whose samples differ counted (at most 1e-3
  of them) and log q on the others within 1e-4;
* the gradients through the two GF ``autograd.Function``s against float64
  (the IFT's at the kernel's own root), over the unsaturated rows: inputs
  under the limits above, parameters max-relative <= 5e-4 (see
  ``TOL_GF_GRAD_PARAMS``); over all rows they are printed;
* launch counts of each GF phase (one ``gf_density`` a step of (e), one
  ``gf_sample`` with log q a step of (f)), losses finite and falling.

**The NAF** (phase 10): ``NAF(6, 0, transforms=3, signal=16)`` of
``zuko_tpu_torch/assets/naf_flagship.npz``, a conditional NAF(6, 4) and a
NAF(32), held against ``assets/naf_truth_f64.npz`` and plain float64 (the
narrow tier of the sampler and the density is the tiled kernel: also at a
ragged row count, and against the wide tier on the same inputs, the
density also at a ragged tile and a last tile of one valid row, the
difference printed), a NAF whose MADE has no hidden layer (scaled by 0.3)
served and held the same way, a NAF with MADE widths of 256 (past the tiled
sampler's shared memory) sampled through the wide tier, its density tiled
at tiles of 32 rows, then (g) MLE and (h) reverse KL through the NAF IFT;
K6's and K8's Functions are also held at the rows (e) and (g) train on.
**The UNAF** (phase 11): the same for ``UNAF(6, 0, transforms=3,
signal=16)`` of ``assets/unaf_flagship.npz`` and a conditional UNAF(6, 4),
through the UMNN mode of K8 and K9, against ``assets/unaf_truth_f64.npz``
(its GL-16 and GL-32 columns) and plain float64, also at a ragged row
count, and a UNAF of three hidden layers of 128 (past the tiled sampler's
shared memory) sampled through the wide tier, its density tiled at tiles
of 16 rows, then (i) MLE and (j) reverse KL; the UMNN density is timed at
each of its tiles. **The repair** (phase 12): configurations past every
narrow limit (widths, bins, linears, layers, features, components, stages,
signal, shared memory) served through the public API by the wide tier of
K1-K3 and K6-K11 and by K5 at 48 bins, held against plain float64 at their
families' tolerances, each wide kernel timed once (the CNFs: ``CNF(64, 10)``
at 1,024 rows, the shape ``zuko_tpu`` refuses at its VMEM gate, and ``CNF(3,
hidden_features=(512, 512))`` at 16,384); and the per-thread narrow
polynomial sampler, which no flagship reaches, through ``SOSPF(4,
polynomials=6, degree=4)`` and ``BPF(4, degree=30)`` (30 and 36
coefficients, past the tiled sampler's 24), served at 16,384 rows, held
against plain float64 at their family's limits and timed once (the kernels
line's ``..._thread`` entries); and the per-row narrow GF sampler, which no
flagship reaches since K7's tiled tier, through ``GF(4, components=24)``
(past the tiled sampler's 16 components in registers), served at 65,536
rows, held against plain float64 in both modes at phase 9's limits and
timed once (``gf_sample_thread``, ``gf_sample_log_prob_thread``). **The CNF** (phase 13):
``CNF(6)`` of ``zuko_tpu_torch/assets/cnf_flagship.npz`` (ODE network 12-64-64-6,
exact trace) and a conditional ``CNF(6, 4)`` under a batched context served
through K10 (``cnf_density``) and K11 (``cnf_sample``, with and without log q)
at 262,144 rows, held against ``assets/cnf_truth_f64.npz`` (density median
<= 1e-4, max <= 1e-3; samples 99th percentile <= 1e-4; log q median <= 1e-4,
max <= 1e-3) and against plain float64 at the same tiles (density and log q
median <= 1e-4, max <= 1e-3; samples median <= 1e-5, 99th percentile <= 1e-4;
log q against K10 at the returned points median <= 1e-3); K10's cluster
tier (its narrow tier) planned as a cluster a tile and held against plain
float64 at the same tiles and against the wide tier on the same rows, at
the density's limits (bit for bit printed), for the flagship, the
conditional CNF(6, 4) with a first bias a row, a Hutchinson CNF, a ragged
tile and a last tile of one valid row, one cluster launch each; K11's
cluster tier the same way, without log q and with it, in those cases and
at (l)'s 16,384 draws (samples median <= 1e-5 and 99th percentile <= 1e-4,
log q median <= 1e-4 and max <= 1e-3); K10's Function
held at (k)'s parameters and rows against the float64 gradient of the
global-step integration (parameters max-relative <= 1e-3, input normwise
<= 1e-2); **(k)** MLE at 65,536 rows a step on the NSF's samples. **Sampling
with gradients** (phase 14): ``rsample_and_log_prob`` and ``rsample`` of the
flagship CNF (16,384 draws), of the conditional CNF(6, 4) and of a
conditional CNF(6, 4) with Hutchinson's trace (each 1,024 contexts x 4
draws) with a backward, K11 forward and K12 (``cnf_adjoint``, the
continuous adjoint) backward, one launch of each a call; K12 in both modes
held against its plain version in float64 at the same tiles after the
solve-consistency gate, which must pass on every row (parameters
max-relative <= 1e-3, the draws' and the context rows' gradients normwise
<= 1e-2, the limits of K10's Function); **(l)** reverse KL through K11 with
log q and K12 at 16,384 draws a step on the ring energy, one launch of each
a step and no other kernel. Phase 12 also drives K12's wide tier on both
wide CNFs at 1,024 draws, holds it the same way and times it once on each;
phase 14 times the flagship's K12 in both tiers. **NCSF, SOSPF and BPF**
(phase 15): the flagships of ``zuko_tpu_torch/assets/{ncsf,sospf,bpf}_flagship.npz``
(``NCSF(6)``, 8 bins; ``SOSPF(6)``, degree 4, 3 polynomials, softclips
between the layers; ``BPF(6)``, degree 16; ``transforms=3``, 64x64 MADEs)
and a conditional ``(6, 4)`` of each served through the ``crqs``, ``sosp``
and ``bernstein`` modes of K1-K3 (density at 1M rows; sampling at 1M rows
for NCSF, 262,144 for the polynomials, whose inverse is a bisection and
Newton solve) and through their inverted flows; densities held against
``assets/ncsf_truth_f64.npz``, ``assets/sospf_truth_f64.npz`` and
``tools/bpf_truth_f64.npz`` (max <= 1e-4); every mode of K1, K2 and K3 (all
three outputs) against its plain version in float64 at the same inputs
(densities, log q, apply and raw sums max <= 1e-4; samples median <= 1e-5,
99th percentile <= 1e-3, NCSF's on the circle and against float64
continued on the kernel's side of the shifts' jumps, also at 16,384 rows
placed at them, the polynomials' over the rows plain float64 solves, the
pegged ones counted); each family's sampler (the tiled tier: NCSF tiles
of 128 rows, SOSPF and BPF 64) also against the wide tier on the same
draws, in the three modes, one tiled launch each, at the served rows, at
(n), (p), (r)'s 16,384 and at the conditional's 4,096 (NCSF also at the
16,384 rows placed at the jumps), samples bit for bit and sums within
1e-4; the NCSF's, BPF's and SOSPF's density and apply (the tiled tier:
NCSF tiles of 128 rows, BPF and SOSPF 64; SOSPF's softclips taken by the
rows' owner threads), flagship and conditional, at 1M rows, 65,536 - 37
and 16 tiles + 1, against plain float64 and against the wide tier on the
same rows, one launch each (NCSF's each tier continued on its own side
of the jumps, also at the 16,384 rows placed at them, the tiers held
against each other on the rows neither continued); K1's Function at the
rows (m), (o), (q) train on and the IFT at (n), (p), (r)'s draws against
float64 (BPF's at four draw sets, each beside the backward with every
ReLU side from the float32 march, whose worst set is taken apart: the
parameter, the row, its slopes and kink margins, the cancellation ratio);
then **(m)**, **(o)**, **(q)** MLE at 65,536 rows a step on the NSF
serving phase's samples (NCSF's wrapped into ``[-pi, pi)``) and **(n)**,
**(p)**, **(r)** reverse KL through the IFT at 16,384 draws a step on the
ring energy. Phase 12 serves one wide configuration of each mode.

Then it times each kernel, its plain version (float32, on the card), its
bound and, for ``masked_linear``, the one PyTorch call that computes the
same function, with their ratio (the per-op kernels as 20 calls queued a
run, a call alone beside; the GF kernels also with per-row parameters at 1M
rows); one
training step of each of (a)-(l) and a served request on the host clock; and
prints the card's name and power limit, one JSON line ``{"kernels": [...]}``
(every kernel, mode and tier) and, last, ``{"ok": true, "device": {...}}``.
Any failed check raises, so the script exits non-zero and prints no result;
it also fails without a CUDA device and outside a checkout of the repository.
"""

import contextlib
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
# is still rising over the first few launches after host work: more runs,
# each of PER_OP_REPS calls queued back to back (one call alone waits on
# the host's launch latency, 20-40 us); a call alone is timed beside them
PER_OP_RUNS = 21
PER_OP_REPS = 20
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
# The Gaussianization flow. A layer's output is y = sqrt(2) erfinv(m) with
# |m| <= 1 - 1e-6; rounding m by one float32 ulp (6e-8) moves y by 6e-8 *
# sqrt(pi / 2) * exp(y^2 / 2) and the y^2 / 2 of the log-Jacobian by |y|
# times that: 4e-5 at |y| = 3.5 and 0.06 at the largest |y| = 4.89. So a
# density is held to the median and max below over the rows where no layer's
# |y| passes GF_SATURATED, and to TOL_GF_SATURATED over the others, which
# are printed with their |y|.
GF_SATURATED = 3.5
TOL_GF_MEDIAN, TOL_GF_MAX, TOL_GF_SATURATED = 1e-5, 5e-4, 0.1
# Samples: a quantile contract, because tail targets peg at the bracket and
# a plateau of the erf mixture leaves the root ill-conditioned (both by
# design). Log q is held where the solve came back to its target (T(x) = z
# to GF_SOLVED in float64) and no layer saturates; against the density
# kernel at the returned points it is held to TOL_GF_SELF.
GF_SOLVED = 1e-4
TOL_GF_SAMPLE_Q95, TOL_GF_SELF = 1e-2, 1e-4
# T(x) against z over the rows that plain float64 solves: the median as the
# samples', and the 99th percentile, since float32 rounding of x times a
# layer's slope reaches 1e-2 at single rows of a million.
TOL_GF_BACK_Q99 = 1e-3
# A GF's parameter gradients: the one to a rotation's A is what is left of
# dL/dR after A - A^T and matrix_exp cancel most of it (a hundredth of it for
# the conditional GF at 262,144 rows; both are printed), and the one to a
# hyper-network's first layer is a sum over zero-mean contexts. Float32 sums
# that are right to 1e-6 of their terms leave about 1e-4 of such remainders.
TOL_GF_GRAD_PARAMS = 5e-4
# The NAF. A log-density sums 2 F log-Jacobian terms per layer pair and the
# base term, each right to a few float32 ulps of the monotone network's output
# and slope, which are themselves sums of 64 products: about 2e-6 at the
# median and 2e-5 at the worst row of a million for the flagship on an H100
# (seeded weights). So median 1e-5 and max 1e-3; a flow of F features has
# F / 6 times the flagship's terms, and its limits are F / 6 times these.
TOL_NAF_MEDIAN, TOL_NAF_MAX = 1e-5, 1e-3
# Samples: three Newton steps from a bracket of 2e-2 land on the root to the
# float32 resolution of f divided by f', which is small on the flat stretches
# of a monotone network: 1e-7 at the median, 1e-5 at the worst of 65,536 rows
# on an H100. A target beyond the network's range pegs at the bracket
# in float32 and float64 alike. So: median TOL_SAMPLE_MEDIAN and the 99th
# percentile 1e-3, the maximum printed.
TOL_NAF_SAMPLE_Q99 = 1e-3
# log q against K8 at the returned points: the same functions at the same x,
# one through the solver's sweeps; the median to 1e-4.
TOL_NAF_SELF = 1e-4
# The tiled density against the wide tier on the same inputs: the MNN mode
# sums in the same order, bit for bit; the UMNN mode's GL sum differs in
# nvcc's contractions, one float32 ulp of a log-density in [32, 64) (3.8e-6)
# at most on an H100. A row of a tile read or written wrongly is off by far
# more.
TOL_UMNN_TIERS = 8e-6
# K9 costs about 30 times K3 a row: sampling is served at 262,144 rows, the
# reverse-KL step (h) draws 65,536; the 32-feature flow (F^2 sweeps and
# solves a layer) is served at 65,536 rows (density) and 16,384 (samples).
NAF_SAMPLE_ROWS, NAF_IFT_ROWS, NAF_WIDE_ROWS = 1 << 18, 1 << 16, 1 << 16
# The UNAF's UMNN mode costs about 7 times K8's MNN mode a density row and 5
# times K9's a sample row: the density is served at 262,144 rows (and (i)
# trains on GRAD_ROWS); sampling is served at 65,536 rows and (j) draws 16,384.
UNAF_DENSITY_ROWS, UNAF_SAMPLE_ROWS, UNAF_IFT_ROWS = 1 << 18, 1 << 16, 1 << 14
# A NAF or UNAF past its tiled sampler's shared memory samples 1,024 rows
# through the wide tier (one thread a row, its state in device memory).
UNAF_WIDE_ROWS = 1 << 10
# The flows past the narrow tiers' limits are served at 65,536 rows (the
# widest at 16,384); a NAF of 72 features samples 256 rows (72 sweeps of 72
# solves a layer), one of a signal of 72 and networks of width 160 1,024.
REPAIR_ROWS = 1 << 16
NAF_RUNS = 3
# The CNF. Its ladj is integrated scaled by trace_scale = 1e-2, so the error
# control allows about atol / trace_scale = 1e-4 a step on the unscaled
# log-determinant; the error estimate is a difference of nearly equal slopes,
# so a float32 and a float64 run can take different steps in a tile, and then
# every row of that tile differs at that level: densities and log q median
# 1e-4, max 1e-3 (zuko_tpu's TPU kernel: max 2.1e-4 and median 4.0e-5 against
# the same kind of truth); samples, whose error control is 1e-6 + 1e-5 |x|,
# median 1e-5 and 99th percentile 1e-4; log q against K10 at the returned
# points median 1e-3 (tests/test_fused_dispatch.py:862). K10's gradient: both
# sides differentiate the global-step integration, float32 against float64
# decisions: parameters max-relative 1e-3, input normwise 1e-2.
TOL_CNF_MEDIAN, TOL_CNF_MAX, TOL_CNF_SAMPLE_Q99, TOL_CNF_SELF = 1e-4, 1e-3, 1e-4, 1e-3
TOL_CNF_GRAD_PARAMS, TOL_CNF_GRAD_INPUT = 1e-3, 1e-2
# K10 and K11 at the CNF batch of tools/bench_suite.py:214; (k) at 65,536
CNF_ROWS, CNF_SAMPLE_ROWS, CNF_TRAIN_ROWS = 1 << 18, 1 << 18, 1 << 16
CNF_NAMES = ("cnf_density", "cnf_sample", "cnf_sample_log_prob")
# K12 (the continuous adjoint): served with a gradient and trained by (l) at
# 16,384 rows a step; its wide tier at 1,024 rows (each tile of 256 rows is
# one block, and a wide tile takes seconds)
CNF_RKL_ROWS, K12_WIDE_ROWS = 1 << 14, 1 << 10
ADJ_NAMES = ("cnf_adjoint", "cnf_adjoint_log_prob")
# Phase 15 (NCSF, SOSPF, BPF). NCSF's inverse is closed-form: sampled at
# ROWS. The polynomials solve by bisection and Newton steps: sampled at
# 262,144 rows and held against plain float64 at 65,536 draws; (m), (o), (q)
# take 65,536 rows a step, (n), (p), (r) 16,384 draws. A polynomial solve
# that plain float64 brings back to its target within POLY_SOLVED counts as
# solved: the samples and their sums are held there, the others (targets
# past a polynomial's range, pegged at its bracket) are counted.
POLY_SAMPLE_ROWS, POLY_HOLD_ROWS, POLY_MLE_ROWS, POLY_RKL_ROWS = 1 << 18, 1 << 16, 1 << 16, 1 << 14
POLY_SOLVED, TOL_POLY_SAMPLE_Q99 = 1e-4, 1e-3
# A circular spline's shift, x -> (x mod 2 pi) - pi, jumps at x = 0 (mod 2
# pi), and the sampler's, which shifts the spline's root back, where the
# root is 0: where the solved x is pi or -pi. A value that float32 and
# float64 round to the two sides of a jump comes out 2 pi apart, the same
# angle, but the next layer's MADE then reads -pi where the other reads pi
# and conditions every later feature differently (on an H100, at 1M draws of
# the flagship: log q 0.17 off at one row, the apply's y 2 pi at another).
# So the float64 reference of a circular spline flow is continued on the
# side the kernel took: after each layer (each sweep of a solve), a float64
# value within CIRCLE_SIDE of +-pi whose kernel value lies within it on the
# other side moves by 2 pi, and every row is held.
CIRCLE_SIDE = 1e-3
NSF_KINDS = ("nsf_density", "nsf_apply", "nsf_sample", "nsf_sample_log_prob", "nsf_sample_raw")
GF_NAMES = ("gf_density", "gf_sample", "gf_sample_log_prob")
NAF_NAMES = ("naf_density", "naf_sample", "naf_sample_log_prob")
UMNN_NAMES = ("naf_density_umnn", "naf_sample_umnn", "naf_sample_umnn_log_prob")
CSRC = "zuko_tpu_torch/ops/csrc/"


def check(ok, message):
    if not ok:
        raise RuntimeError(f"chip_smoke: {message}")


def time_ms(fn, runs, reps=1):
    """Per-run device times (CUDA events, each run synchronised) after one
    warm-up run, and their median; with ``reps`` a run is that many calls
    queued back to back, and its time is over the count (a short kernel's
    own time, not the host's launch latency)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
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


def univ_ops(univ, K, bound, what="forward"):
    """Operations of one feature's univariate that the function needs, with
    a multiply-add as 2 and a transcendental as 1: ``what`` is
    ``"forward"`` (the value and its log-Jacobian), ``"cold"`` (a layer's
    first sweep: the solve from [-B, B]) or ``"warm"`` (a later sweep: two
    checks, then the short bisection). The affine map and the splines
    (:func:`spline_ops`, and 4 for the circular shift) invert in one
    evaluation. A polynomial is prepared once a feature and sweep, then
    evaluated by Horner's rule, whatever the kernel does instead. The sum of
    squares of P polynomials of L + 1 coefficients is one polynomial of
    degree 2 L: the squares' (L + 1)(L + 2) / 2 distinct products a
    multiply-add each, P additions of the 1, and its 2 L + 1 coefficients
    and its integral's scaled once (4 L + 2); a value is x / B, Horner's 2 L
    multiply-adds and a multiply for the integral, and the shift (4 L + 3);
    the derivative the integrand by Horner (4 L). A Bernstein polynomial of
    n + 1 = M + 5 coefficients: its coefficients 6 M + 20 (softmax, cumsum,
    the pinned ends), scaled by the binomials (n + 1) and differenced for
    the derivative (2 n); a value is u (2), the ends' tests (6), the ratio
    u / (1 - u) or its inverse (3), Horner's n multiply-adds, the power (1
    - u)^n or u^n (3) and the product (1); the derivative the same with n -
    1 and the power divided once. A bisection step is an evaluation of the
    value and 4 (midpoint, compare, select); a Newton step the value, the
    derivative and 6; a solve ends with 4 Newton steps (a Bernstein
    polynomial's also with its two ends, 6 each). The bisections:
    ceil(log2(2B / 1e-3)) cold, 7 warm, as the kernels take them."""
    if univ in ("affine", "rqs", "crqs"):
        return spline_ops(univ, K) + (4 if univ == "crqs" else 0)
    cold, warm = math.ceil(math.log2(2 * bound / 1e-3)), 7
    if univ == "sosp":
        P, L = K[0], K[1] - 1
        prep = P * ((L + 1) * (L + 2) + 1) + 4 * L + 2
        value, deriv, ends = 4 * L + 3, 4 * L, 0
    else:
        n = K + 4
        prep = 6 * K + 20 + (n + 1) + 2 * n
        value, deriv, ends = 2 * n + 15, 2 * (n - 1) + 4, 2 * 6
    newton = value + deriv + 6
    if what == "forward":
        return prep + value + deriv + 1
    if what == "cold":
        return prep + cold * (value + 4) + 4 * newton + ends
    return prep + 2 * value + 6 + warm * (value + 4) + 4 * newton + ends


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


def gf_ops(layout, F, mode):
    """Operations of one row through the GF kernels, counted from
    ``csrc/gf_fused.cu`` with a transcendental as one operation, as
    :func:`spline_ops` counts them. Forward, per mixture component 14 (the
    affine argument 2, ``erff`` of it 2, its sum 1, the streamed
    log-sum-exp 9) and per feature 10 (shrink, ``erfinvf``, ``y^2 / 2``, the
    two logs, the sums); a bisection step 5 per component (argument,
    ``erff``, sum) and 4 per feature (midpoint, compare, select), 29 steps
    and 4 for the target and the last midpoint; a rotation 2 F^2; the base
    term 2 F + 2; a layer with per-row parameters one ``expf`` per
    log-scale. ``mode``: ``"density"``, ``"sample"`` or
    ``"sample_log_prob"``."""
    forward = sum(F * (14 * e[1] + 10) for e in layout if e[0] != "rot") + 2 * F + 2
    solve = sum(F * (29 * (5 * e[1] + 4) + 4) for e in layout if e[0] != "rot")
    shared = sum(2 * F * F for e in layout if e[0] == "rot") \
        + sum(F * e[1] for e in layout if e[0] == "gaussb")
    return shared + {"density": forward, "sample": solve, "sample_log_prob": solve + forward}[mode]


def naf_ops(params, layout, F, S, mode):
    """Operations of one row through the NAF kernels, counted from
    ``csrc/naf_fused.cu`` with a multiply-add as 2 and a transcendental as 1:
    the MADE's hidden layers and a feature's T outputs from their masked
    weights (2 per kept entry, a bias and a ReLU per hidden unit, a bias per
    output); a hoist 2 S + 1 per first-layer unit; a network evaluation 4 per
    first-layer unit (the x column's multiply-add, the activation's compare
    and exp), per further unit 2 per input and 3, and 2 per input of the
    output. A monotone network's derivative gives every weight a second
    multiply-add and every unit one more multiply. A UMNN integrand adds 5
    for g = exp(d / (1 + |d / 7|)), and a GL-N integral takes N of them and
    3 a node (the node's x, the weighted sum); its derivative is one more
    integrand. A bisection step 4 (midpoint, compare, select), a Newton step
    6; a softclip 4 a feature (6 in the sampler with log q); the base term 2 F
    + 2; a log-Jacobian 1. ``mode``: ``"density"``, ``"sample"`` or
    ``"sample_log_prob"``."""
    from zuko_tpu_torch.ops import naf_fused

    total = 0 if mode == "sample" else 2 * F + 2
    for entry, made, mono_w, _ in naf_fused._stages(params, layout):
        if entry[0] == "softclip":
            total += {"density": 4, "sample": 4, "sample_log_prob": 6}[mode] * F
            continue
        made_pass = sum(2 * int((W != 0).sum()) + 2 * W.shape[0] for W in made[0:-2:2]) \
            + 2 * int((made[-2] != 0).sum()) + made[-1].numel()
        H1 = mono_w[0].shape[1]
        hoist = H1 * (2 * S + 1)
        middle = [(W.shape[1], W.shape[2]) for W in mono_w[1:-1]]
        din_out = mono_w[-1].shape[2]
        plain = 4 * H1 + sum(o * (2 * i + 3) for o, i in middle) + 2 * din_out + 1
        sweeps = min(entry[3], F)
        if entry[4] == "umnn":
            g = plain + 5

            def integral(n):
                return n * (g + 3) + 2

            def vg(n):
                return integral(n) + g

            forward = made_pass + F * (hoist + vg(16) + 2)
            cold = 10 * (integral(4) + 4) + 3 * (vg(8) + 6) + vg(16) + 6
            warm = 5 * (integral(4) + 4) + 2 * (vg(8) + 6) + vg(16) + 6
            solves = F * (cold + (sweeps - 1) * warm)
            log_q = made_pass + F * (hoist + g + 1)
        else:
            vg = 5 * H1 + sum(o * (4 * i + 4) for o, i in middle) + 4 * din_out + 1
            forward = made_pass + F * (hoist + vg + 1)
            evals = 10 + 5 * (sweeps - 1)  # bisection steps and warm checks
            solves = F * (evals * (plain + 4) + 3 * sweeps * (vg + 6))
            log_q = forward
        if mode == "density":
            total += forward
            continue
        total += sweeps * (made_pass + F * hoist) + solves
        if mode == "sample_log_prob":
            total += log_q
    return total


def cnf_ops(widths, nf, trace):
    """Operations of one row's attempt through the CNF kernels, counted from
    ``csrc/cnf_fused.cu`` with a multiply-add as 2 and a transcendental as 1,
    for the network ``widths = [F, H1, ..., F]``: 7 evaluations, each a
    multiply-add per weight, an add per bias and 3 per hidden unit (ELU and
    its derivative); with the exact trace (``trace`` True) F tangent columns
    (a multiply per first-layer unit, the middle layers' products and
    derivative multiplies, one row of the last layer), with Hutchinson's
    (False) one (the first layer's product with the probe, the middle
    layers', the last layer's and the dot with the probe), without one
    (None) none; and 78 per element of the state (x, and the ladj with a
    trace) for the stage inputs, the two solutions, the error and its ratio.
    The time-embedding term is the tile's, once per stage, and left out."""
    F, hidden = widths[0], widths[1:-1]
    pairs = list(zip(widths[:-1], widths[1:]))
    network = sum(o * (2 * i + 1) for i, o in pairs) + 3 * sum(hidden)
    middle = sum(o * (2 * i + 1) for i, o in pairs[1:-1])
    if trace is None:
        tangent = 0
    elif not hidden:
        tangent = F if trace else F * (2 * F + 2)
    elif trace:
        tangent = F * (hidden[0] + middle + 2 * pairs[-1][0] + 1)
    else:
        tangent = hidden[0] * (2 * F + 1) + middle + F * (2 * pairs[-1][0] + 2)
    return 7 * (network + tangent) + 78 * (F + (trace is not None))


def cnf_adjoint_ops(widths, trace):
    """Operations of one row's attempt through the adjoint kernel, counted
    from ``csrc/cnf_fused.cu`` as :func:`cnf_ops` counts them, for the network
    ``widths = [F, H1, ..., F]``: 7 stages, each the network's values, per
    tangent column (F with the exact trace, 1 with Hutchinson's, none
    without a trace) its products through the hidden layers (the first
    layer's product with the probe for Hutchinson's) and its pullback (a
    transposed product and 4 per hidden unit), the primal pullback (a
    transposed product and 2 per unit, the first layer's for the input's
    cotangent) and 10 per element of ``(u, a)`` for the stage inputs; 6 of
    the 7 stages also reduce the outer products over the rows (a
    multiply-add per weight and pair, an add per weight of the exact trace's
    first-layer pairs, an add per bias), and each attempt takes 40 per
    element of ``(u, a)`` for the solutions, the errors and their ratio.
    The exact trace's column j enters the last linear with the cotangent
    ``-Lbar e_j``, so only row j of that linear is needed: a multiply per
    input in its pullback, a multiply-add per input in its outer product
    (with no hidden layer, one add). The kernel computes the whole rows;
    what the function needs is counted. The tile's time-embedding and
    accumulator updates are left out."""
    F, hidden = widths[0], widths[1:-1]
    pairs = list(zip(widths[:-1], widths[1:]))
    network = sum(o * (2 * i + 1) for i, o in pairs) + 3 * sum(hidden)
    columns = {None: 0, True: F, False: 1}[trace]
    middle = sum(o * (2 * i + 1) for i, o in pairs[1:-1])
    forward = (0 if trace else 2 * F * widths[1]) + middle if hidden else 0
    pullback = sum(2 * i * o + 4 * i for i, o in pairs[1:])
    primal = sum(2 * i * o + 2 * i for i, o in pairs[1:]) + 2 * F * widths[1]
    weights = sum(i * o for i, o in pairs)
    reduce = 2 * weights + sum(o for _, o in pairs)
    if trace and hidden:
        last = pairs[-1][0]
        pullback -= 2 * last * F - last
        reduce += F * (widths[1] + 2 * (weights - F * widths[1] - last * F) + 2 * last)
    elif trace:
        reduce += F
    elif trace is False:
        reduce += 2 * weights
    stage = network + columns * (forward + pullback) + primal + 20 * F
    return 7 * stage + 6 * reduce + 80 * F


def quantiles(diff):
    """median, 95th and 99th percentile and max of a tensor of errors."""
    flat = diff.flatten().float()
    q = torch.quantile(flat[:: max(1, flat.numel() // (1 << 22))],
                       torch.tensor([0.5, 0.95, 0.99], device=flat.device))
    return (*q.tolist(), flat.max().item())


def bound(ops, nbytes):
    t_ops, t_bytes = ops / FP32_PEAK, nbytes / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def compare_grads(label, got, want, n_inputs=1, tol_input=TOL_GRAD_INPUT, hold=True,
                  tol_params=TOL_GRAD_PARAMS):
    """Hold float32 gradients ``got`` against float64 ``want``: the first
    ``n_inputs`` entries are inputs (normwise), the rest parameters
    (max-relative). Without ``hold`` the figures are printed only."""
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
    if hold:
        check(params_max <= tol_params, f"{label} gradient (parameters)")
        check(input_norm <= tol_input, f"{label} gradient (inputs)")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import zuko_tpu_torch as zt

    from zuko_tpu_torch import ops
    from zuko_tpu_torch.lazy import Flow
    from zuko_tpu_torch.ops import (
        _build, _common, cnf_fused, gf_fused, ift, masked_linear, naf_fused, nsf_fused, rqs,
    )
    from zuko_tpu_torch.ops._common import NSF_MODES, WHOLE_FLOW
    from zuko_tpu_torch.ops.dispatch import (
        FusedAutoregressiveFlow,
        FusedContinuousFlow,
        FusedDensityFlow,
        FusedGaussianizationFlow,
        FusedInvertedAutoregressiveFlow,
        FusedNeuralSamplingFlow,
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
    check(set(reports) == {"nsf_fused", "gf_fused", "naf_fused", "cnf_fused", "masked_linear",
                           "rqs"},
          f"built {sorted(reports)}")
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
    gen_tiers = torch.Generator(device=dev).manual_seed(11)
    # the checks added with the tiled density (phases 10-11) draw from a
    # generator of their own, so that every other check keeps its draws
    gen_density = torch.Generator(device=dev).manual_seed(12)
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

    def fresh():
        """The flow (a)-(d) train: the flagship's width from seeded weights."""
        torch.manual_seed(1)
        return zt.NSF(6, 0, transforms=3, device=dev)

    batches = xs.split(GRAD_ROWS)  # the samples the serving phase drew, what MLE trains on

    # 4-5. every whole-flow kernel (both univariate branches) against its
    # plain version, float64 on the card
    def plain_args(flow, dtype):
        """``(params, layout, statics)`` of an autoregressive flow as the
        wrappers take them, detached, in ``dtype``; the base is the last of
        the statics."""
        params, layout, cfg = nsf_fused._flatten_flow(flow)
        params = [p.detach().to(dtype) for p in params]
        F = params[-3].shape[0] // nsf_fused._univ_size(cfg["univ"], cfg["bins"])
        return params, layout, nsf_fused._statics(cfg, F)

    def nsf_plan(params, layout, st, rows, sample=True):
        """K3's plan (``plan_nsf(..., sample=True)``), or without ``sample``
        K1 and K2's, of an autoregressive flow's ``plain_args`` at ``rows``
        rows, with this card's shared memory."""
        F, K, univ = st[0], st[1], st[4]
        _, widths, passes = nsf_fused._pack_weights(params, layout, F, params[0].shape[1] - F, K,
                                                    univ)
        return nsf_fused.plan_nsf(widths, K, univ, len(passes), rows,
                                  _build.load_library("nsf_fused").nsf_max_shared_bytes(
                                      dev.index or 0), sample=sample)

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

    def hold_density_grads(label, params, p64, layout, st, xg):
        """K1's Function at the rows ``xg``: its forward (the kernel) against
        plain float64, its gradient (float32 plain backward) against float64
        plain autograd. A loss of means, as training has: cotangents of
        random sign would make each parameter's gradient a cancelling sum,
        which the few rows near the spline's slope floor then dominate."""
        density, values = [], []
        for fn, ps0, dtype in ((nsf_fused.nsf_density, params, torch.float32),
                               (nsf_fused._full_math, p64, torch.float64)):
            ps, xr = leaves(ps0), xg.to(dtype, copy=True).requires_grad_(True)
            lp = fn(xr, ps, layout, *st)
            lp.mean().backward()
            density.append([xr.grad] + grads_of(ps))
            values.append([lp.detach()])
        hold_values(f"{label} density", "nsf_density", values, [TOL_DENSITY])
        compare_grads(f"{label} density", *density)

    def base_draws(rows, F, base, generator=gen):
        """``rows`` draws of the base: standard normal, or uniform on a box."""
        if base[0] == "box":
            return base[1] + (base[2] - base[1]) * torch.rand(rows, F, generator=generator,
                                                                device=dev)
        return torch.randn(rows, F, generator=generator, device=dev)

    def on_circle(diff):
        return torch.remainder(diff + math.pi, 2 * math.pi) - math.pi

    def circle_plain(kind, xc, params, p64, layout, st):
        """Plain float64 of a circular spline flow's kernel at the rows
        ``xc``, continued on the side of the shifts' jumps the kernel took
        (CIRCLE_SIDE): ``kind`` is "apply" (K1 and K2) or K3's
        ``want_log_prob``. The kernel's values after a layer are its output
        on the flow's first layers (forward) or its last (inverse). Returns
        ``(y or x, bare sum of forward ladjs, rows moved)``."""
        F, n = st[0], len(layout)
        check(all(e[0] != "softclip" for e in layout), "a circular spline flow has no softclip")
        layers32, layers64 = (nsf_fused._split_layers(p, layout) for p in (params, p64))
        forward = kind == "apply"

        def kernel_after(l):
            chosen = range(l + 1) if forward else range(l, n)
            ps, lay = [p for j in chosen for p in layers32[j][0]], [layout[j] for j in chosen]
            if forward:
                return nsf_fused.nsf_apply(xc, ps, lay, *st)[0].double()
            out = nsf_fused.nsf_sample(xc, ps, lay, *st, kind)
            return (out[0] if kind else out).double()

        def side(v, k):
            near = (v.abs() > math.pi - CIRCLE_SIDE) & (k.abs() > math.pi - CIRCLE_SIDE)
            flip = near & ((v > 0) != (k > 0))
            return torch.where(flip, v + 2 * math.pi * torch.sign(k), v), flip.any(dim=1)

        x, c = xc[:, :F].double(), xc[:, F:].double()
        acc = torch.zeros_like(x[:, 0])
        moved = torch.zeros_like(acc, dtype=torch.bool)
        for l in range(n) if forward else reversed(range(n)):
            ps, passes = layers64[l]
            k = kernel_after(l)

            def hyper(v):
                return nsf_fused._hyper(torch.cat([v, c], dim=1), ps)

            if forward:
                y, ladj = nsf_fused._univ_forward(x, hyper(x), *st[:5])
                x, flip = side(y, k)
            else:
                y = x
                x = torch.zeros_like(y)
                for _ in range(min(passes, F)):
                    x, flip = side(nsf_fused._univ_inverse(y, hyper(x), *st[:5]), k)
                _, ladj = nsf_fused._univ_forward(x, hyper(x), *st[:5])
            moved |= flip
            acc = acc + ladj.sum(dim=1)
        return x, acc, moved

    def plain_samples(zc, params, p64, layout, st):
        """Plain float64 of K3 at the draws ``zc``, by mode (``want_log_prob``
        False, True, "raw"): ``(x, bare sum of forward ladjs, held, moved)``.
        ``held`` are the draws it is held on: for a polynomial those that
        plain float64 brings back to the draw within POLY_SOLVED, else all;
        ``moved``, a circular spline's rows continued on the kernel's side."""
        F = st[0]
        if st[4] == "crqs":
            out = {}
            for mode in (False, True, "raw"):
                x, acc, moved = circle_plain(mode, zc, params, p64, layout, st)
                out[mode] = (x, acc, torch.ones_like(moved), moved)
            return out
        zc64 = zc.double()
        x, acc = nsf_fused._sample_math(zc64, p64, layout, *st, "raw")
        held = torch.ones_like(acc, dtype=torch.bool)
        if st[4] in ("sosp", "bernstein"):
            back, _ = nsf_fused._full_math(torch.cat([x, zc64[:, F:]], dim=1), p64, layout, *st,
                                           raw=True)
            held = (back - zc64[:, :F]).abs().amax(dim=1) < POLY_SOLVED
        return dict.fromkeys((False, True, "raw"), (x, acc, held, torch.zeros_like(held)))

    def jump_rows(flow, rows):
        """``(xc, zc)`` at a circular spline flow's jumps, from a generator of
        their own: float32 rows whose first layer takes one feature each to
        within 1e-9 of 0 (where the next layer's shift jumps), and the
        float64 images, rounded to float32, of samples with one feature each
        within 1e-8 of +-pi (where the sampler's shift jumps)."""
        p64, layout, st = plain_args(flow, torch.float64)
        F, g = st[0], torch.Generator(device=dev).manual_seed(15)
        at = torch.arange(rows, device=dev)
        f = torch.randint(0, F, (rows,), generator=g, device=dev)
        sign = torch.randint(0, 2, (rows,), generator=g, device=dev).double() * 2 - 1

        def uniform():
            u = torch.rand(rows, F, generator=g, device=dev, dtype=torch.float64)
            return (2 * u - 1) * math.pi

        x, y0 = uniform(), uniform()
        x[at, f], y0[at, f] = sign * (math.pi - 1e-8), sign * 1e-9
        first = nsf_fused._split_layers(p64, layout)[0][0]
        with torch.no_grad():
            xc = nsf_fused._sample_math(y0, first, layout[:1], *st)
            zc = nsf_fused._full_math(x, p64, layout, *st, raw=True)[0]
        return xc.float(), zc.float()

    def hold_nsf(label, flow, xc, zc, suffix=""):
        """K1, K2 and K3 (all three outputs) of an autoregressive flow at the
        rows ``xc`` and the draws ``zc`` (each beside its context) against
        their plain versions in float64, errors noted under the names of the
        flow's mode (and ``suffix``): densities, the apply's values and sums,
        log q and the raw sums max <= TOL_DENSITY; samples median <=
        TOL_SAMPLE_MEDIAN, and max <= TOL_SAMPLE_MAX for a closed-form
        inverse, 99th percentile <= TOL_POLY_SAMPLE_Q99 for a polynomial's
        solve or a circular spline's, the polynomials' over the draws plain
        float64 solves (the others are counted, and their sums not held), a
        circular spline's angles on the circle and every row against float64
        continued on the kernel's side (:func:`circle_plain`). Returns the
        mask of the draws held."""
        params, layout, st = plain_args(flow, torch.float32)
        p64, _, _ = plain_args(flow, torch.float64)
        F, univ, base = st[0], st[4], st[5]
        name = {k: nsf_fused._counter(k, univ) + suffix for k in NSF_KINDS}
        poly, circle = univ in ("sosp", "bernstein"), univ == "crqs"
        with torch.no_grad():
            k_lp = nsf_fused.nsf_density(xc, params, layout, *st)
            k_y, k_sl = nsf_fused.nsf_apply(xc, params, layout, *st)
            k_x = nsf_fused.nsf_sample(zc, params, layout, *st)
            k_xl, k_lq = nsf_fused.nsf_sample(zc, params, layout, *st, True)
            k_u, k_rl = nsf_fused.nsf_sample(zc, params, layout, *st, "raw")
            if circle:
                r_y, r_sl, moved_y = circle_plain("apply", xc, params, p64, layout, st)
                r_lp = r_sl + nsf_fused._base_log_prob(r_y, base)
            else:
                r_lp = nsf_fused._full_math(xc.double(), p64, layout, *st)
                r_y, r_sl = nsf_fused._full_math(xc.double(), p64, layout, *st, raw=True)
            ref = plain_samples(zc, params, p64, layout, st)
        z_lp = nsf_fused._base_log_prob(zc[:, :F].double(), base)
        solved = ref[True][2]
        check(solved.float().mean().item() > 0.5, f"{label}: plain float64 solves too few draws")

        def sample_diff(a, mode):
            diff = a.double() - ref[mode][0]
            return on_circle(diff).abs() if circle else diff.abs()[solved]

        dx, dxl, du = (sample_diff(a, m) for a, m in ((k_x, False), (k_xl, True), (k_u, "raw")))
        d = (k_lp.double() - r_lp).abs()
        dyv = k_y.double() - r_y
        dy = torch.maximum((on_circle(dyv) if circle else dyv).abs().amax(dim=1),
                           (k_sl.double() - r_sl).abs())
        dlq = (k_lq.double() - (ref[True][1] + z_lp)).abs()[solved]
        drl = (k_rl.double() - ref["raw"][1]).abs()[solved]
        if circle:
            moved_z = ref[False][3] | ref[True][3] | ref["raw"][3]
            print(f"{label}: rows continued on the kernel's side of the shift's jump, density"
                  f" and apply {int(moved_y.sum().item())} of {xc.shape[0]}, draws"
                  f" {int(moved_z.sum().item())} of {zc.shape[0]}")
        print(f"{label} at {xc.shape[0]} / {zc.shape[0]} rows vs plain f64: density max"
              f" {d.max().item():.3e}, apply max {dy.max().item():.3e}; draws not held:"
              f" {int((~solved).sum().item())}; x median %.3e q95 %.3e q99 %.3e max"
              " %.3e" % quantiles(dx) + f", log q max {dlq.max().item():.3e}, raw x max"
              f" {du.max().item():.3e} sum ladj max {drl.max().item():.3e}")
        check(d.max().item() <= TOL_DENSITY and dy.max().item() <= TOL_DENSITY,
              f"{label} density or apply vs plain")
        for diff in (dx, dxl, du):
            med, _, q99, worst = quantiles(diff)
            check(med <= TOL_SAMPLE_MEDIAN, f"{label} samples vs plain (median)")
            check(q99 <= TOL_POLY_SAMPLE_Q99 if poly or circle else worst <= TOL_SAMPLE_MAX,
                  f"{label} samples vs plain (tail)")
        check(dlq.max().item() <= TOL_DENSITY and drl.max().item() <= TOL_DENSITY,
              f"{label} log q or raw sum vs plain")
        for kind, diff, rows in (("nsf_density", d, xc.shape[0]), ("nsf_apply", dy, xc.shape[0]),
                                 ("nsf_sample", dx, zc.shape[0]),
                                 ("nsf_sample_log_prob", dlq, zc.shape[0]),
                                 ("nsf_sample_raw", drl, zc.shape[0])):
            note_error(name[kind], diff, rows)
        return solved

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
        hold_density_grads(label, params, p64, layout, st, xg)
        if label == "flagship":
            # what step (a) feeds the Function: its parameters and its rows
            ps_a, _, _ = plain_args(fresh(), torch.float32)
            hold_density_grads("flagship, (a)'s parameters at (a)'s rows", ps_a,
                               [p.double() for p in ps_a], layout, st, batches[0])
        # a loss of means, as training has (see hold_density_grads)
        weights = torch.arange(1, F + 1, device=dev) / F
        applied, values = [], []
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

    # K3's tiled tier (the closed-form sampler's narrow tier since it was
    # redesigned): planned for the three flows; at 1M rows, 262,144 - 37 and
    # a last tile of one valid row, each mode against plain float64 and
    # against the wide tier on the same draws (which sum in the same order:
    # the difference is printed, with whether it is bit for bit), one
    # tiled launch each; draws from a generator of their own
    @contextlib.contextmanager
    def nsf_wide_tier():
        """The NSF kernels' wide tier: the planner told that no shared
        memory is there."""
        plan = nsf_fused.plan_nsf
        nsf_fused.plan_nsf = lambda *a, sample=False: plan(*a[:5], 0, sample=sample)
        try:
            yield
        finally:
            nsf_fused.plan_nsf = plan

    gen_k3 = torch.Generator(device=dev).manual_seed(13)
    t_k3 = time.perf_counter()
    for label, flow in (("flagship", flagship), ("conditional", conditional), ("maf", maf)):
        params, layout, st = plain_args(flow, torch.float32)
        p64, _, _ = plain_args(flow, torch.float64)
        F, C = st[0], params[0].shape[1] - st[0]
        _, widths, passes = nsf_fused._pack_weights(params, layout, F, C, st[1], st[4])
        plan = nsf_fused.plan_nsf(widths, st[1], st[4], len(passes), ROWS,
                                  _build.load_library("nsf_fused").nsf_max_shared_bytes(
                                      dev.index or 0), sample=True)
        print(f"{label} sampler plan: {plan}")
        check(not plan.wide and plan.tile_rows == 128, f"{label}: the tiled sampler at 128 rows")
        for rows in (ROWS, GRAD_ROWS - 37, 16 * plan.tile_rows + 1):
            zc = torch.randn(rows, F + C, generator=gen_k3, device=dev)
            with torch.no_grad():
                r_x, r_lq = nsf_fused._sample_math(zc.double(), p64, layout, *st,
                                                   want_log_prob=True)
            z64 = zc[:, :F].double()
            r_rl = r_lq + 0.5 * (z64**2).sum(dim=1) + 0.5 * F * math.log(2 * math.pi)
            for mode, name in ((False, "nsf_sample"), (True, "nsf_sample_log_prob"),
                               ("raw", "nsf_sample_raw")):
                ops.reset_launches()
                with torch.no_grad():
                    tiled = nsf_fused.nsf_sample(zc, params, layout, *st, want_log_prob=mode)
                    launched = {k: v for k, v in ops.LAUNCHES.items() if v}
                    with nsf_wide_tier():
                        wide = nsf_fused.nsf_sample(zc, params, layout, *st, want_log_prob=mode)
                check(launched == {name: 1}, f"{label} {name}: one tiled launch, {launched}")
                tiled = tiled if isinstance(tiled, tuple) else (tiled,)
                wide = wide if isinstance(wide, tuple) else (wide,)
                refs = (r_x, None if mode is False else r_lq if mode is True else r_rl)
                same = all(torch.equal(a, b) for a, b in zip(tiled, wide))
                dx = (tiled[0].double() - r_x).abs()
                dw = (tiled[0] - wide[0]).abs()
                line = (f"{label} {name} tiled at {rows} rows: x vs plain f64 max"
                        f" {dx.max().item():.3e} median {dx.median().item():.3e}, vs wide tier"
                        f" max {dw.max().item():.3e}")
                check_samples(f"{label} {name} tiled at {rows} rows vs plain", dx)
                check_samples(f"{label} {name} tiled at {rows} rows vs the wide tier", dw)
                if mode is not False:
                    dl = (tiled[1].double() - refs[1]).abs()
                    dlw = (tiled[1] - wide[1]).abs()
                    line += (f"; sum vs plain f64 max {dl.max().item():.3e}, vs wide tier max"
                             f" {dlw.max().item():.3e}")
                    check(dl.max().item() <= TOL_DENSITY and dlw.max().item() <= TOL_DENSITY,
                          f"{label} {name} tiled at {rows} rows: log q or raw sum")
                    note_error(name, dl, rows)
                else:
                    note_error(name, dx, rows)
                print(line + f"; bit for bit the wide tier's: {same}")
    print(f"K3 tiled tier checks: {time.perf_counter() - t_k3:.1f} s")

    # K1 and K2's tiled tier (the closed-form density's and apply's narrow
    # tier since it was redesigned), as K3's above: planned for the three
    # flows; at 1M rows, 262,144 - 37 and a last tile of one valid row, the
    # density, the apply's y and its sum against plain float64 and against
    # the wide tier on the same rows (the difference printed, with whether
    # it is bit for bit), one tiled launch each; rows from a generator of
    # their own
    gen_k12 = torch.Generator(device=dev).manual_seed(16)
    t_k12 = time.perf_counter()
    for label, flow in (("flagship", flagship), ("conditional", conditional), ("maf", maf)):
        params, layout, st = plain_args(flow, torch.float32)
        p64, _, _ = plain_args(flow, torch.float64)
        F, C = st[0], params[0].shape[1] - st[0]
        _, widths, passes = nsf_fused._pack_weights(params, layout, F, C, st[1], st[4])
        plan = nsf_fused.plan_nsf(widths, st[1], st[4], len(passes), ROWS,
                                  _build.load_library("nsf_fused").nsf_max_shared_bytes(
                                      dev.index or 0))
        print(f"{label} density plan: {plan}")
        check(isinstance(plan, nsf_fused.TilePlan) and not plan.wide,
              f"{label}: the tiled density")
        for rows in (ROWS, GRAD_ROWS - 37, 16 * plan.tile_rows + 1):
            xc = torch.randn(rows, F + C, generator=gen_k12, device=dev)
            with torch.no_grad():
                r_lp = nsf_fused._full_math(xc.double(), p64, layout, *st)
                r_y, r_sl = nsf_fused._full_math(xc.double(), p64, layout, *st, raw=True)
            for fn, name, refs in ((nsf_fused.nsf_density, "nsf_density", (r_lp,)),
                                   (nsf_fused.nsf_apply, "nsf_apply", (r_y, r_sl))):
                ops.reset_launches()
                with torch.no_grad():
                    tiled = fn(xc, params, layout, *st)
                    launched = {k: v for k, v in ops.LAUNCHES.items() if v}
                    with nsf_wide_tier():
                        wide = fn(xc, params, layout, *st)
                check(launched == {name: 1}, f"{label} {name}: one tiled launch, {launched}")
                tiled = tiled if isinstance(tiled, tuple) else (tiled,)
                wide = wide if isinstance(wide, tuple) else (wide,)
                same = all(torch.equal(a, b) for a, b in zip(tiled, wide))
                diffs = [(a.double() - r).abs() for a, r in zip(tiled, refs)]
                wdiffs = [(a - b).abs() for a, b in zip(tiled, wide)]
                print(f"{label} {name} tiled at {rows} rows: vs plain f64 max"
                      f" {['%.3e' % d.max().item() for d in diffs]}, vs wide tier max"
                      f" {['%.3e' % d.max().item() for d in wdiffs]}; bit for bit the wide"
                      f" tier's: {same}")
                for d in diffs + wdiffs:
                    check(d.max().item() <= TOL_DENSITY,
                          f"{label} {name} tiled at {rows} rows vs plain and the wide tier")
                note_error(name, torch.stack([d.reshape(rows, -1).amax(dim=1) for d in diffs])
                           .amax(dim=0), rows)
    print(f"K1 and K2 tiled tier checks: {time.perf_counter() - t_k12:.1f} s")

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

    def misaligned(rows, in_f):
        """x of ``rows`` rows that starts one float past an aligned address."""
        return torch.randn(rows * in_f + 1, generator=gen, device=dev)[1:].view(rows, in_f)

    big_w = torch.randn(64, 2048, generator=gen, device=dev) / 32
    big_m = (torch.rand(64, 2048, generator=gen, device=dev) < 0.5).float()
    wide_w = torch.randn(300, 64, generator=gen, device=dev)
    wide_m = (torch.rand(300, 64, generator=gen, device=dev) < 0.5).float()
    with torch.no_grad():
        cases = [(ROWS, *case) for case in linear_inputs(ROWS)] + [
            # leading batch dimensions, nothing a multiple of a tile, no bias
            (ROWS, "ragged 7x14289x37->91",
             torch.randn(7, 14289, 37, generator=gen, device=dev), ragged_w, ragged_m, None),
        ] + [(GRAD_ROWS, *case) for case in linear_inputs(GRAD_ROWS)] + [
            # a row count that is no multiple of a tile, x one float past an
            # aligned address, weights past the block's planned shared memory
            (GRAD_ROWS - 37, "64->138 ragged", torch.randn(GRAD_ROWS - 37, 64, generator=gen,
                                                          device=dev), *layer_shapes[2][1:]),
            (GRAD_ROWS, "6->64 misaligned", misaligned(GRAD_ROWS, 6), *layer_shapes[0][1:]),
            (GRAD_ROWS, "64->138 misaligned", misaligned(GRAD_ROWS, 64), *layer_shapes[2][1:]),
            (4096, "2048->64 in chunks of inputs", misaligned(4096, 2048), big_w, big_m,
             layer_shapes[1][3]),
            (4096, "64->300 in chunks of outputs", torch.randn(4096, 64, generator=gen,
                                                                device=dev), wide_w, wide_m, None),
        ]
        for rows, name, x, W, M, b in cases:
            plan = masked_linear.plan_masked_linear(
                x.numel() // x.shape[-1], W.shape[1], W.shape[0], torch.cuda.get_device_properties(
                    dev).multi_processor_count)
            if "chunks" in name:
                check(not plan.resident, f"masked_linear {name}: the weights fit after all")
            name = f"{name} at {rows} rows ({plan})"
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
    # name -> (source, the pallas_call it replaces); a whole-flow kernel's
    # wide tier replaces the same pallas_call as its narrow one
    origin = {
        "nsf_density": (CSRC + "nsf_fused.cu", "zuko_tpu/ops/nsf_fused.py:1842"),
        "nsf_apply": (CSRC + "nsf_fused.cu", "zuko_tpu/ops/nsf_fused.py:2183"),
        "nsf_sample": (CSRC + "nsf_fused.cu", "zuko_tpu/ops/nsf_fused.py:1658"),
        "nsf_sample_log_prob": (CSRC + "nsf_fused.cu", "zuko_tpu/ops/nsf_fused.py:1658"),
        "nsf_sample_raw": (CSRC + "nsf_fused.cu", "zuko_tpu/ops/nsf_fused.py:1658"),
        "masked_linear": (CSRC + "masked_linear.cu", "zuko_tpu/ops/masked_linear.py:116"),
        "rqs_forward": (CSRC + "rqs.cu", "zuko_tpu/ops/rqs.py:106"),
        "rqs_inverse": (CSRC + "rqs.cu", "zuko_tpu/ops/rqs.py:106"),
        "gf_density": (CSRC + "gf_fused.cu", "zuko_tpu/ops/gf_fused.py:562"),
        "gf_sample": (CSRC + "gf_fused.cu", "zuko_tpu/ops/gf_fused.py:657"),
        "gf_sample_log_prob": (CSRC + "gf_fused.cu", "zuko_tpu/ops/gf_fused.py:657"),
        "naf_density": (CSRC + "naf_fused.cu", "zuko_tpu/ops/naf_fused.py:949"),
        "naf_sample": (CSRC + "naf_fused.cu", "zuko_tpu/ops/naf_fused.py:1128"),
        "naf_sample_log_prob": (CSRC + "naf_fused.cu", "zuko_tpu/ops/naf_fused.py:1128"),
        "naf_density_umnn": (CSRC + "naf_fused.cu", "zuko_tpu/ops/naf_fused.py:949"),
        "naf_sample_umnn": (CSRC + "naf_fused.cu", "zuko_tpu/ops/naf_fused.py:1128"),
        "naf_sample_umnn_log_prob": (CSRC + "naf_fused.cu", "zuko_tpu/ops/naf_fused.py:1128"),
        "cnf_density": (CSRC + "cnf_fused.cu", "zuko_tpu/ops/cnf_fused.py:863"),
        "cnf_sample": (CSRC + "cnf_fused.cu", "zuko_tpu/ops/cnf_fused.py:1312"),
        "cnf_sample_log_prob": (CSRC + "cnf_fused.cu", "zuko_tpu/ops/cnf_fused.py:1312"),
        "cnf_adjoint": (CSRC + "cnf_fused.cu", "zuko_tpu/ops/cnf_fused.py:1044"),
        "cnf_adjoint_log_prob": (CSRC + "cnf_fused.cu", "zuko_tpu/ops/cnf_fused.py:1044"),
    }
    for mode in NSF_MODES:
        origin.update({nsf_fused._counter(k, mode): origin[k] for k in NSF_KINDS})
    origin.update({f"{name}_wide": origin[name] for name in WHOLE_FLOW})
    # the per-thread narrow polynomial sampler (phase 12)
    origin.update({f"{nsf_fused._counter(k, mode)}_thread": origin[k]
                   for mode in ("sosp", "bernstein") for k in NSF_KINDS[2:]})
    # the per-row narrow GF sampler (phase 12)
    origin.update({f"{name}_thread": origin[name] for name in GF_NAMES[1:]})

    def flow_work(rows):
        """name -> (kernel, plain, operations, bytes) of the whole-flow
        kernels at ``rows`` rows of the flagship."""
        return nsf_work(fparams, flayout, fst, x_big[:rows],
                        torch.randn(rows, F, generator=gen, device=dev))

    def nsf_work(params, layout, st, x, z):
        """name -> (kernel, plain, operations, bytes) of the whole-flow NSF
        kernels at the rows ``x`` (with their context) and the draws ``z``
        (with the same context), under the names of the flow's mode. A
        softclip costs 4 a feature (6 in the sampler with a sum)."""
        F, K, bound, univ = st[0], st[1], st[2], st[4]
        rows = x.shape[0]
        z = torch.cat([z, x[:, F:]], dim=1)
        args = (params, layout, *st)
        weight_bytes = 4 * sum(p.numel() for i, p in enumerate(params) if i % 3 != 2)
        clips = 4 * F * sum(1 for e in layout if e[0] == "softclip")
        layers = [(hyper_ops(ps), min(p, F)) for ps, p in nsf_fused._split_layers(params, layout)]
        forward = F * univ_ops(univ, K, bound)
        density_ops = sum(h + forward for h, _ in layers) + clips
        solve = [(h, F * univ_ops(univ, K, bound, "cold"), F * univ_ops(univ, K, bound, "warm"))
                 for h, _ in layers]
        sample_ops = sum(sweeps * h + cold + (sweeps - 1) * warm
                         for (h, cold, warm), (_, sweeps) in zip(solve, layers)) + clips
        D0 = x.shape[1]
        name = {k: nsf_fused._counter(k, univ) for k in NSF_KINDS}
        return {
            name["nsf_density"]: (
                lambda: nsf_fused.nsf_density(x, *args),
                lambda: nsf_fused._full_math(x, *args),
                rows * density_ops, 4 * rows * (D0 + 1) + weight_bytes),
            name["nsf_apply"]: (
                lambda: nsf_fused.nsf_apply(x, *args),
                lambda: nsf_fused._full_math(x, *args, raw=True),
                rows * density_ops, 4 * rows * (D0 + F + 1) + weight_bytes),
            name["nsf_sample"]: (
                lambda: nsf_fused.nsf_sample(z, *args),
                lambda: nsf_fused._sample_math(z, *args),
                rows * sample_ops, 4 * rows * (D0 + F) + weight_bytes),
            name["nsf_sample_log_prob"]: (
                lambda: nsf_fused.nsf_sample(z, *args, True),
                lambda: nsf_fused._sample_math(z, *args, True),
                rows * (sample_ops + density_ops + clips // 2),
                4 * rows * (D0 + F + 1) + weight_bytes),
            name["nsf_sample_raw"]: (
                lambda: nsf_fused.nsf_sample(z, *args, "raw"),
                lambda: nsf_fused._sample_math(z, *args, "raw"),
                rows * (sample_ops + density_ops + clips // 2),
                4 * rows * (D0 + F + 1) + weight_bytes),
        }

    timed = {}  # (name, rows) -> dict of times
    # the rows at which the kernels line reports a kernel, where not the
    # serving phase's (ROWS) or the training steps' (GRAD_ROWS)
    report_rows = {"naf_sample": NAF_SAMPLE_ROWS, "naf_sample_log_prob": NAF_SAMPLE_ROWS}

    def time_kernel(name, rows, kernel, plain, n_ops, nbytes, library=None, note="", runs=5,
                    plain_runs=None, reps=1):
        """Time one kernel at one shape into ``timed[name, rows, note]``;
        with ``reps``, each run is that many calls queued (kernel, plain and
        library alike), and a call alone is timed beside (``single_ms``,
        ``library_single_ms``: the host's launch latency included)."""
        k_ms, k_runs = time_ms(kernel, runs, reps)
        p_ms, p_runs = time_ms(plain, plain_runs or max(3, runs // 2), reps)
        l_ms = None if library is None else time_ms(library, runs, reps)[0]
        b_ms, b_by = bound(n_ops, nbytes)
        timed[name, rows, note] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                                   "bound_by": b_by, "library_ms": l_ms}
        single = ""
        if reps > 1:
            timed[name, rows, note]["single_ms"] = time_ms(kernel, runs)[0]
            single = f" (a call alone {timed[name, rows, note]['single_ms']:.4f} ms"
            if library is not None:
                timed[name, rows, note]["library_single_ms"] = time_ms(library, runs)[0]
                single += f", the library's {timed[name, rows, note]['library_single_ms']:.4f} ms"
            single += ")"
        print(f"{' '.join(filter(None, [name, note]))} at {rows} rows: kernel {k_ms:.4f} ms {fmt(k_runs)},"
              f" plain {p_ms:.3f} ms {fmt(p_runs)},"
              + ("" if l_ms is None else f" library {l_ms:.4f} ms (kernel / library"
                 f" {k_ms / l_ms:.3f}),")
              + f" bound {b_ms:.4f} ms ({b_by}: {n_ops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB),"
              f" {rows / k_ms / 1e3:.2f} M rows/s" + single)

    with torch.no_grad():
        for rows in (ROWS, GRAD_ROWS):
            for name, work in flow_work(rows).items():
                time_kernel(name, rows, *work)
        # one hyper-net pass of the unfused step: the three layer shapes
        linear_total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
                        "single_ms": 0.0, "library_single_ms": 0.0}
        for name, x, W, M, b in linear_inputs(GRAD_ROWS):
            out_f, in_f = W.shape
            time_kernel(
                "masked_linear", GRAD_ROWS,
                lambda: masked_linear.masked_linear(x, W, M, b),
                lambda: masked_linear._masked_linear_math(x, W, M, b),
                GRAD_ROWS * (2 * int(M.sum().item()) + out_f),
                4 * (GRAD_ROWS * (in_f + out_f) + 2 * W.numel() + out_f),
                library=lambda: torch.nn.functional.linear(x, M * W, b), note=name,
                runs=PER_OP_RUNS, reps=PER_OP_REPS,
            )
            for key in linear_total:
                linear_total[key] += timed["masked_linear", GRAD_ROWS, name][key]
        # the bytes bound every shape, so the sum's bound is the bytes' too
        timed["masked_linear", GRAD_ROWS, ""] = {
            **linear_total, "bound_by": "bytes",
            "shapes": {name: timed["masked_linear", GRAD_ROWS, name] for name, *_ in layer_shapes}}
        check(all(timed["masked_linear", GRAD_ROWS, name]["bound_by"] == "bytes"
                  for name, *_ in layer_shapes), "masked_linear: a shape is bound by operations")
        print(f"masked_linear, the three shapes together: {linear_total}, kernel / library"
              f" {linear_total['ms'] / linear_total['library_ms']:.3f}")
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
                        note=f"({m} elements)", runs=PER_OP_RUNS, reps=PER_OP_REPS)
    timed.update({(name, GRAD_ROWS, ""): timed[name, GRAD_ROWS, f"({m} elements)"]
                  for name in ("rqs_forward", "rqs_inverse")})
    ms = {name: timed[name, ROWS, ""]["ms"] for name in served}
    check(ms["nsf_sample_log_prob"] >= ms["nsf_sample"] >= ms["nsf_density"],
          f"rates out of order (slp <= sample <= density): {ms}")

    # 9. the Gaussianization flow: served, held against float64, trained, timed
    def gf_args(flow, c, rows, dtype):
        """``(params, layout, F)`` as the wrappers take them: per-row
        parameters as ``(rows, F, K)``, everything detached, in ``dtype``."""
        params, layout, F, _ = gf_fused._flatten_gf(flow, c)
        params = gf_fused._row_params([p.detach() for p in params], layout, (rows,))
        return [p.to(dtype) for p in params], layout, F

    def gf_chain(x, p64, layout):
        """The plain float64 forward: ``(T(x), largest |y| of any layer's
        output in the row)``. A row is called saturated past GF_SATURATED."""
        largest = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for kind, tensors in gf_fused._stages(p64, layout):
            if kind == "rot":
                x = x @ tensors[0].T
            else:
                x, _ = gf_fused._gauss_forward(x, *tensors)
                largest = torch.maximum(largest, x.abs().amax(dim=1))
        return x, largest

    def hold_density(label, name, got, want, largest, F, rows):
        """A GF log-density (or log q) against float64: the median, the
        rows no layer saturates, and the saturated rows apart."""
        d = (got.double() - want).abs()
        calm = largest <= GF_SATURATED
        med, q95, q99, worst = quantiles(d)
        calm_max = d[calm].max().item() if bool(calm.any()) else 0.0
        tol = max(1.0, F / 6)  # the errors of F features add
        print(f"{label} at {rows} rows vs f64: median {med:.3e} q95 {q95:.3e} q99 {q99:.3e}"
              f" max {worst:.3e}; rows with every |y| <= {GF_SATURATED}:"
              f" {calm.float().mean().item():.4f} of all, max {calm_max:.3e}")
        if not bool(calm.all()):
            sat = d[~calm]
            at = sat.argmax()
            print(f"  saturated rows: {sat.numel()}, max {sat.max().item():.3e} at |y| ="
                  f" {largest[~calm][at].item():.3f}, largest |y| {largest.max().item():.3f}")
            check(sat.max().item() <= TOL_GF_SATURATED, f"{label} (saturated rows)")
        check(bool(torch.isfinite(got).all()), f"{label}: not finite")
        check(med <= tol * TOL_GF_MEDIAN, f"{label} (median)")
        check(calm_max <= tol * TOL_GF_MAX, f"{label} (max over unsaturated rows)")
        if name is not None:
            note_error(name, d[calm], rows)

    def hold_gf(label, flow, c, rows, x, names=GF_NAMES, generator=None):
        """K6 and K7 of ``flow`` under context ``c`` at ``rows`` rows against
        their plain versions in float64, on draws from ``generator`` (default
        ``gen``); the errors noted under ``names`` (density, sample, sample
        with log q; a name None: not noted), if any."""
        report = names is not None
        params, layout, F = gf_args(flow, c, rows, torch.float32)
        p64 = [p.double() for p in params]
        _, largest = gf_chain(x.double(), p64, layout)
        hold_density(f"{label} density", names[0] if report else None,
                     gf_fused.gf_density(x, params, layout, F),
                     gf_fused._gf_math(x.double(), p64, layout, F), largest, F, rows)
        z = torch.randn(rows, F, generator=gen if generator is None else generator, device=dev)
        k_x = gf_fused.gf_sample(z, params, layout, F)
        k_xl, k_lq = gf_fused.gf_sample(z, params, layout, F, True)
        r_x, r_lq = gf_fused._gf_sample_math(z.double(), p64, layout, F, True)
        check(bool((k_x == k_xl).all()), f"{label}: sample and sample_and_log_prob differ in x")
        check(bool(torch.isfinite(k_x).all() and torch.isfinite(k_lq).all()),
              f"{label}: samples not finite")
        dx = (k_x.double() - r_x).abs()
        back, largest = gf_chain(k_x.double(), p64, layout)
        dback = (back - z.double()).abs()
        solved = dback.amax(dim=1) <= GF_SOLVED
        # the rows the float64 plain version itself brings back to z: the
        # others peg at the bracket, by design, in both
        solved64 = (gf_chain(r_x, p64, layout)[0] - z.double()).abs().amax(dim=1) <= GF_SOLVED
        dlq = (k_lq.double() - r_lq).abs()
        dself = (k_lq - gf_fused.gf_density(k_xl, params, layout, F)).abs()
        good = solved & (largest <= GF_SATURATED)
        for what, d in (("x vs plain f64", dx), ("T(x) vs z (f64 forward)", dback),
                        ("log q vs plain f64", dlq), ("log q vs density kernel at x", dself)):
            print(f"{label} sample at {rows} rows, {what}: median %.3e q95 %.3e q99 %.3e"
                  f" max %.3e" % quantiles(d))
        print(f"{label} sample: rows solved to {GF_SOLVED} {solved.float().mean().item():.4f}"
              f" (plain f64: {solved64.float().mean().item():.4f}; T(x) vs z there: median"
              f" %.3e q95 %.3e q99 %.3e max %.3e)," % quantiles(dback[solved64]),
              f"solved and unsaturated {good.float().mean().item():.4f} of all; there log q vs"
              f" plain f64 max {dlq[good].max().item():.3e}, vs density kernel max"
              f" {dself[good].max().item():.3e}")
        tol = max(1.0, F / 6)
        check(quantiles(dx)[0] <= TOL_SAMPLE_MEDIAN and quantiles(dx)[1] <= TOL_GF_SAMPLE_Q95,
              f"{label} samples vs plain")
        check(quantiles(dback[solved64])[0] <= TOL_SAMPLE_MEDIAN, f"{label} round trip")
        check(quantiles(dback[solved64])[2] <= TOL_GF_BACK_Q99, f"{label} round trip (q99)")
        check(dlq[good].median().item() <= tol * TOL_GF_MEDIAN, f"{label} log q vs plain (median)")
        check(dself[good].median().item() <= tol * TOL_GF_SELF, f"{label} log q vs density kernel")
        if report:
            note_error(names[1], dx[good], rows)
            note_error(names[2], dlq[good], rows)
        return params, layout, F

    gtruth = np.load(ROOT / "tools" / "gf_truth_f64.npz")
    gf_weights = {k: gtruth[k] for k in gtruth.files if k not in ("x", "lp")}
    # the file holds the trained parameters; the base is the standard normal
    gf_weights.update({"base.args.0": np.zeros(6, np.float32), "base.args.1": np.ones(6, np.float32)})

    def gf_trained():
        return zt.load_params(zt.GF(6, 0, transforms=3, components=8, device=dev), gf_weights)

    gf = gf_trained()
    torch.manual_seed(2)
    gf_cond = zt.GF(6, 4, transforms=3, device=dev)
    gf_wide = {  # the rotation branch at real widths, parameters damped
        "GF(21, transforms=2)": (zt.GF(21, 0, transforms=2, device=dev), 1 << 16),
        "GF(64, transforms=3)": (zt.GF(64, 0, transforms=3, device=dev), 1 << 14),
    }
    with torch.no_grad():
        for flow, _ in gf_wide.values():
            for p in flow.parameters():
                p.mul_(0.3)
    gx_truth = torch.as_tensor(gtruth["x"], device=dev)
    gc_big = torch.randn(ROWS, 4, generator=gen, device=dev)
    gc_few = torch.randn(1024, 4, generator=gen, device=dev)

    gf_served = ("gf_density", "gf_sample", "gf_sample_log_prob")
    ops.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        gdist = gf(None)
        g_lp_truth = gdist.log_prob(gx_truth)
        g_lp = gdist.log_prob(x_big)
        g_xs = gdist.sample((ROWS,), generator=gen)
        g_xl, g_lq = gdist.sample_and_log_prob((ROWS,), generator=gen)
        gcdist = gf_cond(gc_big)
        gc_lp = gcdist.log_prob(x_big)
        gcfew = gf_cond(gc_few)
        gc_xs = gcfew.sample((4,), generator=gen)
        gc_xl, gc_lq = gcfew.sample_and_log_prob((4,), generator=gen)
    torch.cuda.synchronize()
    gf_launches = {name: ops.LAUNCHES[name] for name in gf_served}
    print(f"GF serving phase: {time.perf_counter() - t0:.3f} s, launches {gf_launches}")
    check(isinstance(gdist, FusedGaussianizationFlow)
          and isinstance(gcdist, FusedGaussianizationFlow),
          "GFs on the GPU did not dispatch to the fused kernels")
    for name, count in gf_launches.items():
        check(count > 0, f"kernel {name} was not launched by the served GF path")
    check(all(ops.LAUNCHES[name] == 0 for name in served), "the GF path launched an NSF kernel")
    for t, shape in [
        (g_lp_truth, (16384,)), (g_lp, (ROWS,)), (g_xs, (ROWS, 6)), (g_xl, (ROWS, 6)),
        (g_lq, (ROWS,)), (gc_lp, (ROWS,)), (gc_xs, (4, 1024, 6)), (gc_xl, (4, 1024, 6)),
        (gc_lq, (4, 1024)),
    ]:
        check(tuple(t.shape) == shape, f"GF shape {tuple(t.shape)} != {shape}")
        check(bool(torch.isfinite(t).all()), "non-finite values on the served GF path")
    err = (g_lp_truth.double() - torch.as_tensor(gtruth["lp"], device=dev)).abs()
    print(f"GF log_prob vs f64 truth: max {err.max().item():.3e} median {err.median().item():.3e}")
    check(err.median().item() <= TOL_GF_MEDIAN and err.max().item() <= TOL_GF_MAX,
          "GF density vs f64 truth")

    with torch.no_grad():
        for rows in (ROWS, GRAD_ROWS):
            gparams, glayout, _ = hold_gf("GF", gf, None, rows, x_big[:rows])
            hold_gf("conditional GF", gf_cond, gc_big[:rows], rows, x_big[:rows])
        for label, (flow, rows) in gf_wide.items():
            width = flow.base._0.shape[0]
            check(isinstance(gf_fused.plan_gf(gf_args(flow, None, 1, torch.float32)[1], width,
                                              rows, sample=True), nsf_fused.TilePlan),
                  f"{label}: the tiled sampler")
            hold_gf(label, flow, None, rows,
                    torch.randn(rows, width, generator=gen, device=dev), names=None)

    # K7's tiled tier (the sampler's narrow tier where the layers share K <=
    # 16 components): planned for the flagship and the conditional GF(6, 4)
    # under a batched context, and held against the wide tier on the same
    # draws, in both modes, one tiled launch each, at 1M rows, 262,144 - 37
    # and a last tile of one valid row; the same solves and sums in the same
    # order, so the rows where the two differ are counted (an nvcc contraction
    # may part them), and at most 1e-3 of them may; log q on the others
    # within TOL_DENSITY; draws from a generator of their own
    @contextlib.contextmanager
    def gf_wide_tier():
        """The GF kernels' wide tier: the planner told that no flow is
        within the narrow limits."""
        limit = gf_fused._MAX_FEATURES
        gf_fused._MAX_FEATURES = 0
        try:
            yield
        finally:
            gf_fused._MAX_FEATURES = limit

    gen_k7 = torch.Generator(device=dev).manual_seed(20)
    t_k7 = time.perf_counter()
    for label, flow, c in (("GF", gf, None), ("conditional GF", gf_cond, gc_big)):
        tile = gf_fused._GF_TILE
        for rows in (ROWS, GRAD_ROWS - 37, 16 * tile + 1):
            params, layout, F = gf_args(flow, None if c is None else c[:rows], rows, torch.float32)
            plan = gf_fused.plan_gf(layout, F, rows, sample=True)
            check(isinstance(plan, nsf_fused.TilePlan) and plan.tile_rows == tile,
                  f"{label}: the tiled sampler at {tile} rows, {plan}")
            z = torch.randn(rows, F, generator=gen_k7, device=dev)
            for want, kind in ((False, "gf_sample"), (True, "gf_sample_log_prob")):
                ops.reset_launches()
                with torch.no_grad():
                    tiled = gf_fused.gf_sample(z, params, layout, F, want)
                    launched = {k: v for k, v in ops.LAUNCHES.items() if v}
                    with gf_wide_tier():
                        wide = gf_fused.gf_sample(z, params, layout, F, want)
                check(launched == {kind: 1}, f"{label} {kind}: one tiled launch, {launched}")
                tiled = tiled if want else (tiled,)
                wide = wide if want else (wide,)
                check(all(bool(torch.isfinite(t).all()) for t in tiled),
                      f"{label} {kind} tiled at {rows} rows: not finite")
                differ = (tiled[0] != wide[0]).any(dim=1)
                same = all(torch.equal(a, b) for a, b in zip(tiled, wide))
                dx = (tiled[0] - wide[0]).abs().max().item()
                dlq = (tiled[1] - wide[1]).abs()[~differ].max().item() if want else 0.0
                print(f"{label} {kind} tiled at {rows} rows vs the wide tier: rows whose x"
                      f" differ {int(differ.sum().item())}, x max {dx:.3e}"
                      + (f", log q max over the others {dlq:.3e}, rows whose log q differ"
                         f" {int((tiled[1] != wide[1]).sum().item())}" if want else "")
                      + f"; bit for bit: {same}")
                check(differ.float().mean().item() <= 1e-3,
                      f"{label} {kind} tiled at {rows} rows: samples vs the wide tier")
                check(dlq <= TOL_DENSITY, f"{label} {kind} tiled at {rows} rows: log q vs wide")
            del params
    print(f"K7 tiled tier checks: {time.perf_counter() - t_k7:.1f} s")

    # gradients through the two Functions (kernel forward, float32 plain
    # backward) against float64, down to the flows' parameters: the density's
    # against plain autograd; the IFT's against the same three sweeps in
    # float64 at the kernel's own root (the root's conditioning is the
    # solve's contract, held above). The loss is a mean over the rows no
    # layer saturates: a saturated row's slope carries the relative error of
    # exp(y^2 / 2) under float32 rounding of m (up to 6%, see GF_SATURATED),
    # and such rows have the largest gradients, so they are printed apart,
    # with all rows in the loss, and not held.
    def gf_grads(flow, c, v, dtype, weights, x=None):
        """Gradients to ``v`` and to the parameters of ``flow`` of the
        ``weights``-sum of the log-density at ``v``, or, given the root ``x``
        of the draw from ``v``, of log q + |x|^2 (in float32 the Function
        solves again, with the kernel)."""
        flow = copy.deepcopy(flow).to(dtype)
        c = None if c is None else c.to(dtype)
        v, w = v.to(dtype, copy=True).requires_grad_(True), weights.to(dtype)
        params, layout, F, _ = gf_fused._flatten_gf(flow, c)
        rotations = [t[0] for kind, t in gf_fused._stages(params, layout) if kind == "rot"]
        for R in rotations:
            R.retain_grad()
        rows = gf_fused._row_params(params, layout, (v.shape[0],))
        if x is None:
            fn = gf_fused.gf_density if dtype == torch.float32 else gf_fused._gf_math
            (fn(v, rows, layout, F) * w).sum().backward()
        elif dtype == torch.float32:
            x, lq = ift._GFIFTFunction.apply(v, (layout, F), True, *rows)
            ((lq + (x**2).sum(dim=1)) * w).sum().backward()
        else:
            x = x.to(dtype)
            dz, dps = ift._gf_ift_bwd_math(
                v.detach(), x, 2 * x * w[:, None], w, [p.detach() for p in rows],
                [True] * len(rows), layout, F)
            torch.autograd.backward(rows, dps)
            v.grad = dz
        # the first rotation apart: dL/dR, and dL/dA, what A - A^T and
        # matrix_exp leave of it
        first = (rotations[0].grad, next(
            p.grad for name, p in flow.named_parameters() if name.endswith("transforms.1._0")))
        return [v.grad] + [p.grad for p in flow.parameters()], first

    for label, flow, c, xg, ift_too in (
        ("GF", gf, None, x_big[:GRAD_ROWS], True),
        ("conditional GF", gf_cond, gc_big[:GRAD_ROWS], x_big[:GRAD_ROWS], True),
        # what step (e) feeds K6's Function: the trained GF at (e)'s rows
        ("GF at (e)'s rows", gf, None, batches[0], False),
    ):
        zg = torch.randn(GRAD_ROWS, 6, generator=gen, device=dev)
        params, layout, F = gf_args(flow, c, GRAD_ROWS, torch.float32)
        with torch.no_grad():
            root = gf_fused.gf_sample(zg, params, layout, F)
            p64 = [p.double() for p in params]
            calm = [gf_chain(t.double(), p64, layout)[1] <= GF_SATURATED for t in (xg, root)]
        every = torch.ones(GRAD_ROWS, device=dev)
        for rows, hold in (("unsaturated rows", True), ("all rows", False)):
            for what, v, x, w in (("density", xg, None, calm[0]),
                                  *([("IFT", zg, root, calm[1])] if ift_too else [])):
                w = (w if hold else every) / GRAD_ROWS
                (got, first32), (want, first64) = (
                    gf_grads(flow, c, v, dtype, w, x) for dtype in (torch.float32, torch.float64))
                compare_grads(
                    f"{label} {what}, {rows}", got, want, hold=hold,
                    tol_params=TOL_GF_GRAD_PARAMS,
                    tol_input=TOL_GRAD_INPUT if x is None else TOL_GRAD_SOLVE_INPUT)
                if hold:
                    print(f"  first rotation: max |dL/dR| %.3e (f32 - f64 max %.3e),"
                          f" max |dL/dA| %.3e (%.3e)" % tuple(
                              t.item() for a, b in zip(first32, first64)
                              for t in (b.abs().max(), (a.double() - b).abs().max())))
        del params, p64

    # train from the trained parameters (a random-init GF saturates)
    flow_e = gf_trained()
    ops.reset_launches()
    init_fn, step_fns["gf_mle"] = zt.make_mle_step(flow_e, lr=1e-3)
    trained["gf_mle"], _ = run("(e) GF MLE", step_fns["gf_mle"], init_fn(), batch, TRAIN_STEPS)
    counts = counts_after("(e) GF MLE", ["gf_density"], none=served)
    check(counts["gf_density"] == TRAIN_STEPS, "(e): one gf_density launch a step")
    train_launches["gf_density"] = counts["gf_density"]

    flow_f = gf_trained()
    ops.reset_launches()
    init_fn, step_fns["gf_rkl"] = zt.make_reverse_kl_step(flow_f, ring, n_samples=GRAD_ROWS, lr=1e-3)
    trained["gf_rkl"], _ = run("(f) GF reverse KL, IFT", step_fns["gf_rkl"], init_fn(), generator,
                               TRAIN_STEPS)
    counts = counts_after("(f) GF reverse KL, IFT", ["gf_sample_log_prob"], none=served)
    check(counts["gf_sample_log_prob"] == TRAIN_STEPS, "(f): one gf_sample_log_prob launch a step")
    train_launches["gf_sample_log_prob"] = counts["gf_sample_log_prob"]
    per_step.update({
        "gf_mle": time_step("gf_mle", batch, lambda: flow_e(None).log_prob(batches[0]).mean()),
        "gf_rkl": time_step(
            "gf_rkl", generator, lambda: flow_f(None).sample_and_log_prob((GRAD_ROWS,), gen)),
    })

    # times: unconditional at both row counts, batched context at 1M rows
    def gf_work(params, layout, F, rows, x=None, generator=None):
        x = x_big[:rows] if x is None else x
        z = torch.randn(rows, F, generator=gen if generator is None else generator, device=dev)
        args = (params, layout, F)
        read = 4 * sum(p.numel() for p in params)  # every parameter once
        return {
            "gf_density": (
                lambda: gf_fused.gf_density(x, *args), lambda: gf_fused._gf_math(x, *args),
                rows * gf_ops(layout, F, "density"), 4 * rows * (F + 1) + read),
            "gf_sample": (
                lambda: gf_fused.gf_sample(z, *args), lambda: gf_fused._gf_sample_math(z, *args),
                rows * gf_ops(layout, F, "sample"), 4 * rows * 2 * F + read),
            "gf_sample_log_prob": (
                lambda: gf_fused.gf_sample(z, *args, True),
                lambda: gf_fused._gf_sample_math(z, *args, True),
                rows * gf_ops(layout, F, "sample_log_prob"), 4 * rows * (2 * F + 1) + read),
        }

    with torch.no_grad():
        for rows in (ROWS, GRAD_ROWS):
            for name, work in gf_work(gparams, glayout, 6, rows).items():
                time_kernel(name, rows, *work)
                check(timed[name, rows, ""]["bound_by"] == "operations",
                      f"{name}: the unconditional kernel is bound by bytes")
        cparams, clayout, _ = gf_args(gf_cond, gc_big, ROWS, torch.float32)
        for name, work in gf_work(cparams, clayout, 6, ROWS).items():
            time_kernel(name, ROWS, *work, note="batched context")
        check(timed["gf_density", ROWS, "batched context"]["bound_by"] == "bytes",
              "gf_density with per-row parameters is bound by operations")
        del cparams
        gf_requests = {
            "gf_density": lambda: gf(None).log_prob(x_big),
            "gf_sample": lambda: gf(None).sample((ROWS,), generator=gen),
            "gf_sample_log_prob": lambda: gf(None).sample_and_log_prob((ROWS,), generator=gen),
            "gf_density batched context": lambda: gf_cond(gc_big).log_prob(x_big),
        }
        for name, request in gf_requests.items():
            r_ms, r_runs = host_ms(request, 5)
            k_ms = timed[name.split()[0], ROWS, name.partition(" ")[2]]["ms"]
            print(f"served request {name}: {r_ms:.3f} ms {fmt(r_runs)},"
                  f" kernel share {k_ms / r_ms:.3f}")
    step_labels = (("gf_mle", "(e) GF MLE"), ("gf_rkl", "(f) GF reverse KL, IFT"))

    # 10. the neural autoregressive flow (NAF): served, held against float64,
    # trained, timed
    def naf_args(flow, dtype):
        """``(params, layout, F, S)`` as the wrappers take them, detached, in
        ``dtype``."""
        params, layout, F, S = naf_fused._flatten_naf(flow)
        return [p.detach().to(dtype) for p in params], layout, F, S

    def naf_chain(x, p64, layout, F, S, c):
        """The plain float64 forward T(x): what a solved x must map back to."""
        for entry, made, mono_w, mono_b in naf_fused._stages(p64, layout):
            if entry[0] == "softclip":
                x, _ = naf_fused._softclip(x, entry[1])
            else:
                h = naf_fused._made(x if c is None else torch.cat([x, c], dim=1), made)
                x, _ = naf_fused._ar_layer(x, h, entry[4], mono_w, mono_b, F, S)
        return x

    def hold_naf(label, flow, xd, cd, zs, cs, log_q=True, names=NAF_NAMES):
        """K8 at ``xd`` (context ``cd``) and K9 from the draws ``zs`` (context
        ``cs``) against their plain versions in float64: the density and log q
        by median and max (times F / 6 for wider flows), the samples by
        quantiles, the round trip T(x) through the float64 forward, and log q
        against K8 at the returned points. The errors are noted under
        ``names`` (density, sample, sample with log q), if any."""
        report = names is not None
        params, layout, F, S = naf_args(flow, torch.float32)
        p64 = [p.double() for p in params]
        tol = max(1.0, F / 6)  # the errors of F features add
        xc = xd if cd is None else torch.cat([xd, cd], dim=1)
        d = (naf_fused.naf_density(xc, params, layout, F, S).double()
             - naf_fused._naf_density_math(xc.double(), p64, layout, F, S)).abs()
        med, q95, q99, worst = quantiles(d)
        print(f"{label} density at {xd.shape[0]} rows vs plain f64: median {med:.3e}"
              f" q95 {q95:.3e} q99 {q99:.3e} max {worst:.3e}")
        check(med <= tol * TOL_NAF_MEDIAN and worst <= tol * TOL_NAF_MAX,
              f"{label} density vs plain")
        if report:
            note_error(names[0], d, xd.shape[0])
        rows = zs.shape[0]
        zc = zs if cs is None else torch.cat([zs, cs], dim=1)
        k_x = naf_fused.naf_sample(zc, params, layout, F, S)
        r_x = naf_fused._naf_sample_math(zc.double(), p64, layout, F, S, log_q)
        if log_q:
            r_x, r_lq = r_x
            k_xl, k_lq = naf_fused.naf_sample(zc, params, layout, F, S, True)
            check(bool((k_x == k_xl).all()), f"{label}: sample and sample_and_log_prob differ in x")
        dx = (k_x.double() - r_x).abs()
        c64 = None if cs is None else cs.double()
        dback = (naf_chain(k_x.double(), p64, layout, F, S, c64) - zs.double()).abs()
        found = [("x vs plain f64", dx), ("T(x) vs z (f64 forward)", dback)]
        if log_q:
            dlq = (k_lq.double() - r_lq).abs()
            dself = (k_lq - naf_fused.naf_density(
                k_xl if cs is None else torch.cat([k_xl, cs], dim=1), params, layout, F, S)).abs()
            found += [("log q vs plain f64", dlq), ("log q vs density kernel at x", dself)]
        for what, diff in found:
            print(f"{label} sample at {rows} rows, {what}: median %.3e q95 %.3e q99 %.3e"
                  f" max %.3e" % quantiles(diff))
        check(bool(torch.isfinite(k_x).all()), f"{label}: samples not finite")
        check(quantiles(dx)[0] <= TOL_SAMPLE_MEDIAN and quantiles(dx)[2] <= TOL_NAF_SAMPLE_Q99,
              f"{label} samples vs plain")
        check(quantiles(dback)[0] <= TOL_SAMPLE_MEDIAN, f"{label} round trip")
        if log_q:
            check(bool(torch.isfinite(k_lq).all()), f"{label}: log q not finite")
            check(quantiles(dlq)[0] <= tol * TOL_NAF_MEDIAN, f"{label} log q vs plain (median)")
            check(quantiles(dself)[0] <= tol * TOL_NAF_SELF, f"{label} log q vs density kernel")
        if report:
            note_error(names[1], dx, rows)
            if log_q:
                note_error(names[2], dlq, rows)

    naf_flagship = zt.load_params(zt.NAF(6, 0, transforms=3, signal=16, device=dev),
                                  ROOT / "zuko_tpu_torch" / "assets" / "naf_flagship.npz")
    ntruth = np.load(ROOT / "zuko_tpu_torch" / "assets" / "naf_truth_f64.npz")
    torch.manual_seed(3)
    naf_cond = zt.NAF(6, 4, transforms=3, signal=16, device=dev)
    torch.manual_seed(4)
    naf_wide = zt.NAF(32, 0, transforms=2, signal=16, device=dev)
    # one request of 1M rows holds the truth rows first
    nx_big = torch.cat([torch.as_tensor(ntruth["x"], device=dev, dtype=torch.float32),
                        x_big[: ROWS - ntruth["x"].shape[0]]])
    nc_big = torch.randn(ROWS, 4, generator=gen, device=dev)
    nc_few = torch.randn(1024, 4, generator=gen, device=dev)
    nw_x = torch.randn(NAF_WIDE_ROWS, 32, generator=gen, device=dev)

    naf_served = ("naf_density", "naf_sample", "naf_sample_log_prob")
    ops.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        ndist = naf_flagship(None)
        n_lp = ndist.log_prob(nx_big)
        n_xs = ndist.sample((NAF_SAMPLE_ROWS,), generator=gen)
        n_xl, n_lq = ndist.sample_and_log_prob((NAF_SAMPLE_ROWS,), generator=gen)
        ncdist = naf_cond(nc_big)
        nc_lp = ncdist.log_prob(x_big)
        ncfew = naf_cond(nc_few)
        nc_xs = ncfew.sample((4,), generator=gen)
        nc_xl, nc_lq = ncfew.sample_and_log_prob((4,), generator=gen)
        nwdist = naf_wide(None)
        nw_lp = nwdist.log_prob(nw_x)
        nw_xs = nwdist.sample((NAF_WIDE_ROWS // 4,), generator=gen)
    torch.cuda.synchronize()
    naf_launches = {name: ops.LAUNCHES[name] for name in naf_served}
    print(f"NAF serving phase: {time.perf_counter() - t0:.3f} s, launches {naf_launches}")
    check(all(isinstance(d, FusedNeuralSamplingFlow) for d in (ndist, ncdist, nwdist)),
          "NAFs on the GPU did not dispatch to the fused kernels")
    check(naf_launches == {"naf_density": 3, "naf_sample": 3, "naf_sample_log_prob": 2},
          f"NAF serving launches {naf_launches}")
    check(all(ops.LAUNCHES[name] == 0 for name in (*served, *gf_served)),
          "the NAF path launched another flow's kernel")
    for t, shape in [
        (n_lp, (ROWS,)), (n_xs, (NAF_SAMPLE_ROWS, 6)), (n_xl, (NAF_SAMPLE_ROWS, 6)),
        (n_lq, (NAF_SAMPLE_ROWS,)), (nc_lp, (ROWS,)), (nc_xs, (4, 1024, 6)),
        (nc_xl, (4, 1024, 6)), (nc_lq, (4, 1024)), (nw_lp, (NAF_WIDE_ROWS,)),
        (nw_xs, (NAF_WIDE_ROWS // 4, 32)),
    ]:
        check(tuple(t.shape) == shape, f"NAF shape {tuple(t.shape)} != {shape}")
        check(bool(torch.isfinite(t).all()), "non-finite values on the served NAF path")
    n_truth = ntruth["x"].shape[0]
    err = (n_lp[:n_truth].double() - torch.as_tensor(ntruth["lp"], device=dev)).abs()
    print(f"NAF log_prob vs f64 truth ({n_truth} rows): max {err.max().item():.3e}"
          f" median {err.median().item():.3e}")
    check(err.median().item() <= TOL_NAF_MEDIAN and err.max().item() <= TOL_NAF_MAX,
          "NAF density vs f64 truth")

    with torch.no_grad():
        hold_naf("NAF", naf_flagship, nx_big, None,
                 torch.randn(NAF_SAMPLE_ROWS, 6, generator=gen, device=dev), None)
        hold_naf("conditional NAF", naf_cond, x_big, nc_big,
                 torch.randn(4096, 6, generator=gen, device=dev), nc_few.repeat(4, 1),
                 names=None)
        hold_naf("NAF(32, transforms=2)", naf_wide, nw_x, None,
                 torch.randn(NAF_WIDE_ROWS // 4, 32, generator=gen, device=dev), None,
                 log_q=False, names=None)
        # a row count that is no multiple of the tiled sampler's tile (the
        # checks added with the tiled NAF sampler and the adjoint's cluster
        # tier draw from gen_tiers, so that every later check keeps its draws)
        hold_naf("NAF, ragged", naf_flagship, nx_big[:4096], None,
                 torch.randn(NAF_SAMPLE_ROWS - 37, 6, generator=gen_tiers, device=dev), None,
                 names=None)

    # a NAF within the narrow limits whose tiled sampler would not fit in
    # shared memory (MADE widths of 256, the flagship's monotone networks:
    # 386 KB at tiles of 128 rows) samples through the wide tier; its
    # density takes the tiled tier at tiles of 32 rows (161 KB)
    with torch.random.fork_rng(devices=[dev]):
        torch.manual_seed(7)
        naf_made256 = zt.NAF(6, 0, transforms=3, signal=16, hidden_features=(256, 256),
                             device=dev)
    wparams, wlayout, _, wS = naf_args(naf_made256, torch.float32)
    _, w_made, w_mono = naf_fused._widths(wparams, wlayout, 6, 0, wS)
    check(naf_fused.plan_naf("mnn", w_made, w_mono, 6, 0, wS, len(wlayout), UNAF_WIDE_ROWS,
                             sample=True).wide,
          "the NAF with MADE widths of 256 plans the tiled sampler")
    check(naf_fused.density_tile_rows("mnn", w_made, w_mono, 6, 0, wS, NAF_IFT_ROWS, 132) == 32,
          "the NAF with MADE widths of 256: its density's tile")
    ops.reset_launches()
    with torch.no_grad():
        wdist = naf_made256(None)
        w_xs = wdist.sample((UNAF_WIDE_ROWS,), generator=gen_tiers)
        w_xl, w_lq = wdist.sample_and_log_prob((UNAF_WIDE_ROWS,), generator=gen_tiers)
        w_lp = wdist.log_prob(x_big[:NAF_IFT_ROWS])
    w_launches = {name: count for name, count in ops.LAUNCHES.items() if count}
    print(f"NAF with MADE widths of 256 served (samples through the wide tier, the density"
          f" tiled): launches {w_launches}")
    check(w_launches == {"naf_sample_wide": 1, "naf_sample_log_prob_wide": 1, "naf_density": 1},
          f"NAF with MADE widths of 256: launches {w_launches}")
    check(all(bool(torch.isfinite(t).all()) for t in (w_xs, w_xl, w_lq, w_lp)),
          "NAF with MADE widths of 256: not finite")
    with torch.no_grad():
        hold_naf("NAF, MADE widths of 256 (wide tier)", naf_made256, nx_big[:4096], None,
                 torch.randn(UNAF_WIDE_ROWS, 6, generator=gen_tiers, device=dev), None,
                 names=None)

    # at the training steps' shapes, through the tensors the gradient checks
    # build: K8's Function (kernel forward, float32 plain backward) against
    # float64 plain autograd, at 262,144 standard-normal rows and at (g)'s
    # rows (the NSF's samples, batches[0]), the reference in chunks to bound
    # its graph; K9 with log q and the IFT backward at (h)'s 65,536 rows
    # against the same sweeps in float64 at the kernel's own root
    nparams, nlayout, _, nS = naf_args(naf_flagship, torch.float32)
    n64 = [p.double() for p in nparams]

    @contextlib.contextmanager
    def wide_tier():
        """The NAF kernels' wide tier for the calls within, whatever the
        flow's shape."""
        plan_naf = naf_fused.plan_naf
        naf_fused.plan_naf = lambda kind, made_w, mono_w, F, C, S, n_stages, rows, **k: plan_naf(
            kind, made_w, mono_w, F, C, S, naf_fused._MAX_STAGES + 1, rows)
        try:
            yield
        finally:
            naf_fused.plan_naf = plan_naf

    def hold_tiers(label, flow, x=None, z=None):
        """The tiled narrow tier against the wide tier on the same inputs,
        the density at the rows ``x`` (the MNN mode bit for bit, the UMNN
        mode within ``TOL_UMNN_TIERS``) and the sampler with log q from the
        draws ``z`` (any difference printed and held at the NAF limits)."""
        params, layout, F, S = naf_args(flow, torch.float32)
        kind = next(entry[4] for entry in layout if entry[0] != "softclip")
        tol = max(1.0, F / 6)
        outs = []
        with torch.no_grad():
            for tier in (contextlib.nullcontext(), wide_tier()):
                with tier:
                    outs.append((
                        None if x is None else naf_fused.naf_density(x, params, layout, F, S),
                        None if z is None else naf_fused.naf_sample(z, params, layout, F, S, True)))
        (d_tiled, s_tiled), (d_wide, s_wide) = outs
        if x is not None:
            d = (d_tiled - d_wide).abs()
            print(f"{label} density at {x.shape[0]} rows, tiled tier vs wide tier (the same"
                  f" inputs): max |diff| {d.max().item():.3e}, rows that differ"
                  f" {int((d > 0).sum().item())}")
            check(d.max().item() <= (TOL_UMNN_TIERS if kind == "umnn" else 0.0),
                  f"{label} density: the tiled tier and the wide tier differ")
        if z is not None:
            dx, dlq = ((a - b).abs() for a, b in zip(s_tiled, s_wide))
            print(f"{label} sampler at {z.shape[0]} rows, tiled tier vs wide tier (the same"
                  f" inputs): x max |diff| {dx.max().item():.3e}, log q max |diff|"
                  f" {dlq.max().item():.3e}")
            check(quantiles(dx)[2] <= TOL_NAF_SAMPLE_Q99
                  and quantiles(dlq)[0] <= tol * TOL_NAF_MEDIAN,
                  f"{label} sampler: the tiled tier and the wide tier differ")

    # the tiled sampler against its wide tier at (h)'s rows
    hold_tiers("NAF", naf_flagship,
               z=torch.randn(NAF_IFT_ROWS, 6, generator=gen_tiers, device=dev))
    # the tiled density against its wide tier: tiles of 128 rows, a ragged
    # last tile, and 4,097 rows (tiles of 32, the last with one valid row)
    x_tiers = torch.randn(NAF_IFT_ROWS, 6, generator=gen_density, device=dev)
    for rows in (NAF_IFT_ROWS, NAF_IFT_ROWS - 37, 4097):
        hold_tiers("NAF", naf_flagship, x=x_tiers[:rows])

    def built(make, seed, damp=1.0, mono=1.0):
        """A flow made on the CPU from ``seed`` (so a CPU run makes the same
        weights), its univariates' weights scaled by ``mono`` and every other
        parameter by ``damp``, on the card."""
        torch.manual_seed(seed)
        flow = make()
        with torch.no_grad():
            for name, p in flow.named_parameters():
                p.mul_(mono if "univariate" in name and "weight" in name else damp)
        return flow.to(dev)

    def hold_flat(label, cls, seed, names, sample_rows):
        """A flow of ``cls`` whose MADE has no hidden layer (the tiled
        sampler's kFlat instantiation), served: its density at 65,536 rows and its
        samples through the tiled kernels, held against plain float64 and
        against the wide tier. Its MADE and biases are scaled by 0.3: at full
        scale most of the NAF's draws peg at the bracket, in float64 as in
        float32 (on an H100 the round trip's median was 3.8; at 0.3,
        1.9e-7)."""
        with torch.random.fork_rng(devices=[dev]):
            flow = built(lambda: cls(6, 0, transforms=3, signal=16, hidden_features=(),
                                     device="cpu"), seed, damp=0.3)
        x = torch.randn(NAF_IFT_ROWS, 6, generator=gen_density, device=dev)
        ops.reset_launches()
        with torch.no_grad():
            dist = flow(None)
            lp = dist.log_prob(x)
            xs = dist.sample((sample_rows,), generator=gen_density)
            xl, lq = dist.sample_and_log_prob((sample_rows,), generator=gen_density)
        counts = {name: count for name, count in ops.LAUNCHES.items() if count}
        print(f"{label} served: launches {counts}")
        check(counts == dict.fromkeys(names, 1), f"{label}: launches {counts}")
        check(all(bool(torch.isfinite(t).all()) for t in (lp, xs, xl, lq)), f"{label}: not finite")
        z = torch.randn(sample_rows, 6, generator=gen_density, device=dev)
        with torch.no_grad():
            hold_naf(label, flow, x, None, z, None, names=None)
        hold_tiers(label, flow, x, z)

    hold_flat("NAF without a hidden MADE layer", zt.NAF, 8, NAF_NAMES, NAF_SAMPLE_ROWS // 16)

    def naf_leaves(ps0):
        return [p.detach().clone().requires_grad_(True) for p in ps0]

    def hold_naf_density_grads(label, name, params, p64, layout, S, xg, chunk):
        """K8's Function at the rows ``xg``: its forward against plain
        float64, its gradient against float64 plain autograd (in chunks of
        ``chunk`` rows)."""
        rows = xg.shape[0]
        ps, xr = naf_leaves(params), xg.clone().requires_grad_(True)
        lp32 = naf_fused.naf_density(xr, ps, layout, 6, S)
        lp32.mean().backward()
        got = [xr.grad] + [p.grad for p in ps]
        ps, dxs, lp64 = naf_leaves(p64), [], []
        for part in xg.double().split(chunk):
            xr = part.clone().requires_grad_(True)
            lp = naf_fused._naf_density_math(xr, ps, layout, 6, S)
            (lp.sum() / rows).backward()
            dxs.append(xr.grad)
            lp64.append(lp.detach())
        d = (lp32.detach().double() - torch.cat(lp64)).abs()
        print(f"{label} density at {rows} rows vs plain f64: max {d.max().item():.3e}")
        check(d.max().item() <= TOL_NAF_MAX, f"{label} density at {rows} rows vs plain")
        note_error(name, d, rows)
        compare_grads(f"{label} density", got, [torch.cat(dxs)] + [p.grad for p in ps])

    def hold_naf_ift(label, name, params, p64, layout, S, zg):
        """K9 with log q and the IFT backward at the draws ``zg`` against the
        same sweeps in float64 at the kernel's own root."""
        rows = zg.shape[0]
        w = torch.full((rows,), 1.0 / rows, device=dev)
        ps, zr = naf_leaves(params), zg.clone().requires_grad_(True)
        root, lq32 = ift._NAFIFTFunction.apply(zr, (layout, 6, S), True, *ps)
        ((lq32 + (root**2).sum(dim=1)) * w).sum().backward()
        got = [zr.grad] + [p.grad for p in ps]
        with torch.no_grad():
            r_x, r_lq = naf_fused._naf_sample_math(zg.double(), p64, layout, 6, S, True)
        x64, w64 = root.detach().double(), w.double()
        dz, dps = ift._naf_ift_bwd_math(zg.double(), x64, 2 * x64 * w64[:, None], w64, p64,
                                        [True] * len(p64), layout, 6, S)
        dx, dlq = (root.detach().double() - r_x).abs(), (lq32.detach().double() - r_lq).abs()
        print(f"{label} solve (log q) at {rows} rows vs plain f64: x median %.3e q95 %.3e"
              f" q99 %.3e max %.3e;" % quantiles(dx), "log q median %.3e q95 %.3e q99 %.3e"
              " max %.3e" % quantiles(dlq))
        check(quantiles(dx)[0] <= TOL_SAMPLE_MEDIAN and quantiles(dx)[2] <= TOL_NAF_SAMPLE_Q99,
              f"{label} solve at {rows} rows vs plain")
        check(quantiles(dlq)[0] <= TOL_NAF_MEDIAN, f"{label} log q at {rows} rows vs plain")
        note_error(name, dlq, rows)
        compare_grads(f"{label} IFT (log q), at the kernel's root", got, [dz[:, :6]] + dps,
                      tol_input=TOL_GRAD_SOLVE_INPUT)

    # not the flagship's own samples: there the score has mean zero under the
    # model, and every parameter's gradient is a cancelling remainder of its
    # terms (1.3e-01 max-relative in float32 on an H100 at 262,144 rows)
    hold_naf_density_grads("NAF", "naf_density", nparams, n64, nlayout, nS, x_big[:GRAD_ROWS],
                           GRAD_ROWS // 4)
    hold_naf_density_grads("NAF at (g)'s rows", "naf_density", nparams, n64, nlayout, nS,
                           batches[0], GRAD_ROWS // 4)
    hold_naf_ift("NAF", "naf_sample_log_prob", nparams, n64, nlayout, nS,
                 torch.randn(NAF_IFT_ROWS, 6, generator=gen, device=dev))

    # train from the flagship's parameters; (g) on the samples the NSF
    # serving phase drew, as (a) and (e): the NAF's own samples give MLE no
    # gradient in expectation
    flow_g = zt.load_params(zt.NAF(6, 0, transforms=3, signal=16, device=dev),
                            ROOT / "zuko_tpu_torch" / "assets" / "naf_flagship.npz")
    ops.reset_launches()
    init_fn, step_fns["naf_mle"] = zt.make_mle_step(flow_g, lr=1e-3)
    trained["naf_mle"], _ = run("(g) NAF MLE", step_fns["naf_mle"], init_fn(), batch,
                                TRAIN_STEPS)
    counts = counts_after("(g) NAF MLE", ["naf_density"], none=(*served, *gf_served))
    check(counts["naf_density"] == TRAIN_STEPS, "(g): one naf_density launch a step")
    train_launches["naf_density"] = counts["naf_density"]

    flow_h = copy.deepcopy(naf_flagship)
    ops.reset_launches()
    init_fn, step_fns["naf_rkl"] = zt.make_reverse_kl_step(
        flow_h, ring, n_samples=NAF_IFT_ROWS, lr=1e-3)
    trained["naf_rkl"], _ = run("(h) NAF reverse KL, IFT", step_fns["naf_rkl"], init_fn(),
                                generator, TRAIN_STEPS)
    counts = counts_after("(h) NAF reverse KL, IFT", ["naf_sample_log_prob"],
                          none=(*served, *gf_served, "naf_density", "naf_sample"))
    check(counts["naf_sample_log_prob"] == TRAIN_STEPS,
          "(h): one naf_sample_log_prob launch a step")
    train_launches["naf_sample_log_prob"] = counts["naf_sample_log_prob"]
    per_step.update({
        "naf_mle": time_step("naf_mle", batch, lambda: flow_g(None).log_prob(batches[0]).mean()),
        "naf_rkl": time_step("naf_rkl", generator, lambda: flow_h(None).sample_and_log_prob(
            (NAF_IFT_ROWS,), gen)),
    })

    # times: the density at the serving and training rows, sampling at the
    # serving rows (= the MLE step's) and at (h)'s
    def naf_work_of(params, layout, F, S, xc, zc, names):
        """``names`` (density, sample, sample with log q) -> (kernel, plain,
        operations, bytes) of the NAF kernels at the rows ``xc`` and the
        draws ``zc`` (each with its context): every input read once, every
        weight once, every output written once."""
        rows, D0 = xc.shape
        args = (params, layout, F, S)
        weights = 4 * sum(p.numel() for p in params)
        return {
            names[0]: (
                lambda: naf_fused.naf_density(xc, *args),
                lambda: naf_fused._naf_density_math(xc, *args),
                rows * naf_ops(params, layout, F, S, "density"), 4 * rows * (D0 + 1) + weights),
            names[1]: (
                lambda: naf_fused.naf_sample(zc, *args),
                lambda: naf_fused._naf_sample_math(zc, *args),
                rows * naf_ops(params, layout, F, S, "sample"), 4 * rows * (D0 + F) + weights),
            names[2]: (
                lambda: naf_fused.naf_sample(zc, *args, True),
                lambda: naf_fused._naf_sample_math(zc, *args, True),
                rows * naf_ops(params, layout, F, S, "sample_log_prob"),
                4 * rows * (D0 + F + 1) + weights),
        }

    def naf_work(rows):
        return naf_work_of(nparams, nlayout, 6, nS, nx_big[:rows],
                           torch.randn(rows, 6, generator=gen, device=dev), NAF_NAMES)

    with torch.no_grad():
        for rows, names in ((ROWS, ("naf_density",)), (NAF_SAMPLE_ROWS, naf_served),
                            (NAF_IFT_ROWS, ("naf_sample_log_prob",))):
            work = naf_work(rows)
            for name in names:
                time_kernel(name, rows, *work[name], runs=NAF_RUNS)
                check(timed[name, rows, ""]["bound_by"] == "operations",
                      f"{name}: bound by bytes")
        naf_requests = {
            "naf_density": (ROWS, lambda: naf_flagship(None).log_prob(nx_big)),
            "naf_sample": (NAF_SAMPLE_ROWS,
                           lambda: naf_flagship(None).sample((NAF_SAMPLE_ROWS,), generator=gen)),
            "naf_sample_log_prob": (NAF_SAMPLE_ROWS, lambda: naf_flagship(None).sample_and_log_prob(
                (NAF_SAMPLE_ROWS,), generator=gen)),
        }
        for name, (rows, request) in naf_requests.items():
            r_ms, r_runs = host_ms(request, NAF_RUNS)
            print(f"served request {name} at {rows} rows: {r_ms:.3f} ms {fmt(r_runs)},"
                  f" kernel share {timed[name, rows, '']['ms'] / r_ms:.3f}")
    step_labels += (("naf_mle", "(g) NAF MLE"), ("naf_rkl", "(h) NAF reverse KL, IFT"))

    # 11. the unconstrained neural autoregressive flow (UNAF, the UMNN mode of
    # K8 and K9): served, held against float64, trained, timed
    unaf_flagship = zt.load_params(zt.UNAF(6, 0, transforms=3, signal=16, device=dev),
                                   ROOT / "zuko_tpu_torch" / "assets" / "unaf_flagship.npz")
    utruth = np.load(ROOT / "zuko_tpu_torch" / "assets" / "unaf_truth_f64.npz")
    torch.manual_seed(5)
    unaf_cond = zt.UNAF(6, 4, transforms=3, signal=16, device=dev)
    n_utruth = utruth["x"].shape[0]
    # one request holds the truth rows first
    ux_big = torch.cat([torch.as_tensor(utruth["x"], device=dev, dtype=torch.float32),
                        x_big[: UNAF_DENSITY_ROWS - n_utruth]])
    uc_big = torch.randn(UNAF_DENSITY_ROWS, 4, generator=gen, device=dev)
    uc_few = torch.randn(1024, 4, generator=gen, device=dev)

    ops.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        udist = unaf_flagship(None)
        u_lp = udist.log_prob(ux_big)
        u_xs = udist.sample((UNAF_SAMPLE_ROWS,), generator=gen)
        u_xl, u_lq = udist.sample_and_log_prob((UNAF_SAMPLE_ROWS,), generator=gen)
        ucdist = unaf_cond(uc_big)
        uc_lp = ucdist.log_prob(x_big[:UNAF_DENSITY_ROWS])
        ucfew = unaf_cond(uc_few)
        uc_xs = ucfew.sample((4,), generator=gen)
        uc_xl, uc_lq = ucfew.sample_and_log_prob((4,), generator=gen)
    torch.cuda.synchronize()
    unaf_launches = {name: ops.LAUNCHES[name] for name in UMNN_NAMES}
    print(f"UNAF serving phase: {time.perf_counter() - t0:.3f} s, launches {unaf_launches}")
    check(all(isinstance(d, FusedNeuralSamplingFlow) for d in (udist, ucdist, ucfew)),
          "UNAFs on the GPU did not dispatch to the fused kernels")
    check(unaf_launches == dict(zip(UMNN_NAMES, (2, 2, 2))),
          f"UNAF serving launches {unaf_launches}")
    check(all(count == 0 for name, count in ops.LAUNCHES.items() if name not in UMNN_NAMES),
          "the UNAF path launched another kernel")
    for t, shape in [
        (u_lp, (UNAF_DENSITY_ROWS,)), (u_xs, (UNAF_SAMPLE_ROWS, 6)), (u_xl, (UNAF_SAMPLE_ROWS, 6)),
        (u_lq, (UNAF_SAMPLE_ROWS,)), (uc_lp, (UNAF_DENSITY_ROWS,)), (uc_xs, (4, 1024, 6)),
        (uc_xl, (4, 1024, 6)), (uc_lq, (4, 1024)),
    ]:
        check(tuple(t.shape) == shape, f"UNAF shape {tuple(t.shape)} != {shape}")
        check(bool(torch.isfinite(t).all()), "non-finite values on the served UNAF path")
    # K8's UMNN mode integrates by 16 nodes: held against zuko_tpu's fused
    # float64 math (lp_gl16), and against its unfused GL-32 density (lp),
    # from which the rules themselves differ by up to 3.4e-6 on these rows
    for column in ("lp_gl16", "lp"):
        err = (u_lp[:n_utruth].double() - torch.as_tensor(utruth[column], device=dev)).abs()
        print(f"UNAF log_prob vs f64 truth {column} ({n_utruth} rows): max {err.max().item():.3e}"
              f" median {err.median().item():.3e}")
        check(err.max().item() <= TOL_DENSITY, f"UNAF density vs f64 truth {column}")

    with torch.no_grad():
        hold_naf("UNAF", unaf_flagship, ux_big, None,
                 torch.randn(UNAF_SAMPLE_ROWS, 6, generator=gen, device=dev), None,
                 names=UMNN_NAMES)
        hold_naf("conditional UNAF", unaf_cond, x_big[:UNAF_DENSITY_ROWS], uc_big,
                 torch.randn(4096, 6, generator=gen, device=dev), uc_few.repeat(4, 1), names=None)
        # a row count that is no multiple of the tiled sampler's tile
        hold_naf("UNAF, ragged", unaf_flagship, ux_big[:4096], None,
                 torch.randn(UNAF_SAMPLE_ROWS - 37, 6, generator=gen, device=dev), None,
                 names=None)

    # the tiled UMNN density against its wide tier: tiles of 64 rows, a
    # ragged last tile, and 4,097 rows (tiles of 16, the last with one valid
    # row); a UNAF whose MADE has no hidden layer
    for rows in (NAF_IFT_ROWS, NAF_IFT_ROWS - 37, 4097):
        hold_tiers("UNAF", unaf_flagship, x=x_tiers[:rows])
    hold_flat("UNAF without a hidden MADE layer", zt.UNAF, 9, UMNN_NAMES, UNAF_IFT_ROWS // 4)

    # a UNAF within the narrow limits whose tiled sampler would not fit in
    # shared memory (three hidden layers of 128: 279 KB at tiles of 64 rows)
    # samples through the wide tier; its density takes the tiled tier at
    # tiles of 16 rows (220 KB)
    torch.manual_seed(6)
    unaf_deep = zt.UNAF(6, 0, transforms=3, signal=16, network={"hidden_features": (128,) * 3},
                        device=dev)
    dparams, dlayout, _, dS = naf_args(unaf_deep, torch.float32)
    _, d_made, d_mono = naf_fused._widths(dparams, dlayout, 6, 0, dS)
    check(naf_fused.plan_naf("umnn", d_made, d_mono, 6, 0, dS, len(dlayout), UNAF_WIDE_ROWS,
                             sample=True).wide,
          "the deep UNAF's sampler plans the tiled tier")
    check(naf_fused.density_tile_rows("umnn", d_made, d_mono, 6, 0, dS, UNAF_WIDE_ROWS, 1) == 16,
          "the deep UNAF: its density's tile")
    ops.reset_launches()
    with torch.no_grad():
        ddist = unaf_deep(None)
        d_xs = ddist.sample((UNAF_WIDE_ROWS,), generator=gen)
        d_xl, d_lq = ddist.sample_and_log_prob((UNAF_WIDE_ROWS,), generator=gen)
        d_lp = ddist.log_prob(x_tiers[:4096])
    deep_launches = {name: count for name, count in ops.LAUNCHES.items() if count}
    print(f"deep UNAF served (samples through the wide tier, the density tiled): launches"
          f" {deep_launches}")
    check(deep_launches == {"naf_sample_umnn_wide": 1, "naf_sample_umnn_log_prob_wide": 1,
                            "naf_density_umnn": 1},
          f"deep UNAF launches {deep_launches}")
    check(all(bool(torch.isfinite(t).all()) for t in (d_xs, d_xl, d_lq, d_lp)),
          "deep UNAF: not finite")
    with torch.no_grad():
        hold_naf("deep UNAF (wide tier)", unaf_deep, ux_big[:4096], None,
                 torch.randn(UNAF_WIDE_ROWS, 6, generator=gen, device=dev), None, names=None)

    # at the training steps' shapes: K8's UMNN Function at (i)'s rows, K9's
    # UMNN mode with log q and the IFT backward at (j)'s
    uparams, ulayout, _, uS = naf_args(unaf_flagship, torch.float32)
    u64 = [p.double() for p in uparams]
    # the float64 reference in chunks of 16,384 rows: its graph holds 17
    # integrand evaluations a feature and layer
    hold_naf_density_grads("UNAF at (i)'s rows", "naf_density_umnn", uparams, u64, ulayout, uS,
                           batches[0], 1 << 14)
    hold_naf_ift("UNAF", "naf_sample_umnn_log_prob", uparams, u64, ulayout, uS,
                 torch.randn(UNAF_IFT_ROWS, 6, generator=gen, device=dev))

    # (i) on the samples the NSF serving phase drew, as (a), (e) and (g)
    flow_i = zt.load_params(zt.UNAF(6, 0, transforms=3, signal=16, device=dev),
                            ROOT / "zuko_tpu_torch" / "assets" / "unaf_flagship.npz")
    ops.reset_launches()
    init_fn, step_fns["unaf_mle"] = zt.make_mle_step(flow_i, lr=1e-3)
    trained["unaf_mle"], _ = run("(i) UNAF MLE", step_fns["unaf_mle"], init_fn(), batch,
                                 TRAIN_STEPS)
    counts = counts_after("(i) UNAF MLE", ["naf_density_umnn"],
                          none=(*served, *gf_served, *NAF_NAMES))
    check(counts["naf_density_umnn"] == TRAIN_STEPS, "(i): one naf_density_umnn launch a step")
    train_launches["naf_density_umnn"] = counts["naf_density_umnn"]

    flow_j = copy.deepcopy(unaf_flagship)
    ops.reset_launches()
    init_fn, step_fns["unaf_rkl"] = zt.make_reverse_kl_step(
        flow_j, ring, n_samples=UNAF_IFT_ROWS, lr=1e-3)
    trained["unaf_rkl"], _ = run("(j) UNAF reverse KL, IFT", step_fns["unaf_rkl"], init_fn(),
                                 generator, TRAIN_STEPS)
    counts = counts_after("(j) UNAF reverse KL, IFT", ["naf_sample_umnn_log_prob"],
                          none=(*served, *gf_served, *NAF_NAMES, *UMNN_NAMES[:2]))
    check(counts["naf_sample_umnn_log_prob"] == TRAIN_STEPS,
          "(j): one naf_sample_umnn_log_prob launch a step")
    train_launches["naf_sample_umnn_log_prob"] = counts["naf_sample_umnn_log_prob"]
    per_step.update({
        "unaf_mle": time_step("unaf_mle", batch, lambda: flow_i(None).log_prob(batches[0]).mean()),
        "unaf_rkl": time_step("unaf_rkl", generator, lambda: flow_j(None).sample_and_log_prob(
            (UNAF_IFT_ROWS,), gen)),
    })

    # times: the density at the serving rows and (i)'s, sampling at the
    # serving rows and (j)'s
    with torch.no_grad():
        for rows, names in ((UNAF_DENSITY_ROWS, UMNN_NAMES[:1]), (GRAD_ROWS, UMNN_NAMES[:1]),
                            (UNAF_SAMPLE_ROWS, UMNN_NAMES[1:]), (UNAF_IFT_ROWS, UMNN_NAMES[2:])):
            if (names[0], rows, "") in timed:
                continue
            work = naf_work_of(uparams, ulayout, 6, uS, ux_big[:rows],
                               torch.randn(rows, 6, generator=gen, device=dev), UMNN_NAMES)
            for name in names:
                time_kernel(name, rows, *work[name], runs=NAF_RUNS)
                check(timed[name, rows, ""]["bound_by"] == "operations", f"{name}: bound by bytes")
        unaf_requests = {
            "naf_density_umnn": (UNAF_DENSITY_ROWS, lambda: unaf_flagship(None).log_prob(ux_big)),
            "naf_sample_umnn": (UNAF_SAMPLE_ROWS, lambda: unaf_flagship(None).sample(
                (UNAF_SAMPLE_ROWS,), generator=gen)),
            "naf_sample_umnn_log_prob": (UNAF_SAMPLE_ROWS, lambda: unaf_flagship(
                None).sample_and_log_prob((UNAF_SAMPLE_ROWS,), generator=gen)),
        }
        for name, (rows, request) in unaf_requests.items():
            r_ms, r_runs = host_ms(request, NAF_RUNS)
            print(f"served request {name} at {rows} rows: {r_ms:.3f} ms {fmt(r_runs)},"
                  f" kernel share {timed[name, rows, '']['ms'] / r_ms:.3f}")
        # the tiled UMNN density at each tile: a tile of R rows is 17 R node
        # rows, in chunks of 256 (64: 4.25 chunks, 32: 2.125, 16: 1.0625)
        tile_rows = naf_fused.density_tile_rows
        x_tile = ux_big[:UNAF_DENSITY_ROWS]
        try:
            for R in (16, 32, 64):
                naf_fused.density_tile_rows = lambda *a, R=R: R
                t_ms, t_runs = time_ms(
                    lambda: naf_fused.naf_density(x_tile, uparams, ulayout, 6, uS), NAF_RUNS)
                print(f"naf_density_umnn at {UNAF_DENSITY_ROWS} rows, tiles of {R} rows:"
                      f" {t_ms:.3f} ms {fmt(t_runs)}")
        finally:
            naf_fused.density_tile_rows = tile_rows
    step_labels += (("unaf_mle", "(i) UNAF MLE"), ("unaf_rkl", "(j) UNAF reverse KL, IFT"))
    report_rows.update({"naf_density_umnn": UNAF_DENSITY_ROWS,
                        "naf_sample_umnn": UNAF_SAMPLE_ROWS,
                        "naf_sample_umnn_log_prob": UNAF_SAMPLE_ROWS})

    # the CNF's helpers (phases 12 and 13)
    def cnf_args(flow, c, dtype=torch.float32):
        """``(params, cfg)`` as the CNF wrappers take them, detached, in
        ``dtype`` (the exact trace)."""
        params, _, cfg = cnf_fused._flatten_cnf(flow, flow.transform(c), c)
        return [p.detach().to(dtype) for p in params], cfg

    def draws(shape):
        """The standard-normal draws the next sampling call of ``shape`` takes
        from ``gen`` (a copy of its state)."""
        copy_ = torch.Generator(device=dev)
        copy_.set_state(gen.get_state())
        return torch.randn(shape, generator=copy_, device=dev)

    def hold_cnf(label, flow, x, c, lp, zs, xs_k, zl, xl_k, lq_k, cz, names=None,
                 self_check=True):
        """Served CNF outputs against plain float64 at the same tiles: the
        density ``lp`` at the rows ``x`` (context rows ``c``), the samples
        ``xs_k`` (x alone) from the draws ``zs`` and ``xl_k``, ``lq_k``
        (with log q) from ``zl`` (context rows ``cz``), and with
        ``self_check`` log q against K10 at the returned points. The errors
        are noted under ``names`` (density, sample, sample with log q), if
        any."""
        params, cfg = cnf_args(flow, None if c is None else c[:1])
        p64 = [p.double() for p in params]

        def plain64(c_):
            return cnf_fused._kernel_params(p64[0::2], p64[1::2],
                                            None if c_ is None else c_.double(), cfg)

        with torch.no_grad():
            d = (lp.double() - cnf_fused._cnf_tile_math(x.double(), None, plain64(c), cfg)).abs()
            kz = plain64(cz)
            r_x = cnf_fused._cnf_tile_sample_math(zs.double(), None, kz, cfg, False)
            r_xl, r_lq = cnf_fused._cnf_tile_sample_math(zl.double(), None, kz, cfg, True)
        dx, dxl = (xs_k.double() - r_x).abs(), (xl_k.double() - r_xl).abs()
        dlq = (lq_k.double() - r_lq).abs()
        found = [("density", d), ("x vs plain f64", dx), ("x (with log q) vs plain f64", dxl),
                 ("log q vs plain f64", dlq)]
        if self_check:
            with torch.no_grad():
                found.append(("log q vs K10 at x", (lq_k - cnf_fused.cnf_density(
                    xl_k, None, params, cz, cfg)).abs()))
        for what, diff in found:
            print(f"{label} at {x.shape[0]} / {zs.shape[0]} rows, {what}: median %.3e q95 %.3e"
                  " q99 %.3e max %.3e" % quantiles(diff))
            check(bool(torch.isfinite(diff).all()), f"{label} {what}: not finite")
        for diff in (d, dlq):
            check(quantiles(diff)[0] <= TOL_CNF_MEDIAN and diff.max().item() <= TOL_CNF_MAX,
                  f"{label} density or log q vs plain")
        for diff in (dx, dxl):
            check(quantiles(diff)[0] <= TOL_SAMPLE_MEDIAN
                  and quantiles(diff)[2] <= TOL_CNF_SAMPLE_Q99, f"{label} samples vs plain")
        if self_check:
            check(quantiles(found[-1][1])[0] <= TOL_CNF_SELF, f"{label} log q vs K10")
        if names is not None:
            for name, diff in zip(names, (d, dx, dlq)):
                note_error(name, diff, x.shape[0] if name == names[0] else zs.shape[0])

    def cnf_work(params, cfg, x, c, z, cz, names=CNF_NAMES):
        """``names`` (density, sample, sample with log q) -> (kernel, plain,
        operations, bytes) of the CNF kernels at the rows ``x`` (context
        rows ``c``) and the draws ``z`` (context rows ``cz``): the operations
        of the attempts the plain float32 version takes on each tile (rows
        past the end excluded), each input read once (a context as its
        folded first bias), each weight once, each output written once."""
        kx = cnf_fused._kernel_params(params[0::2], params[1::2], c, cfg)
        kz = cnf_fused._kernel_params(params[0::2], params[1::2], cz, cfg)
        widths, F = cnf_fused._widths(kx), cfg["F"]
        weights = 4 * sum(p.numel() for p in params)

        def ops_of(rows, attempts, trace):
            tile = cnf_fused.TILE
            last = rows - (attempts.numel() - 1) * tile
            row_attempts = attempts[:-1].sum().item() * tile + attempts[-1].item() * last
            return row_attempts * cnf_ops(widths, cfg["nf"], trace)

        def bias_bytes(rows, c_):
            return 0 if c_ is None else 4 * rows * widths[1]

        with torch.no_grad():
            n, m = x.shape[0], z.shape[0]
            _, a_d = cnf_fused._cnf_tile_math(x, None, kx, cfg, counts=True)
            _, a_s = cnf_fused._cnf_tile_sample_math(z, None, kz, cfg, False, counts=True)
            _, a_l = cnf_fused._cnf_tile_sample_math(z, None, kz, cfg, True, counts=True)
        return {
            names[0]: (
                lambda: cnf_fused.cnf_density(x, None, params, c, cfg),
                lambda: cnf_fused._cnf_tile_math(x, None, kx, cfg),
                ops_of(n, a_d, True), 4 * n * (F + 1) + bias_bytes(n, c) + weights),
            names[1]: (
                lambda: cnf_fused.cnf_sample(z, None, params, cz, cfg),
                lambda: cnf_fused._cnf_tile_sample_math(z, None, kz, cfg, False),
                ops_of(m, a_s, None), 8 * m * F + bias_bytes(m, cz) + weights),
            names[2]: (
                lambda: cnf_fused.cnf_sample(z, None, params, cz, cfg, True),
                lambda: cnf_fused._cnf_tile_sample_math(z, None, kz, cfg, True),
                ops_of(m, a_l, True), 4 * m * (2 * F + 1) + bias_bytes(m, cz) + weights),
        }

    def cnf_grad_request(flow, c, shape, want_log_prob):
        """``rsample_and_log_prob`` (or ``rsample``) of ``flow(c)`` with a
        backward of ``mean(lq) + mean(|x|^2)`` (or ``mean(|x|^2)``): K11, then
        K12. A Hutchinson flow draws its probe's seed from ``gen``. Returns
        the loss and the parameters' gradients."""
        flow.zero_grad(set_to_none=True)
        dist = flow(c) if flow.transform.exact else flow(c, generator=gen)
        check(isinstance(dist, FusedContinuousFlow), "a CNF on the GPU did not dispatch")
        if want_log_prob:
            x, lq = dist.rsample_and_log_prob(shape, generator=gen)
            loss = lq.mean() + (x * x).sum(dim=-1).mean()
        else:
            loss = (dist.rsample(shape, generator=gen) ** 2).sum(dim=-1).mean()
        loss.backward()
        return loss.detach(), [p.grad for p in flow.parameters() if p.grad is not None]

    def hold_adjoint(label, flow, c, rows, names=ADJ_NAMES, generator=None):
        """K12 against its plain version in float64 at the same tiles, both
        modes (``names``: without and with the log-q cotangent), on the
        samples K11 draws from ``rows`` base draws (context rows ``c``) under
        the cotangents of ``mean(lq) + mean(|x|^2)``: after the gate of each,
        which must pass on every row, the parameters' cotangents max-relative
        <= TOL_CNF_GRAD_PARAMS, the draws' and the context rows' normwise <=
        TOL_CNF_GRAD_INPUT, the limits of K10's Function (float32 and
        float64 tiles may take different step sequences, and the adjoint's
        error control allows 1e-5 of each accumulator a step). A Hutchinson
        flow draws its probe's seed from ``generator`` (default ``gen``), as do
        the base draws, and both sides take the probe at the draws, as
        ``rsample_and_log_prob`` does. Returns
        ``names`` -> (kernel, plain, operations, bytes) at these inputs: the
        operations of the attempts the plain float32 version takes on each
        tile, each input and output once."""
        generator = gen if generator is None else generator
        c0 = None if c is None else c[:1]
        transform = flow.transform(c0) if flow.transform.exact else flow.transform(
            c0, generator=generator)
        params, probe, cfg = cnf_fused._flatten_cnf(flow, transform, c0)
        params = [p.detach() for p in params]
        F, C = cfg["F"], cfg["C"]
        z = torch.randn(rows, F, generator=generator, device=dev)
        eps = None if probe is None else probe(z)
        with torch.no_grad():
            x, _ = cnf_fused.cnf_sample(z, eps, params, c, cfg, True)
        gx, glq = 2 * x / rows, torch.full((rows,), 1.0 / rows, device=dev)
        p64 = [p.double() for p in params]
        c64 = None if c is None else c.double()
        kp32 = cnf_fused._kernel_params(params[0::2], params[1::2], c, cfg)
        kp64 = cnf_fused._kernel_params(p64[0::2], p64[1::2], c64, cfg)
        widths, tile = cnf_fused._widths(kp32), cnf_fused.TILE
        row_bias = c is not None and c.dim() == 2
        P = sum(p.numel() for i, p in enumerate(kp32) if not (i == 2 and row_bias))
        tiles = -(-rows // tile)
        work = {}
        for name, lq in zip(names, (None, glq)):
            e = None if lq is None else eps
            e64 = None if e is None else e.double()
            u1, a1, g = cnf_fused.cnf_adjoint(x, gx, lq, e, params, c, cfg)
            got = cnf_fused._cnf_bwd_finish(z, e, c, params, cfg, lq, u1, a1, g)
            with torch.no_grad():
                r_u, r_a, r_k = cnf_fused._cnf_tile_adjoint_math(
                    x.double(), gx.double(), None if lq is None else lq.double(), e64, kp64, cfg)
            want = cnf_fused._cnf_bwd_finish(
                z.double(), e64, c64, p64, cfg, None if lq is None else lq.double(), r_u, r_a,
                cnf_fused._flat_cotangents(r_k, p64, c64, cfg))
            gates = [(u - z.double()).abs().amax(dim=1).max().item() for u in (u1.double(), r_u)]
            inputs = [(got[0], want[0])] + ([(got[2], want[2])] if C else [])
            normwise = max(((a.double() - b).norm() / b.norm().clamp_min(1e-30)).item()
                           for a, b in inputs)
            relative = max(((a.double() - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                           for a, b in zip(got[3], want[3]))
            err = max((a.double() - b).abs().max().item()
                      for a, b in [*inputs, *zip(got[3], want[3])])
            print(f"{label} K12 {name} at {rows} rows vs plain f64: gate max |u1 - z| kernel"
                  f" {gates[0]:.3e} plain {gates[1]:.3e}; dz normwise {normwise:.3e},"
                  f" parameters worst max-relative {relative:.3e}, max |diff| {err:.3e}")
            check(all(bool(torch.isfinite(t).all()) for t in [got[0], *got[3]]),
                  f"{label} {name}: a gradient is not finite")
            check(max(gates) <= cnf_fused._REINT_ATOL, f"{label} {name}: the gate failed")
            check(normwise <= TOL_CNF_GRAD_INPUT, f"{label} {name}: dz or the context vs plain")
            check(relative <= TOL_CNF_GRAD_PARAMS, f"{label} {name}: parameters vs plain")
            note_error(name, torch.tensor(err), rows)
            with torch.no_grad():
                _, _, _, attempts = cnf_fused._cnf_tile_adjoint_math(x, gx, lq, e, kp32, cfg,
                                                                     counts=True)
            last = rows - (tiles - 1) * tile
            row_attempts = attempts[:-1].sum().item() * tile + attempts[-1].item() * last
            trace = None if lq is None else cfg["exact"]
            nbytes = 4 * (rows * (4 * F + (lq is not None) + (F if e is not None else 0)
                                  + (2 * widths[1] if row_bias else 0)) + P * (1 + tiles))
            work[name] = (
                lambda lq=lq, e=e: cnf_fused.cnf_adjoint(x, gx, lq, e, params, c, cfg),
                lambda lq=lq, e=e: cnf_fused._cnf_tile_adjoint_math(x, gx, lq, e, kp32, cfg),
                row_attempts * cnf_adjoint_ops(widths, trace), nbytes)
        return work

    # 12. repair: flows past the narrow tiers' limits, served through the
    # public API by the wide tier (and K5 past 32 bins, unfused), held against
    # plain float64 at their families' tolerances, each wide kernel timed
    # once at its configuration's shape. Built on the CPU from a seed and
    # moved to the card, so a CPU run makes the same weights. Scaled so that
    # float64 itself solves their draws and float32 can hold their values
    # (CPU runs in float64, these seeds): the new modes' parameters by 0.3
    # (flatter softmaxes, smaller coefficients: at full scale NCSF's 40 bins
    # leave float32 densities within 8e-5 of float64 at 16,384 rows); the MAF's by 0.3 (at
    # full scale 66 affine layers compound to densities of 1e10); the GFs'
    # by 0.1 (at 0.3 the 33 layers of GF(3, transforms=33) bring 17% of the
    # draws back to z, at 0.1 89%); the 72-feature NAF's monotone weights by
    # 3 (its small random networks cover too narrow a range: every row of
    # 72 features pegs somewhere, at 3 none does); the wide-network NAF and
    # UNAF's MADE and biases by 0.3 (at full scale a quarter of the NAF's
    # draws fail the fixed-step solve, and its float32 density sums 160
    # products of large terms: median error 8.8e-6 against 2.5e-6).
    wide_nsf = [
        ("NSF(6, hidden_features=(256, 256))", 0,
         built(lambda: zt.NSF(6, hidden_features=(256, 256), device="cpu"), 10), REPAIR_ROWS),
        ("NSF(5, 3, bins=40, hidden_features=(320, 320))", 3,
         built(lambda: zt.NSF(5, 3, bins=40, hidden_features=(320, 320), device="cpu"), 11),
         REPAIR_ROWS // 4),
        ("NSF(3, hidden_features=(16,) * 8)", 0,
         built(lambda: zt.NSF(3, hidden_features=(16,) * 8, device="cpu"), 12), REPAIR_ROWS),
        ("MAF(2, transforms=66)", 0,
         built(lambda: zt.MAF(2, transforms=66, device="cpu"), 13, damp=0.3), REPAIR_ROWS),
        # the new modes past their narrow limits: 40 bins; T = 8 * 16 + 1 =
        # 129 parameters a feature; M + 5 = 66 Bernstein coefficients
        ("NCSF(4, 2, bins=40)", 2,
         built(lambda: zt.NCSF(4, 2, bins=40, device="cpu"), 22, damp=0.3), REPAIR_ROWS // 4),
        ("SOSPF(4, polynomials=8, degree=15)", 0,
         built(lambda: zt.SOSPF(4, polynomials=8, degree=15, device="cpu"), 23, damp=0.3),
         REPAIR_ROWS // 4),
        ("BPF(4, degree=60)", 0, built(lambda: zt.BPF(4, degree=60, device="cpu"), 24, damp=0.3),
         REPAIR_ROWS // 4),
    ]
    spline48 = built(lambda: zt.NSF(4, bins=48, device="cpu"), 14)
    wide_gf = [
        ("GF(72, components=8)", built(lambda: zt.GF(72, components=8, device="cpu"), 15, 0.1),
         REPAIR_ROWS // 4),
        ("GF(4, components=40)", built(lambda: zt.GF(4, components=40, device="cpu"), 16, 0.1),
         REPAIR_ROWS),
        ("GF(3, transforms=33)", built(lambda: zt.GF(3, transforms=33, device="cpu"), 17, 0.1),
         REPAIR_ROWS),
    ]
    wide_naf = []
    for family, cls in (("NAF", zt.NAF), ("UNAF", zt.UNAF)):
        mono = 3.0 if cls is zt.NAF else 1.0
        wide_naf += [
            (f"{family}(72, transforms=1, signal=4, ...)", built(lambda: cls(
                72, transforms=1, signal=4, hidden_features=(32,),
                network={"hidden_features": (8,)}, device="cpu"), 18, mono=mono), REPAIR_ROWS // 4,
             REPAIR_ROWS // 256),
            (f"{family}(3, signal=72, ...)", built(lambda: cls(
                3, signal=72, hidden_features=(320,), network={"hidden_features": (160, 160)},
                device="cpu"), 19, damp=0.3), REPAIR_ROWS // 4, REPAIR_ROWS // 64),
        ]
    # the CNFs: 64 features (what zuko_tpu refuses at its VMEM gate), with a
    # context of rows, and hidden widths of 512
    wide_cnf = [
        ("CNF(64, 10)", built(lambda: zt.CNF(64, 10, exact=True, device="cpu"), 20), 10,
         REPAIR_ROWS // 64),
        ("CNF(3, hidden_features=(512, 512))",
         built(lambda: zt.CNF(3, hidden_features=(512, 512), device="cpu"), 21), 0,
         REPAIR_ROWS // 4),
    ]
    wide_names = [f"{name}_wide" for name in WHOLE_FLOW]

    ops.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        for label, C, flow, rows in wide_nsf:
            c = None if C == 0 else torch.randn(rows, C, generator=gen, device=dev)
            x = torch.randn(rows, flow.base._0.shape[0], generator=gen, device=dev)
            dist = flow(c)
            check(isinstance(dist, FusedAutoregressiveFlow), f"{label} did not dispatch")
            outs = [dist.log_prob(x), dist.sample(generator=gen), *dist.sample_and_log_prob(
                generator=gen)] if C else [dist.log_prob(x), dist.sample((rows,), generator=gen),
                                          *dist.sample_and_log_prob((rows,), generator=gen)]
            inverted_wide = Flow(flow.transform.inv, flow.base)(c)
            check(isinstance(inverted_wide, FusedInvertedAutoregressiveFlow),
                  f"inverted {label} did not dispatch")
            y = inverted_wide.sample(() if C else (rows,), generator=gen)
            outs += [y, inverted_wide.log_prob(y)]
            check(all(bool(torch.isfinite(t).all()) for t in outs), f"{label}: not finite")
        for label, flow, rows in wide_gf:
            dist = flow(None)
            check(isinstance(dist, FusedGaussianizationFlow), f"{label} did not dispatch")
            x = torch.randn(rows, flow.base._0.shape[0], generator=gen, device=dev)
            outs = [dist.log_prob(x), dist.sample((rows,), generator=gen),
                    *dist.sample_and_log_prob((rows,), generator=gen)]
            check(all(bool(torch.isfinite(t).all()) for t in outs), f"{label}: not finite")
        for label, flow, rows, sample_rows in wide_naf:
            dist = flow(None)
            check(isinstance(dist, FusedNeuralSamplingFlow), f"{label} did not dispatch")
            x = torch.randn(rows, flow.base._0.shape[0], generator=gen, device=dev)
            outs = [dist.log_prob(x), dist.sample((sample_rows,), generator=gen),
                    *dist.sample_and_log_prob((sample_rows,), generator=gen)]
            check(all(bool(torch.isfinite(t).all()) for t in outs), f"{label}: not finite")
        cnf_served = []
        for label, flow, C, rows in wide_cnf:
            F = flow.base._0.shape[0]
            c = torch.randn(rows, C, generator=gen, device=dev) if C else None
            x = torch.randn(rows, F, generator=gen, device=dev)
            dist = flow(c)
            check(isinstance(dist, FusedContinuousFlow), f"{label} did not dispatch")
            shape = () if C else (rows,)
            lp = dist.log_prob(x)
            z1 = draws((rows, F))
            xs_ = dist.sample(shape, generator=gen)
            z2 = draws((rows, F))
            xl_, lq_ = dist.sample_and_log_prob(shape, generator=gen)
            check(all(bool(torch.isfinite(t).all()) for t in (lp, xs_, xl_, lq_)),
                  f"{label}: not finite")
            cnf_served.append((label, flow, c, x, lp, z1, xs_, z2, xl_, lq_))
    before = os.environ.get("ZUKO_TPU_TORCH_FUSED_DISPATCH")
    os.environ["ZUKO_TPU_TORCH_FUSED_DISPATCH"] = "0"
    try:
        with torch.no_grad():
            x48 = torch.randn(REPAIR_ROWS // 4, 4, generator=gen, device=dev)
            outs = [spline48(None).log_prob(x48),
                    spline48(None).sample((REPAIR_ROWS // 4,), generator=gen)]
            check(all(bool(torch.isfinite(t).all()) for t in outs), "NSF(4, bins=48): not finite")
    finally:
        if before is None:
            del os.environ["ZUKO_TPU_TORCH_FUSED_DISPATCH"]
        else:
            os.environ["ZUKO_TPU_TORCH_FUSED_DISPATCH"] = before
    # K12's wide tier: the wide CNFs' rsample and rsample_and_log_prob with
    # a backward, at K12_WIDE_ROWS draws
    for label, flow, C, rows in wide_cnf:
        c = torch.randn(K12_WIDE_ROWS, C, generator=gen, device=dev) if C else None
        for want in (False, True):
            loss, grads = cnf_grad_request(flow, c, () if C else (K12_WIDE_ROWS,), want)
            check(math.isfinite(loss.item()) and all(bool(torch.isfinite(g).all()) for g in grads),
                  f"{label}: a gradient through K12 is not finite")
    torch.cuda.synchronize()
    repair_launches = {name: ops.LAUNCHES[name] for name in (*wide_names, "rqs_forward",
                                                             "rqs_inverse")}
    print(f"repair phase: {time.perf_counter() - t0:.3f} s, launches {repair_launches}")
    for name, count in repair_launches.items():
        check(count > 0, f"repair phase: {name} was not launched")
    check(all(ops.LAUNCHES[name] == 0 for name in WHOLE_FLOW),
          "repair phase: a narrow tier was launched")

    # the per-thread narrow polynomial sampler (nsf_sample_kernel<false, mode,
    # kPolynomial>), which no flagship reaches since the sum of squares
    # samples through the tiled tier: a SOSPF and a BPF past the tiled
    # sampler's 24 coefficients in registers (30 and 36), parameters x 0.3,
    # served at REPAIR_ROWS // 4 rows, their sampler, density and apply
    # planned narrow and untiled, held against plain float64 at their
    # family's limits and timed
    # once; counted under the sampler's names in the served run, reported in the
    # kernels line as <name>_thread; draws from a generator of their own
    with torch.random.fork_rng(devices=[dev]):
        thread_flows = [
            ("SOSPF(4, polynomials=6, degree=4)", built(
                lambda: zt.SOSPF(4, polynomials=6, degree=4, device="cpu"), 25, damp=0.3)),
            ("BPF(4, degree=30)", built(lambda: zt.BPF(4, degree=30, device="cpu"), 26,
                                        damp=0.3)),
        ]
    gen_thread = torch.Generator(device=dev).manual_seed(25)
    thread_rows = REPAIR_ROWS // 4
    thread_launches = {}
    for label, flow in thread_flows:
        params, layout, st = plain_args(flow, torch.float32)
        F, base = st[0], st[5]
        names = {k: nsf_fused._counter(k, st[4]) for k in NSF_KINDS}
        plan = nsf_plan(params, layout, st, thread_rows)
        check(plan == _common.narrow_plan(thread_rows),
              f"{label}: the per-thread narrow sampler, {plan}")
        # past the registers the density and apply are per-thread too
        plan = nsf_plan(params, layout, st, thread_rows, sample=False)
        check(plan == _common.narrow_plan(thread_rows),
              f"{label}: the per-thread narrow density, {plan}")
        x = torch.randn(thread_rows, F, generator=gen_thread, device=dev)
        ops.reset_launches()
        with torch.no_grad():
            dist = flow(None)
            outs = [dist.log_prob(x), dist.sample((thread_rows,), generator=gen_thread),
                    *dist.sample_and_log_prob((thread_rows,), generator=gen_thread)]
            inverted = Flow(flow.transform.inv, flow.base)(None)
            y = inverted.sample((thread_rows,), generator=gen_thread)
            outs += [y, inverted.log_prob(y)]
        torch.cuda.synchronize()
        served = {k: v for k, v in ops.LAUNCHES.items() if v}
        print(f"{label} served at {thread_rows} rows: launches {served}")
        check(isinstance(dist, FusedDensityFlow), f"{label} did not dispatch")
        check(all(bool(torch.isfinite(t).all()) for t in outs), f"{label}: not finite")
        check(served == {names["nsf_density"]: 1, names["nsf_apply"]: 1, names["nsf_sample"]: 1,
                         names["nsf_sample_log_prob"]: 1, names["nsf_sample_raw"]: 1},
              f"{label}: served launches {served}")
        ops.reset_launches()
        hold_nsf(label, flow, x, base_draws(thread_rows, F, base, gen_thread), "_thread")
        held = {k: v for k, v in ops.LAUNCHES.items() if v}
        check(all(held.get(names[k], 0) > 0 for k in NSF_KINDS[2:])
              and not any(k.endswith("_wide") for k in held),
              f"{label}: the held samplers' launches {held}")
        for kind in NSF_KINDS[2:]:
            thread_launches[f"{names[kind]}_thread"] = served.get(names[kind], 0)
        work = nsf_work(params, layout, st, x, base_draws(thread_rows, F, base, gen_thread))
        with torch.no_grad():
            for kind in NSF_KINDS[2:]:
                time_kernel(f"{names[kind]}_thread", thread_rows, *work[names[kind]], runs=3,
                            plain_runs=1)
                report_rows[f"{names[kind]}_thread"] = thread_rows

    # the per-row narrow GF sampler (gf_sample_kernel<false, log q>), which no
    # flagship reaches since K7's tiled tier: a GF past the tiled sampler's
    # 16 components in registers (24), parameters x 0.1 as the other GFs of
    # this phase, its sampler planned narrow and untiled, served at
    # REPAIR_ROWS rows, held against plain float64 in both modes at phase
    # 9's limits and timed once; counted under the sampler's names in the
    # served run, reported in the kernels line as <name>_thread; draws from a
    # generator of their own
    def hold_gf_per_row():
        with torch.random.fork_rng(devices=[dev]):
            gf24 = built(lambda: zt.GF(4, components=24, device="cpu"), 27, 0.1)
        label, rows = "GF(4, components=24)", REPAIR_ROWS
        gen_gf24 = torch.Generator(device=dev).manual_seed(27)
        params, layout, F = gf_args(gf24, None, rows, torch.float32)
        plan = gf_fused.plan_gf(layout, F, rows, sample=True)
        check(plan == _common.narrow_plan(rows), f"{label}: the per-row narrow sampler, {plan}")
        x = torch.randn(rows, F, generator=gen_gf24, device=dev)
        ops.reset_launches()
        with torch.no_grad():
            dist = gf24(None)
            outs = [dist.log_prob(x), dist.sample((rows,), generator=gen_gf24),
                    *dist.sample_and_log_prob((rows,), generator=gen_gf24)]
        torch.cuda.synchronize()
        served = {k: v for k, v in ops.LAUNCHES.items() if v}
        print(f"{label} served at {rows} rows: launches {served}")
        check(isinstance(dist, FusedGaussianizationFlow), f"{label} did not dispatch")
        check(all(bool(torch.isfinite(t).all()) for t in outs), f"{label}: not finite")
        check(served == {name: 1 for name in GF_NAMES}, f"{label}: served launches {served}")
        thread_launches.update({f"{name}_thread": served.get(name, 0) for name in GF_NAMES[1:]})
        with torch.no_grad():
            ops.reset_launches()
            hold_gf(label, gf24, None, rows, x,
                    names=(None, *(f"{name}_thread" for name in GF_NAMES[1:])), generator=gen_gf24)
            held = {k: v for k, v in ops.LAUNCHES.items() if v}
            check(held.get("gf_sample", 0) > 0 and held.get("gf_sample_log_prob", 0) > 0
                  and not any(k.endswith("_wide") for k in held),
                  f"{label}: the held sampler's launches {held}")
            work = gf_work(params, layout, F, rows, x, generator=gen_gf24)
            for name in GF_NAMES[1:]:
                time_kernel(f"{name}_thread", rows, *work[name], runs=3, plain_runs=1)
                report_rows[f"{name}_thread"] = rows

    hold_gf_per_row()

    # each configuration held against plain float64, and each wide kernel
    # timed once, at the first configuration that drives it
    def hold_nsf_wide(label, flow, C, rows):
        params, layout, st = plain_args(flow, torch.float32)
        F, base = st[0], st[5]
        xc = torch.randn(rows, F + C, generator=gen, device=dev)
        zc = torch.cat([base_draws(rows, F, base), xc[:, F:]], dim=1)
        hold_nsf(label, flow, xc, zc, "_wide")
        return nsf_work(params, layout, st, xc, base_draws(rows, F, base))

    def time_wide(rows, work):
        """Time the wide kernels of ``work`` not timed yet, once each."""
        for name, item in work.items():
            name = f"{name}_wide"
            if name not in report_rows:
                time_kernel(name, rows, *item, runs=1)
                report_rows[name] = rows

    for label, C, flow, rows in wide_nsf:
        time_wide(rows, hold_nsf_wide(label, flow, C, rows))
    with torch.no_grad():
        for label, flow, rows in wide_gf:
            width = flow.base._0.shape[0]
            x = torch.randn(rows, width, generator=gen, device=dev)
            params, layout, F = hold_gf(label, flow, None, rows, x,
                                        names=tuple(f"{n}_wide" for n in GF_NAMES))
            time_wide(rows, gf_work(params, layout, F, rows, x))
        for label, flow, rows, sample_rows in wide_naf:
            params, layout, F, S = naf_args(flow, torch.float32)
            names = UMNN_NAMES if layout[0][4] == "umnn" else NAF_NAMES
            x = torch.randn(rows, F, generator=gen, device=dev)
            z = torch.randn(sample_rows, F, generator=gen, device=dev)
            hold_naf(label, flow, x, None, z, None, names=tuple(f"{n}_wide" for n in names))
            work = naf_work_of(params, layout, F, S, x, z, names)
            time_wide(rows, {names[0]: work[names[0]]})
            time_wide(sample_rows, {n: work[n] for n in names[1:]})
        # K5 past 32 bins, held against its plain version in float64
        K = 48
        spline = MonotonicRQSTransform(
            torch.randn(REPAIR_ROWS // 4, 4, K, generator=gen, device=dev),
            torch.randn(REPAIR_ROWS // 4, 4, K, generator=gen, device=dev),
            torch.randn(REPAIR_ROWS // 4, 4, K - 1, generator=gen, device=dev),
        )
        knots = (spline.horizontal, spline.vertical, spline.derivatives)
        x_rqs48 = 3 * torch.randn(REPAIR_ROWS // 4, 4, generator=gen, device=dev)
        for name, fn, inverse in (("rqs_forward", rqs.rqs_forward, False),
                                  ("rqs_inverse", rqs.rqs_inverse, True)):
            k_y, k_l = fn(x_rqs48, *knots)
            r_y, r_l = rqs._math_nd(x_rqs48.double(), *(k.double() for k in knots), inverse)
            dy, dl = (k_y.double() - r_y).abs(), (k_l.double() - r_l).abs()
            print(f"{name} at {K} bins ({x_rqs48.numel()} elements) vs plain f64: y max"
                  f" {dy.max().item():.3e} median {dy.median().item():.3e}, ladj max"
                  f" {dl.max().item():.3e}")
            if inverse:
                check_samples(f"{name} at {K} bins vs plain", dy)
                check(dl.max().item() <= TOL_SAMPLE_MAX, f"{name} at {K} bins ladj vs plain")
            else:
                check(max(dy.max().item(), dl.max().item()) <= TOL_DENSITY,
                      f"{name} at {K} bins vs plain")
            m48 = x_rqs48.numel()
            time_kernel(name, x_rqs48.shape[0], lambda: fn(x_rqs48, *knots),
                        lambda: rqs._math_nd(x_rqs48, *knots, inverse), m48 * rqs_ops(K),
                        4 * m48 * (1 + 3 * (K + 1) + 2), note=f"{K} bins ({m48} elements)",
                        runs=PER_OP_RUNS)
    # the CNFs held on their served outputs; the wide kernels timed at the
    # first (at 16,384 rows of width 512 a tile takes seconds)
    for i, (label, flow, c, x, lp, z1, xs_, z2, xl_, lq_) in enumerate(cnf_served):
        names = tuple(f"{n}_wide" for n in CNF_NAMES) if i == 0 else None
        hold_cnf(label, flow, x, c, lp, z1, xs_, z2, xl_, lq_, c, names, self_check=False)
        if i == 0:
            params, cfg = cnf_args(flow, c)
            with torch.no_grad():
                time_wide(x.shape[0], cnf_work(params, cfg, x, c, z2, c))
    # K12's wide tier held on both wide CNFs and timed once on each (the
    # kernels line reports the first)
    for i, (label, flow, C, rows) in enumerate(wide_cnf):
        c = torch.randn(K12_WIDE_ROWS, C, generator=gen, device=dev) if C else None
        work = hold_adjoint(label, flow, c, K12_WIDE_ROWS,
                            names=tuple(f"{n}_wide" for n in ADJ_NAMES))
        if i == 0:
            time_wide(K12_WIDE_ROWS, {n: work[f"{n}_wide"] for n in ADJ_NAMES})
        else:
            for name, item in work.items():
                time_kernel(name, K12_WIDE_ROWS, *item, note=label, runs=1)
    check(set(report_rows) >= set(wide_names), "a wide kernel was not timed")

    # 13. the continuous normalizing flow (CNF): K10 and K11 served, held
    # against float64 truth and plain float64, K10's Function at (k)'s rows,
    # (k) trained, timed
    t13 = time.perf_counter()
    cnf_flagship = zt.load_params(zt.CNF(6, device=dev),
                                  ROOT / "zuko_tpu_torch" / "assets" / "cnf_flagship.npz")
    ctruth = np.load(ROOT / "zuko_tpu_torch" / "assets" / "cnf_truth_f64.npz")
    torch.manual_seed(7)
    cnf_cond = zt.CNF(6, 4, device=dev)
    cnf_hutch = zt.CNF(6, 4, exact=False, device=dev)
    n_ctruth = ctruth["x"].shape[0]
    # one request holds the truth rows first
    cx_big = torch.cat([torch.as_tensor(ctruth["x"], device=dev, dtype=torch.float32),
                        x_big[: CNF_ROWS - n_ctruth]])
    cc_big = torch.randn(CNF_ROWS, 4, generator=gen, device=dev)
    cc_few = torch.randn(1024, 4, generator=gen, device=dev)

    ops.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        cdist = cnf_flagship(None)
        c_lp = cdist.log_prob(cx_big)
        c_zs = draws((CNF_SAMPLE_ROWS, 6))
        c_xs = cdist.sample((CNF_SAMPLE_ROWS,), generator=gen)
        c_zl = draws((CNF_SAMPLE_ROWS, 6))
        c_xl, c_lq = cdist.sample_and_log_prob((CNF_SAMPLE_ROWS,), generator=gen)
        ccdist = cnf_cond(cc_big)
        cc_lp = ccdist.log_prob(x_big[:CNF_ROWS])
        ccfew = cnf_cond(cc_few)
        cc_zs = draws((4, 1024, 6))
        cc_xs = ccfew.sample((4,), generator=gen)
        cc_zl = draws((4, 1024, 6))
        cc_xl, cc_lq = ccfew.sample_and_log_prob((4,), generator=gen)
    torch.cuda.synchronize()
    cnf_launches = {name: ops.LAUNCHES[name] for name in CNF_NAMES}
    print(f"CNF serving phase: {time.perf_counter() - t0:.3f} s, launches {cnf_launches}")
    check(all(isinstance(d, FusedContinuousFlow) for d in (cdist, ccdist, ccfew)),
          "CNFs on the GPU did not dispatch to the fused kernels")
    check(cnf_launches == dict(zip(CNF_NAMES, (2, 2, 2))), f"CNF serving launches {cnf_launches}")
    check(all(count == 0 for name, count in ops.LAUNCHES.items() if name not in CNF_NAMES),
          "the CNF path launched another kernel")
    for t, shape in [
        (c_lp, (CNF_ROWS,)), (c_xs, (CNF_SAMPLE_ROWS, 6)), (c_xl, (CNF_SAMPLE_ROWS, 6)),
        (c_lq, (CNF_SAMPLE_ROWS,)), (cc_lp, (CNF_ROWS,)), (cc_xs, (4, 1024, 6)),
        (cc_xl, (4, 1024, 6)), (cc_lq, (4, 1024)),
    ]:
        check(tuple(t.shape) == shape, f"CNF shape {tuple(t.shape)} != {shape}")
        check(bool(torch.isfinite(t).all()), "non-finite values on the served CNF path")

    # against the float64 truth: the density of the truth rows as served,
    # and K11 from the truth's base draws
    cparams, ccfg = cnf_args(cnf_flagship, None)
    err = (c_lp[:n_ctruth].double() - torch.as_tensor(ctruth["lp"], device=dev)).abs()
    print(f"CNF log_prob vs f64 truth ({n_ctruth} rows): median %.3e q95 %.3e q99 %.3e"
          " max %.3e" % quantiles(err))
    check(err.median().item() <= TOL_CNF_MEDIAN and err.max().item() <= TOL_CNF_MAX,
          "CNF density vs f64 truth")
    with torch.no_grad():
        z_truth = torch.as_tensor(ctruth["z"], device=dev, dtype=torch.float32)
        t_x, t_lq = cnf_fused.cnf_sample(z_truth, None, cparams, None, ccfg, True)
    dx = (t_x.double() - torch.as_tensor(ctruth["x_sample"], device=dev)).abs()
    dlq = (t_lq.double() - torch.as_tensor(ctruth["lq"], device=dev)).abs()
    print(f"CNF sample vs f64 truth ({dx.shape[0]} draws): x median %.3e q95 %.3e q99 %.3e"
          " max %.3e;" % quantiles(dx), "log q median %.3e q95 %.3e q99 %.3e max %.3e"
          % quantiles(dlq))
    check(quantiles(dx)[2] <= TOL_CNF_SAMPLE_Q99, "CNF samples vs f64 truth")
    check(dlq.median().item() <= TOL_CNF_MEDIAN and dlq.max().item() <= TOL_CNF_MAX,
          "CNF log q vs f64 truth")

    # against plain float64 at the same tiles, the served outputs
    hold_cnf("CNF", cnf_flagship, cx_big, None, c_lp, c_zs, c_xs, c_zl, c_xl, c_lq, None,
             names=CNF_NAMES)
    hold_cnf("conditional CNF", cnf_cond, x_big[:CNF_ROWS], cc_big, cc_lp,
             cc_zs.reshape(-1, 6), cc_xs.reshape(-1, 6), cc_zl.reshape(-1, 6),
             cc_xl.reshape(-1, 6), cc_lq.reshape(-1), cc_few.repeat(4, 1))

    # K10's cluster tier (its narrow tier since it was redesigned): planned
    # as a cluster a tile; against plain float64 at the same tiles and
    # against the wide tier on the same rows (the same tiles and sums: the
    # difference is printed, with whether it is bit for bit): the flagship
    # at the serving rows (the truth's rows first), the conditional CNF(6, 4)
    # with a first bias a row, a Hutchinson CNF, a ragged tile, a last tile
    # of one valid row; one cluster launch each; draws from a generator of
    # their own
    gen_k10 = torch.Generator(device=dev).manual_seed(14)
    t_k10 = time.perf_counter()
    hparams, _, hcfg = cnf_fused._flatten_cnf(
        cnf_hutch, cnf_hutch.transform(cc_big[:1], generator=gen_k10), cc_big[:1])
    hparams = [p.detach() for p in hparams]
    kcparams, kccfg = cnf_args(cnf_cond, cc_big[:1])
    k10_cases = [
        ("CNF", cparams, ccfg, cx_big, None, None),
        ("conditional CNF", kcparams, kccfg, x_big[:CNF_ROWS], cc_big, None),
        ("Hutchinson CNF", hparams, hcfg, x_big[:CNF_TRAIN_ROWS], cc_big[:CNF_TRAIN_ROWS],
         torch.randn(CNF_TRAIN_ROWS, 6, generator=gen_k10, device=dev)),
        ("CNF, ragged", cparams, ccfg,
         torch.randn(CNF_TRAIN_ROWS - 37, 6, generator=gen_k10, device=dev), None, None),
        ("CNF, one row in the last tile", cparams, ccfg,
         torch.randn(16 * cnf_fused.TILE + 1, 6, generator=gen_k10, device=dev), None, None),
    ]
    for label, params, cfg, x, c, eps in k10_cases:
        kx = cnf_fused._kernel_params(params[0::2], params[1::2], c, cfg)
        plan = cnf_fused.plan_cnf(cnf_fused._widths(kx), cfg["nf"], x.shape[0],
                                  exact=cfg["exact"])
        check(not plan.wide and plan.cluster * plan.block_rows == cnf_fused.TILE,
              f"{label}: K10 planned as a cluster a tile, {plan}")
        ops.reset_launches()
        with torch.no_grad():
            lp = cnf_fused.cnf_density(x, eps, params, c, cfg)
            launched = {k: v for k, v in ops.LAUNCHES.items() if v}
            fits = cnf_fused._fits_narrow
            cnf_fused._fits_narrow = lambda widths, nf: False
            try:
                lp_wide = cnf_fused.cnf_density(x, eps, params, c, cfg)
            finally:
                cnf_fused._fits_narrow = fits
            p64 = [p.double() for p in params]
            k64 = cnf_fused._kernel_params(p64[0::2], p64[1::2],
                                           None if c is None else c.double(), cfg)
            r_lp = cnf_fused._cnf_tile_math(x.double(), None if eps is None else eps.double(),
                                            k64, cfg)
        check(launched == {"cnf_density": 1}, f"{label}: one cluster launch, {launched}")
        d, dw = (lp.double() - r_lp).abs(), (lp - lp_wide).abs()
        print(f"{label} K10 cluster tier ({plan.cluster} blocks of {plan.block_rows} rows,"
              f" {plan.columns} tangent columns a pass, {plan.shared_bytes} B) at {x.shape[0]}"
              " rows: vs plain f64 median %.3e q95 %.3e q99 %.3e max %.3e" % quantiles(d)
              + f"; vs wide tier max {dw.max().item():.3e}, bit for bit"
              f" {bool(torch.equal(lp, lp_wide))}")
        for diff in (d, dw):
            check(bool(torch.isfinite(diff).all()) and quantiles(diff)[0] <= TOL_CNF_MEDIAN
                  and diff.max().item() <= TOL_CNF_MAX, f"{label} K10 cluster tier")
        note_error("cnf_density", d, CNF_ROWS)
    print(f"K10 cluster tier checks: {time.perf_counter() - t_k10:.1f} s")

    # K11's cluster tier (its narrow tier since it was redesigned), the same
    # way: the cases of K10's, base draws in place of the rows, and (l)'s
    # 16,384 draws; without log q and with it, each one cluster launch
    # against the wide tier on the same draws (printed, with whether it is
    # bit for bit) and against plain float64 at the same tiles
    t_k11 = time.perf_counter()
    k11_cases = k10_cases + [
        ("CNF at (l)'s draws", cparams, ccfg,
         torch.randn(CNF_RKL_ROWS, 6, generator=gen_k10, device=dev), None, None)]
    for label, params, cfg, z, c, eps in k11_cases:
        kz = cnf_fused._kernel_params(params[0::2], params[1::2], c, cfg)
        p64 = [p.double() for p in params]
        k64 = cnf_fused._kernel_params(p64[0::2], p64[1::2], None if c is None else c.double(),
                                       cfg)
        for want, name in ((False, "cnf_sample"), (True, "cnf_sample_log_prob")):
            plan = cnf_fused.plan_cnf(cnf_fused._widths(kz), cfg["nf"], z.shape[0],
                                      exact=cfg["exact"] if want else None)
            check(not plan.wide and plan.cluster * plan.block_rows == cnf_fused.TILE,
                  f"{label}: K11 planned as a cluster a tile, {plan}")
            ops.reset_launches()
            with torch.no_grad():
                got = cnf_fused.cnf_sample(z, eps, params, c, cfg, want)
                launched = {k: v for k, v in ops.LAUNCHES.items() if v}
                fits = cnf_fused._fits_narrow
                cnf_fused._fits_narrow = lambda widths, nf: False
                try:
                    wide = cnf_fused.cnf_sample(z, eps, params, c, cfg, want)
                finally:
                    cnf_fused._fits_narrow = fits
                ref = cnf_fused._cnf_tile_sample_math(
                    z.double(), None if eps is None else eps.double(), k64, cfg, want)
            check(launched == {name: 1}, f"{label}: one {name} cluster launch, {launched}")
            got, wide, ref = ((t if want else (t,)) for t in (got, wide, ref))
            dx, dxw = (got[0].double() - ref[0]).abs(), (got[0] - wide[0]).abs()
            med, _, q99, worst = quantiles(dx)
            line = (f"{label} K11 cluster tier, log q {want} ({plan.cluster} blocks of"
                    f" {plan.block_rows} rows, {plan.shared_bytes} B) at {z.shape[0]} draws: x vs"
                    f" plain f64 median {med:.3e} q99 {q99:.3e} max {worst:.3e}; x vs wide tier"
                    f" max {dxw.max().item():.3e}")
            for diff in (dx, dxw):
                check(bool(torch.isfinite(diff).all()) and quantiles(diff)[0] <= TOL_SAMPLE_MEDIAN
                      and quantiles(diff)[2] <= TOL_CNF_SAMPLE_Q99, f"{label} K11 cluster tier x")
            if want:
                dl, dlw = (got[1].double() - ref[1]).abs(), (got[1] - wide[1]).abs()
                line += (f"; log q vs plain f64 median {quantiles(dl)[0]:.3e} max"
                         f" {dl.max().item():.3e}, vs wide tier max {dlw.max().item():.3e}")
                for diff in (dl, dlw):
                    check(bool(torch.isfinite(diff).all()) and quantiles(diff)[0] <= TOL_CNF_MEDIAN
                          and diff.max().item() <= TOL_CNF_MAX, f"{label} K11 cluster tier log q")
            print(line + f"; bit for bit the wide tier's:"
                  f" {all(torch.equal(a, b) for a, b in zip(got, wide))}")
    print(f"K11 cluster tier checks: {time.perf_counter() - t_k11:.1f} s")

    # K10's Function at (k)'s parameters and rows (the NSF's samples): the
    # kernel forward, the float32 gradient of the global-step integration,
    # against its float64 gradient; a loss of means
    cnf_batches = xs.split(CNF_TRAIN_ROWS)
    xg = cnf_batches[0]
    ps32 = [p.clone().requires_grad_(True) for p in cparams]
    x32 = xg.clone().requires_grad_(True)
    lp32 = cnf_fused.cnf_density(x32, None, ps32, None, ccfg)
    lp32.mean().backward()
    ps64 = [p.double().requires_grad_(True) for p in cparams]
    x64 = xg.double().requires_grad_(True)
    lp64 = cnf_fused._ref_log_prob(x64, None, ps64[0::2], ps64[1::2], None, ccfg)
    lp64.mean().backward()
    print("CNF at (k)'s rows, K10 vs the global-step integration in float64: median %.3e"
          " q95 %.3e q99 %.3e max %.3e" % quantiles((lp32.detach().double() - lp64.detach()).abs()))
    compare_grads("CNF at (k)'s rows", [x32.grad] + [p.grad for p in ps32],
                  [x64.grad] + [p.grad for p in ps64], tol_input=TOL_CNF_GRAD_INPUT,
                  tol_params=TOL_CNF_GRAD_PARAMS)
    del lp64, ps64, x64

    # (k) on the samples the NSF serving phase drew, as (a), (e), (g), (i)
    flow_k = zt.load_params(zt.CNF(6, device=dev),
                            ROOT / "zuko_tpu_torch" / "assets" / "cnf_flagship.npz")
    cnf_batch = lambda i: (cnf_batches[i % len(cnf_batches)],)  # noqa: E731
    ops.reset_launches()
    init_fn, step_fns["cnf_mle"] = zt.make_mle_step(flow_k, lr=1e-3)
    trained["cnf_mle"], _ = run("(k) CNF MLE", step_fns["cnf_mle"], init_fn(), cnf_batch,
                                TRAIN_STEPS)
    counts = counts_after("(k) CNF MLE", ["cnf_density"],
                          none=(*served, *gf_served, *NAF_NAMES, *UMNN_NAMES, *CNF_NAMES[1:]))
    check(counts["cnf_density"] == TRAIN_STEPS, "(k): one cnf_density launch a step")
    train_launches["cnf_density"] = counts["cnf_density"]
    per_step["cnf_mle"] = time_step(
        "cnf_mle", cnf_batch, lambda: flow_k(None).log_prob(cnf_batches[0]).mean())

    # times: K10 at the serving rows and (k)'s, K11 with and without log q
    # at the serving rows; the served requests around them
    with torch.no_grad():
        work = cnf_work(cparams, ccfg, cx_big, None,
                        torch.randn(CNF_SAMPLE_ROWS, 6, generator=gen, device=dev), None)
        for name in CNF_NAMES:
            rows = CNF_ROWS if name == "cnf_density" else CNF_SAMPLE_ROWS
            time_kernel(name, rows, *work[name])
            check(timed[name, rows, ""]["bound_by"] == "operations", f"{name}: bound by bytes")
        time_kernel("cnf_density", CNF_TRAIN_ROWS, *cnf_work(
            cparams, ccfg, xg, None, xg, None)["cnf_density"])
        cnf_requests = {
            "cnf_density": (CNF_ROWS, lambda: cnf_flagship(None).log_prob(cx_big)),
            "cnf_sample": (CNF_SAMPLE_ROWS, lambda: cnf_flagship(None).sample(
                (CNF_SAMPLE_ROWS,), generator=gen)),
            "cnf_sample_log_prob": (CNF_SAMPLE_ROWS, lambda: cnf_flagship(None).sample_and_log_prob(
                (CNF_SAMPLE_ROWS,), generator=gen)),
        }
        for name, (rows, request) in cnf_requests.items():
            r_ms, r_runs = host_ms(request, 3)
            print(f"served request {name} at {rows} rows: {r_ms:.3f} ms {fmt(r_runs)},"
                  f" kernel share {timed[name, rows, '']['ms'] / r_ms:.3f}")
    step_labels += (("cnf_mle", "(k) CNF MLE"),)
    report_rows.update({"cnf_density": CNF_ROWS, "cnf_sample": CNF_SAMPLE_ROWS,
                        "cnf_sample_log_prob": CNF_SAMPLE_ROWS})
    print(f"CNF phase: {time.perf_counter() - t13:.1f} s")

    # 14. CNF sampling with gradients: K11 forward, K12 (the continuous
    # adjoint) backward. Served with a gradient, K12 held against plain
    # float64 at the same rows, (l) trained, timed
    t14 = time.perf_counter()
    cc_grad = torch.randn(1024, 4, generator=gen, device=dev)
    grad_requests = [("CNF", cnf_flagship, None, (CNF_RKL_ROWS,)),
                     ("conditional CNF", cnf_cond, cc_grad, (4,)),
                     ("Hutchinson CNF", cnf_hutch, cc_grad, (4,))]
    ops.reset_launches()
    t0 = time.perf_counter()
    for label, flow, c, shape in grad_requests:
        for want in (True, False):
            loss, grads = cnf_grad_request(flow, c, shape, want)
            check(math.isfinite(loss.item()) and all(bool(torch.isfinite(g).all()) for g in grads),
                  f"{label}: a gradient through K12 is not finite")
    torch.cuda.synchronize()
    adj_launches = {name: ops.LAUNCHES[name] for name in (*CNF_NAMES, *ADJ_NAMES)}
    print(f"CNF sampling with gradients: {time.perf_counter() - t0:.3f} s,"
          f" launches {adj_launches}")
    check(adj_launches == {"cnf_density": 0, "cnf_sample": 3, "cnf_sample_log_prob": 3,
                           "cnf_adjoint": 3, "cnf_adjoint_log_prob": 3},
          f"CNF sampling with gradients: launches {adj_launches}")
    check(all(count == 0 for name, count in ops.LAUNCHES.items() if name not in adj_launches),
          "CNF sampling with gradients launched another kernel")
    adj_work = hold_adjoint("CNF", cnf_flagship, None, CNF_RKL_ROWS)
    hold_adjoint("conditional CNF", cnf_cond, cc_grad.repeat(4, 1), 4 * cc_grad.shape[0])
    hold_adjoint("Hutchinson CNF", cnf_hutch, cc_grad.repeat(4, 1), 4 * cc_grad.shape[0])
    # a ragged last tile, and a last tile with one valid row (three of its
    # cluster's four blocks hold none)
    hold_adjoint("CNF, ragged", cnf_flagship, None, CNF_RKL_ROWS - 37, generator=gen_tiers)
    hold_adjoint("CNF, one row in the last tile", cnf_flagship, None, 16 * cnf_fused.TILE + 1,
                 generator=gen_tiers)

    # (l) reverse KL through K11 with log q and K12, on the ring energy
    flow_l = zt.load_params(zt.CNF(6, device=dev),
                            ROOT / "zuko_tpu_torch" / "assets" / "cnf_flagship.npz")
    ops.reset_launches()
    init_fn, step_fns["cnf_rkl"] = zt.make_reverse_kl_step(flow_l, ring, n_samples=CNF_RKL_ROWS,
                                                            lr=1e-3)
    check(isinstance(flow_l(None), FusedContinuousFlow), "(l) did not dispatch")
    trained["cnf_rkl"], _ = run("(l) CNF reverse KL, continuous adjoint", step_fns["cnf_rkl"],
                                init_fn(), generator, TRAIN_STEPS)
    counts = {k: v for k, v in ops.LAUNCHES.items() if v}
    print(f"training (l) CNF reverse KL, continuous adjoint: launches {counts}")
    check(counts == {"cnf_sample_log_prob": TRAIN_STEPS, "cnf_adjoint_log_prob": TRAIN_STEPS},
          "(l): one cnf_sample_log_prob and one cnf_adjoint_log_prob launch a step, no other")
    train_launches["cnf_adjoint_log_prob"] = ops.LAUNCHES["cnf_adjoint_log_prob"]
    per_step["cnf_rkl"] = time_step(
        "cnf_rkl", generator, lambda: flow_l(None).sample_and_log_prob((CNF_RKL_ROWS,), gen))

    # times: K12 in both modes and K11 without and with log q at (l)'s rows;
    # the served request with its backward
    with torch.no_grad():
        work = cnf_work(cparams, ccfg, cx_big[:CNF_RKL_ROWS], None,
                        torch.randn(CNF_RKL_ROWS, 6, generator=gen, device=dev), None)
        for name in CNF_NAMES[1:]:
            time_kernel(name, CNF_RKL_ROWS, *work[name])
    for name in ADJ_NAMES:
        time_kernel(name, CNF_RKL_ROWS, *adj_work[name])
        check(timed[name, CNF_RKL_ROWS, ""]["bound_by"] == "operations", f"{name}: bound by bytes")
    # K12's two tiers on the flagship at (l)'s rows: the narrow tier (the
    # weights in shared memory) against the wide one (through __ldg), which
    # the flagship takes when the planner is told that it does not fit
    fits = cnf_fused._fits_narrow
    cnf_fused._fits_narrow = lambda widths, nf: False
    try:
        for name in ADJ_NAMES:
            time_kernel(name, CNF_RKL_ROWS, *adj_work[name], note="flagship, wide tier")
    finally:
        cnf_fused._fits_narrow = fits
    for want, name in ((True, "cnf_adjoint_log_prob"), (False, "cnf_adjoint")):
        r_ms, r_runs = host_ms(lambda: cnf_grad_request(
            cnf_flagship, None, (CNF_RKL_ROWS,), want), 3)
        print(f"served request {'rsample_and_log_prob' if want else 'rsample'} + backward at"
              f" {CNF_RKL_ROWS} rows: {r_ms:.3f} ms {fmt(r_runs)}, K12 share"
              f" {timed[name, CNF_RKL_ROWS, '']['ms'] / r_ms:.3f}")
    step_labels += (("cnf_rkl", "(l) CNF reverse KL, continuous adjoint"),)
    report_rows.update({name: CNF_RKL_ROWS for name in ADJ_NAMES})
    print(f"CNF gradient phase: {time.perf_counter() - t14:.1f} s")

    # the IFT backward at a kink of a MADE's ReLU (ROADMAP Queue 3 item 4)
    @contextlib.contextmanager
    def float32_sides():
        """The IFT backward with every ReLU's side from its own float32
        march within (as it was before it marched rows in float64)."""
        made = ift._made_sided
        ift._made_sided = lambda xc, linears, kinks: made(xc, linears, None)
        try:
            yield
        finally:
            ift._made_sided = made

    def one_float32_pass(zs, root, w, params, needs, layout, st, rows=None):
        """Parameter gradients of the IFT's loss by one float32 pass of the
        backward, every side from its own march, over the ``rows`` (all by
        default) of the draws ``zs``."""
        rows = slice(None) if rows is None else rows
        x, ws = root[rows], w[rows]
        with float32_sides():
            return ift._ift_bwd_math(zs[rows], x, 2 * x * ws[:, None], ws, params, needs, layout,
                                     *st)[1]

    def kink_rows(root, params, layout, st):
        """The rows the float32 backward marches in float64 for their ReLUs'
        sides: a MADE's hidden pre-activation, on the float32 march from the
        root, within ``ift._KINK_RTOL`` of its scale of 0."""
        x, rows = root, torch.zeros(root.shape[0], dtype=torch.bool, device=dev)
        for ps, _ in nsf_fused._split_layers(params, layout):
            h = ift._made_near(x, ift._linears(ps), rows)
            with torch.no_grad():
                x = nsf_fused._univ_forward(x, h, *st[:5])[0]
        return rows

    def ift_row_diagnosis(label, zs, root, w, params, p64, needs, layout, st):
        """Where one float32 pass of the IFT backward parts from float64 at
        the draws ``zs`` (an unconditional flow without softclips): the
        parameter and element of the worst max-relative error, the row that
        sets it (chunks of rows bisected), that row's slopes and the MADE
        pre-activations nearest a kink in each layer (float64 and float32
        marches from the root), and the element's cancellation ratio: the
        sum of its rows' |terms| over |their sum| (the terms from the
        cotangents at the linear's output in the float64 backward's
        parameter pullback)."""
        every = torch.arange(root.shape[0], device=dev)

        def grads64(rows):
            x, ws = root[rows].double(), w[rows].double()
            return ift._ift_bwd_math(zs[rows].double(), x, 2 * x * ws[:, None], ws, p64, needs,
                                     layout, *st)[1]

        full = grads64(every)
        wanted = [i for i, g in enumerate(full) if g is not None]

        def errs(rows):
            got = one_float32_pass(zs, root, w, params, needs, layout, st, rows)
            want = grads64(rows)
            return {i: (got[i].double() - want[i]).abs().max().item()
                    / full[i].abs().max().item() for i in wanted}

        e = errs(every)
        worst = max(e, key=e.get)
        diff = (one_float32_pass(zs, root, w, params, needs, layout, st)[worst].double()
                - full[worst]).abs()
        element = np.unravel_index(diff.argmax().item(), tuple(diff.shape))
        rows = every
        while len(rows) > 1:
            parts = rows.split(max(1, len(rows) // 16))
            part_errs = [errs(part)[worst] for part in parts]
            rows = parts[max(range(len(parts)), key=part_errs.__getitem__)]
        r = rows.item()
        n_lin = layout[0][0]
        stage, (lin, kind) = divmod(worst, 3 * n_lin)[0], divmod(worst % (3 * n_lin), 3)
        print(f"{label} IFT, one float32 pass: worst parameter {worst} (layer {stage}, MADE"
              f" linear {lin}, {'weight' if kind == 0 else 'bias'}) element"
              f" {tuple(int(i) for i in element)}, max-relative {e[worst]:.3e}; set by row {r}"
              f" (that row alone: {errs(rows)[worst]:.3e}), root {root[r].tolist()}")
        # that row's slopes and kink margins, layer by layer
        x64, x32 = root[r:r + 1].double(), root[r:r + 1]
        for l, ((ps64, _), (ps32, _)) in enumerate(zip(nsf_fused._split_layers(p64, layout),
                                                       nsf_fused._split_layers(params, layout))):
            h64, h32, margins = x64, x32, []
            for i in range(n_lin - 1):
                W64, b64, M64 = ps64[3 * i: 3 * i + 3]
                W32, b32, M32 = ps32[3 * i: 3 * i + 3]
                z64 = torch.addmm(b64, h64, (M64 * W64).T)
                z32 = torch.addmm(b32, h32, (M32 * W32).T)
                scale = torch.addmm(b64.abs(), h64.abs(), (M64 * W64).abs().T)
                u = (z64.abs() / scale).argmin().item()
                flips = ((z64 > 0) != (z32 > 0)).nonzero()[:, 1].tolist()
                margins.append(f"hidden {i}: nearest unit {u} at {z64[0, u].item():.3e}"
                               f" (f32 {z32[0, u].item():.3e}, |z|/scale"
                               f" {(z64.abs() / scale)[0, u].item():.3e}), sides differ at"
                               f" units {flips}")
                h64, h32 = torch.relu(z64), torch.relu(z32)
            xs = x64.clone().requires_grad_(True)
            with torch.enable_grad():  # the univariates' slopes, at fixed MADE outputs
                y, _ = nsf_fused._univ_forward(xs, nsf_fused._hyper(x64, ps64), *st[:5])
                (slope,) = torch.autograd.grad(y, xs, torch.ones_like(y))
            print(f"  layer {l}: slopes {[round(v, 6) for v in slope[0].tolist()]};"
                  f" {'; '.join(margins)}")
            x64 = y.detach()
            x32 = nsf_fused._univ_forward(x32, nsf_fused._hyper(x32, ps32), *st[:5])[0]
        # the element's terms, row by row: the cotangent at the linear's
        # output in the parameter pullback (the last pass through its graph)
        # times its input
        records, made = [], ift._made_sided

        def recording_made(xc, linears, kinks):
            h, slots = xc, []
            for i, (W, b) in enumerate(linears):
                z = torch.addmm(b, h, W.T)
                slots.append([h.detach(), None])
                if z.requires_grad:
                    z.register_hook(lambda g, slot=slots[-1]: slot.__setitem__(1, g))
                h = torch.relu(z) if i < len(linears) - 1 else z
            records.append(slots)
            return h

        ift._made_sided = recording_made
        try:
            grads64(every)
        finally:
            ift._made_sided = made
        a, g = records[stage][lin]
        o = int(element[0])
        terms = g[:, o] * (a[:, int(element[1])] * p64[worst + 2 - kind][element]
                           if kind == 0 else 1.0)
        total = terms.sum()
        print(f"  cancellation ratio of element {tuple(int(i) for i in element)}: sum |terms|"
              f" / |sum| = {(terms.abs().sum() / total.abs()).item():.1f} (sum {total.item():.3e},"
              f" the gradient {full[worst][element].item():.3e}; row {r}'s term"
              f" {terms[r].item():.3e}, largest |term| {terms.abs().max().item():.3e})")

    # 15. NCSF, SOSPF and BPF: the crqs, sosp and bernstein modes of K1-K3,
    # served, held against float64 truth and plain float64, trained, timed
    t15 = time.perf_counter()
    assets = ROOT / "zuko_tpu_torch" / "assets"
    families = {  # key -> (label, class, its keywords, truth, serving sample rows)
        "ncsf": ("NCSF", zt.NCSF, {}, assets / "ncsf_truth_f64.npz", ROWS),
        "sospf": ("SOSPF", zt.SOSPF, {}, assets / "sospf_truth_f64.npz", POLY_SAMPLE_ROWS),
        "bpf": ("BPF", zt.BPF, {}, ROOT / "tools" / "bpf_truth_f64.npz", POLY_SAMPLE_ROWS),
    }

    def tiled_vs_wide(label, names, params, layout, st, zc):
        """K3's tiled tier against its wide tier on the draws ``zc`` in the
        three modes, one tiled launch each: samples bit for bit, sums within
        TOL_DENSITY (the difference printed, with whether it is bit for
        bit)."""
        rows = zc.shape[0]
        for mode, kind in ((False, "nsf_sample"), (True, "nsf_sample_log_prob"),
                           ("raw", "nsf_sample_raw")):
            ops.reset_launches()
            with torch.no_grad():
                tiled = nsf_fused.nsf_sample(zc, params, layout, *st, want_log_prob=mode)
                launched = {k: v for k, v in ops.LAUNCHES.items() if v}
                with nsf_wide_tier():
                    wide = nsf_fused.nsf_sample(zc, params, layout, *st, want_log_prob=mode)
            check(launched == {names[kind]: 1}, f"{label} {kind}: one tiled launch, {launched}")
            tiled = tiled if isinstance(tiled, tuple) else (tiled,)
            wide = wide if isinstance(wide, tuple) else (wide,)
            diffs = [(a - b).abs() for a, b in zip(tiled, wide)]
            check(all(bool(torch.isfinite(a).all()) for a in tiled),
                  f"{label} {kind} tiled at {rows} rows: not finite")
            check(torch.equal(tiled[0], wide[0]),
                  f"{label} {kind} tiled at {rows} rows: samples not the wide tier's")
            if len(diffs) > 1:
                check(diffs[1].max().item() <= TOL_DENSITY,
                      f"{label} {kind} tiled at {rows} rows: sum vs the wide tier")
            print(f"{label} {names[kind]} tiled at {rows} rows vs the wide tier: x max"
                  f" {diffs[0].max().item():.3e}"
                  + (f", sum max {diffs[1].max().item():.3e}" if len(diffs) > 1 else "")
                  + f"; bit for bit: {all(torch.equal(a, b) for a, b in zip(tiled, wide))}")

    fam_flagship, fam_cond, fam_launches = {}, {}, {}
    for i, (key, (label, cls, kw, truth_path, sample_rows)) in enumerate(families.items()):
        flow = zt.load_params(cls(6, 0, transforms=3, device=dev, **kw),
                              assets / f"{key}_flagship.npz")
        torch.manual_seed(30 + i)
        cond = cls(6, 4, transforms=3, device=dev, **kw)
        fam_flagship[key], fam_cond[key] = flow, cond
        mode = nsf_fused._flatten_flow(flow)[2]["univ"]
        names = {k: nsf_fused._counter(k, mode) for k in NSF_KINDS}
        truth_f = np.load(truth_path)
        n_truth = truth_f["x"].shape[0]
        xs_rows = torch.remainder(x_big + math.pi, 2 * math.pi) - math.pi if key == "ncsf" \
            else x_big
        # one request holds the truth rows first
        fx = torch.cat([torch.as_tensor(truth_f["x"], device=dev, dtype=torch.float32),
                        xs_rows[: ROWS - n_truth]])
        fc = torch.randn(ROWS, 4, generator=gen, device=dev)
        fc_few = torch.randn(1024, 4, generator=gen, device=dev)
        ops.reset_launches()
        t0 = time.perf_counter()
        with torch.no_grad():
            dist = flow(None)
            f_lp = dist.log_prob(fx)
            f_xs = dist.sample((sample_rows,), generator=gen)
            f_xl, f_lq = dist.sample_and_log_prob((sample_rows,), generator=gen)
            cdist = cond(fc)
            c_lp = cdist.log_prob(xs_rows)
            cfew = cond(fc_few)
            c_xs = cfew.sample((4,), generator=gen)
            c_xl, c_lq = cfew.sample_and_log_prob((4,), generator=gen)
            inverted = Flow(flow.transform.inv, flow.base)(None)
            i_y, i_lq = inverted.sample_and_log_prob((sample_rows,), generator=gen)
            i_lp = inverted.log_prob(i_y)
        torch.cuda.synchronize()
        served_launches = {n: ops.LAUNCHES[n] for n in names.values()}
        print(f"{label} serving phase: {time.perf_counter() - t0:.3f} s, launches"
              f" {served_launches}")
        want_class = FusedAutoregressiveFlow if key == "ncsf" else FusedDensityFlow
        check(all(type(d) is want_class for d in (dist, cdist, cfew)),
              f"{label}s on the GPU did not dispatch to {want_class.__name__}")
        check(isinstance(inverted, FusedInvertedAutoregressiveFlow),
              f"the inverted {label} did not dispatch")
        check(served_launches == {names["nsf_density"]: 2, names["nsf_apply"]: 1,
                                  names["nsf_sample"]: 2, names["nsf_sample_log_prob"]: 2,
                                  names["nsf_sample_raw"]: 1},
              f"{label} serving launches {served_launches}")
        check(all(count == 0 for n, count in ops.LAUNCHES.items() if n not in names.values()),
              f"the {label} path launched another kernel")
        fam_launches.update(served_launches)
        for t, shape in [
            (f_lp, (ROWS,)), (f_xs, (sample_rows, 6)), (f_xl, (sample_rows, 6)),
            (f_lq, (sample_rows,)), (c_lp, (ROWS,)), (c_xs, (4, 1024, 6)), (c_xl, (4, 1024, 6)),
            (c_lq, (4, 1024)), (i_y, (sample_rows, 6)), (i_lq, (sample_rows,)),
            (i_lp, (sample_rows,)),
        ]:
            check(tuple(t.shape) == shape, f"{label} shape {tuple(t.shape)} != {shape}")
            check(bool(torch.isfinite(t).all()), f"non-finite values on the served {label} path")
        if key == "ncsf":  # angles
            check(bool((f_xs.abs() <= math.pi + 1e-5).all()), "NCSF samples off the circle")
        err = (f_lp[:n_truth].double() - torch.as_tensor(truth_f["lp"], device=dev)).abs()
        print(f"{label} log_prob vs f64 truth ({n_truth} rows): max {err.max().item():.3e}"
              f" median {err.median().item():.3e}")
        check(err.max().item() <= TOL_DENSITY, f"{label} density vs f64 truth")
        d_inv = (i_lp - i_lq).abs()
        print(f"inverted {label}: log_prob at its samples vs their log q: median"
              f" {d_inv.median().item():.3e} max {d_inv.max().item():.3e}")
        check(d_inv.median().item() <= TOL_DENSITY, f"inverted {label} log_prob vs log q")

        # every mode against plain float64 at the same inputs: the served
        # density rows, and draws of the base beside the context
        params, layout, st = plain_args(flow, torch.float32)
        base = st[5]
        # the polynomials' samplers are held and timed at POLY_HOLD_ROWS
        hold_rows = sample_rows if key == "ncsf" else POLY_HOLD_ROWS
        hold_nsf(label, flow, fx, base_draws(hold_rows, 6, base))
        plan = nsf_plan(params, layout, st, sample_rows)
        print(f"{label} sampler plan: {plan}")
        # K3's three modes sample through the tiled tier (NCSF with the NSF's
        # tile, the polynomials two blocks an SM): against the wide tier on
        # the same draws (the same solves and sums: the difference is
        # printed, with whether it is bit for bit), one tiled launch each;
        # draws from a generator of their own, so that (m)-(r) keep theirs
        tile = {"ncsf": 128, "sospf": 64, "bpf": 64}[key]
        check(isinstance(plan, nsf_fused.TilePlan) and plan.tile_rows == tile,
              f"{label}: the tiled sampler at {tile} rows, {plan}")
        seed = {"ncsf": 17, "sospf": 18, "bpf": 16}[key]
        gen_tier = torch.Generator(device=dev).manual_seed(seed)
        tier_draws = [base_draws(rows, 6, base, gen_tier) for rows in (sample_rows, POLY_RKL_ROWS)]
        if key == "ncsf":
            at_jumps = jump_rows(flow, 1 << 14)
            tier_draws.append(at_jumps[1])
        for zc in tier_draws:
            tiled_vs_wide(label, names, params, layout, st, zc)
        if key == "ncsf":
            hold_nsf(f"{label} at the shifts' jumps", flow, *at_jumps)
        czc = torch.cat([base_draws(4096, 6, base), fc_few.repeat(4, 1)], dim=1)
        hold_nsf(f"conditional {label}", cond, torch.cat([xs_rows, fc], dim=1), czc)
        cparams, clayout, cst = plain_args(cond, torch.float32)
        cplan = nsf_plan(cparams, clayout, cst, czc.shape[0])
        check(isinstance(cplan, nsf_fused.TilePlan) and cplan.tile_rows == tile,
              f"conditional {label}: the tiled sampler at {tile} rows, {cplan}")
        tiled_vs_wide(f"conditional {label}", names, cparams, clayout, cst, czc)
        fam_work = nsf_work(params, layout, st, fx, base_draws(ROWS, 6, base))
        with torch.no_grad():
            time_kernel(names["nsf_density"], ROWS, *fam_work[names["nsf_density"]])
            time_kernel(names["nsf_apply"], ROWS, *fam_work[names["nsf_apply"]])
            sample_work = nsf_work(params, layout, st, fx[:hold_rows],
                                   base_draws(hold_rows, 6, base))
            for kind in NSF_KINDS[2:]:
                time_kernel(names[kind], hold_rows, *sample_work[names[kind]],
                            runs=5 if key == "ncsf" else 3, plain_runs=None if key == "ncsf" else 1)
            report_rows.update({names["nsf_density"]: ROWS, names["nsf_apply"]: ROWS,
                                **{names[k]: hold_rows for k in NSF_KINDS[2:]}})
            r_ms, r_runs = host_ms(lambda: flow(None).log_prob(fx), 3)
            print(f"served request {names['nsf_density']} at {ROWS} rows: {r_ms:.3f} ms"
                  f" {fmt(r_runs)}, kernel share"
                  f" {timed[names['nsf_density'], ROWS, '']['ms'] / r_ms:.3f}")
            r_ms, r_runs = host_ms(lambda: flow(None).sample_and_log_prob(
                (sample_rows,), generator=gen), 3)
            print(f"served request {names['nsf_sample_log_prob']} at {sample_rows} rows:"
                  f" {r_ms:.3f} ms {fmt(r_runs)}, {sample_rows / r_ms / 1e3:.3f} M rows/s")

    # K1 and K2's tiled tier in the crqs, bernstein and sosp modes (their
    # narrow tier since it was redesigned; SOSPF's softclip after each layer
    # taken by the row's owner thread), as the closed-form one's above:
    # planned for the flagship and the conditional (6, 4) flow of each; at 1M rows,
    # 65,536 - 37 and 16 tiles + 1, the density, the apply's y and its sum
    # against plain float64 and against the wide tier on the same rows, one
    # launch of each tier; NCSF's each tier against float64 continued on the
    # side of the shifts' jumps that the tier took (circle_plain), also at
    # the 16,384 rows placed at the jumps, the tiers held against each other
    # on the rows neither continued, and the rows the two put on different
    # sides counted; rows from a generator of their own
    def hold_density_tiers(label, names, xc, params, p64, layout, st):
        rows, circle, base = xc.shape[0], st[4] == "crqs", st[5]
        out, moved = {}, {}
        for tier, names_of in (("tiled", ""), ("wide", "_wide")):
            with nsf_wide_tier() if tier == "wide" else contextlib.nullcontext():
                for fn, kind in ((nsf_fused.nsf_density, "nsf_density"),
                                 (nsf_fused.nsf_apply, "nsf_apply")):
                    ops.reset_launches()
                    with torch.no_grad():
                        got = fn(xc, params, layout, *st)
                    launched = {k: v for k, v in ops.LAUNCHES.items() if v}
                    check(launched == {names[kind] + names_of: 1},
                          f"{label} {kind}: one {tier} launch, {launched}")
                    out[tier, kind] = got if isinstance(got, tuple) else (got,)
                with torch.no_grad():
                    if circle:
                        r_y, r_sl, moved[tier] = circle_plain("apply", xc, params, p64, layout,
                                                              st)
                        # the box is uniform on the circle: its density at
                        # the continued point, wrapped back onto the box
                        r_lp = r_sl + nsf_fused._base_log_prob(on_circle(r_y), base)
                    else:
                        r_lp = nsf_fused._full_math(xc.double(), p64, layout, *st)
                        r_y, r_sl = nsf_fused._full_math(xc.double(), p64, layout, *st,
                                                         raw=True)
                        moved[tier] = torch.zeros(rows, dtype=torch.bool, device=dev)
            (lp,), (y, sl) = out[tier, "nsf_density"], out[tier, "nsf_apply"]
            dy = y.double() - r_y
            diffs = {"nsf_density": (lp.double() - r_lp).abs(),
                     "nsf_apply": torch.maximum((on_circle(dy) if circle else dy).abs()
                                                .amax(dim=1), (sl.double() - r_sl).abs())}
            print(f"{label} {tier} tier at {rows} rows vs plain f64: density max"
                  f" {diffs['nsf_density'].max().item():.3e}, apply (y, sum) max"
                  f" {diffs['nsf_apply'].max().item():.3e}"
                  + (f"; rows continued on its side of a jump: {int(moved[tier].sum().item())}"
                     if circle else ""))
            for kind, d in diffs.items():
                check(d.max().item() <= TOL_DENSITY, f"{label} {tier} {kind} at {rows} rows vs plain")
                if tier == "tiled":
                    note_error(names[kind], d, rows)
        ordinary = ~(moved["tiled"] | moved["wide"])
        wdiff = torch.stack([
            (a - b).abs().reshape(rows, -1).amax(dim=1)
            for kind in ("nsf_density", "nsf_apply")
            for a, b in zip(out["tiled", kind], out["wide", kind])]).amax(dim=0)
        same = all(torch.equal(a, b) for kind in ("nsf_density", "nsf_apply")
                   for a, b in zip(out["tiled", kind], out["wide", kind]))
        worst = torch.where(ordinary, wdiff, torch.zeros_like(wdiff)).max().item()
        print(f"{label} tiled vs wide tier at {rows} rows: max {worst:.3e}"
              f" over {int(ordinary.sum().item())} ordinary rows; bit for bit: {same}"
              + (f"; rows the two tiers put on different sides of a jump:"
                 f" {int((moved['tiled'] ^ moved['wide']).sum().item())}, differing by more than"
                 f" {TOL_DENSITY:g}: {int((wdiff > TOL_DENSITY).sum().item())}" if circle else ""))
        check(worst <= TOL_DENSITY, f"{label} tiled vs wide tier at {rows} rows")

    gen_k12m = torch.Generator(device=dev).manual_seed(19)
    t_k12m = time.perf_counter()
    for key, tile in (("ncsf", 128), ("bpf", 64), ("sospf", 64)):
        label = families[key][0]
        names = {k: nsf_fused._counter(k, nsf_fused._flatten_flow(fam_flagship[key])[2]["univ"])
                 for k in NSF_KINDS}
        for which, flow in ((label, fam_flagship[key]), (f"conditional {label}", fam_cond[key])):
            params, layout, st = plain_args(flow, torch.float32)
            p64, _, _ = plain_args(flow, torch.float64)
            F, C = st[0], params[0].shape[1] - st[0]
            plan = nsf_plan(params, layout, st, ROWS, sample=False)
            print(f"{which} density plan: {plan}")
            check(isinstance(plan, nsf_fused.TilePlan) and not plan.wide and plan.tile_rows == tile,
                  f"{which}: the tiled density at {tile} rows")
            for rows in (ROWS, POLY_MLE_ROWS - 37, 16 * tile + 1):
                xc = torch.cat([base_draws(rows, F, st[5], gen_k12m),
                                torch.randn(rows, C, generator=gen_k12m, device=dev)], dim=1)
                hold_density_tiers(which, names, xc, params, p64, layout, st)
            if key == "ncsf" and flow is fam_flagship[key]:
                hold_density_tiers(f"{which} at the shifts' jumps", names,
                                   jump_rows(flow, 1 << 14)[0], params, p64, layout, st)
    print(f"K1 and K2 tiled tier checks, crqs, bernstein and sosp:"
          f" {time.perf_counter() - t_k12m:.1f} s")

    # the Functions at the rows and draws the steps give them: K1's at (m),
    # (o), (q)'s first batch, the IFT (K3 with log q, three sweeps back)
    # at 16,384 draws against the same backward in float64 at the kernel's
    # own root, over the draws plain float64 solves
    fam_batches = {}
    for key, flow in fam_flagship.items():
        label, mode = families[key][0], nsf_fused._flatten_flow(flow)[2]["univ"]
        rows = xs[: POLY_MLE_ROWS * 4] if key != "ncsf" else \
            torch.remainder(xs[: POLY_MLE_ROWS * 4] + math.pi, 2 * math.pi) - math.pi
        fam_batches[key] = rows.split(POLY_MLE_ROWS)
        params, layout, st = plain_args(flow, torch.float32)
        p64, _, _ = plain_args(flow, torch.float64)
        base = st[5]
        density, values = [], []
        for fn, ps0, dtype in ((nsf_fused.nsf_density, params, torch.float32),
                               (nsf_fused._full_math, p64, torch.float64)):
            ps, xr = leaves(ps0), fam_batches[key][0].to(dtype, copy=True).requires_grad_(True)
            lp = fn(xr, ps, layout, *st)
            lp.mean().backward()
            density.append([xr.grad] + grads_of(ps))
            values.append(lp.detach())
        d = (values[0].double() - values[1]).abs()
        print(f"{label} density at (m, o, q)'s {POLY_MLE_ROWS} rows vs plain f64: max"
              f" {d.max().item():.3e}")
        check(d.max().item() <= TOL_DENSITY, f"{label} density at the steps' rows vs plain")
        note_error(nsf_fused._counter("nsf_density", mode), d, POLY_MLE_ROWS)
        compare_grads(f"{label} density at (m, o, q)'s rows", *density)
        needs = [i % 3 != 2 for i in range(len(p64))]

        def hold_ift(zg, what=""):
            """The IFT (K3 with log q, the Function's backward) at the draws
            ``zg`` against the same sweeps in float64 at the kernel's root;
            returns ``(root, loss weights, float64 parameter gradients)``."""
            with torch.no_grad():
                _, r_rl, solved, _ = plain_samples(zg, params, p64, layout, st)[True]
            r_lq = r_rl + nsf_fused._base_log_prob(zg.double(), base)
            # the loss of (n), (p), (r)'s kind over the solved draws
            w = solved.float() / POLY_RKL_ROWS
            ps, zr = leaves(params), zg.clone().requires_grad_(True)
            root, lq32 = ift._IFTFunction.apply(zr, (layout, *st), True, *ps)
            ((lq32 + (root**2).sum(dim=1)) * w).sum().backward()
            got = [zr.grad] + grads_of(ps)
            x64, w64 = root.detach().double(), w.double()
            dz, dps = ift._ift_bwd_math(zg.double(), x64, 2 * x64 * w64[:, None], w64, p64,
                                        needs, layout, *st)
            dlq = (lq32.detach().double() - r_lq).abs()[solved]
            print(f"{label} IFT at {POLY_RKL_ROWS} draws{what}: {int((~solved).sum().item())}"
                  f" not held (not solved by plain float64); log q vs plain f64 max"
                  f" {dlq.max().item():.3e}")
            check(dlq.max().item() <= TOL_DENSITY, f"{label} IFT log q vs plain")
            note_error(nsf_fused._counter("nsf_sample_log_prob", mode), dlq, POLY_RKL_ROWS)
            compare_grads(f"{label} IFT (log q){what}, at the kernel's root", got,
                          [dz[:, :6]] + [g for g in dps if g is not None],
                          tol_input=TOL_GRAD_SOLVE_INPUT)
            return root.detach(), w, dps

        zg = base_draws(POLY_RKL_ROWS, 6, base)
        root, w, dps = hold_ift(zg)
        if key == "bpf":
            # ROADMAP Queue 3 item 4: three more draw sets, each from a
            # generator of its own; beside each, one float32 pass of the
            # backward with every ReLU's side from the float32 march, whose
            # worst set is taken apart
            sets = [(zg, root, w, dps)]
            for seed in (21, 22, 23):
                g_set = torch.Generator(device=dev).manual_seed(seed)
                zs = torch.randn(POLY_RKL_ROWS, 6, generator=g_set, device=dev)
                sets.append((zs, *hold_ift(zs, f" (draw set of seed {seed})")))
            one_pass = []
            for zs, root_s, w_s, dps_s in sets:
                one_pass.append(one_float32_pass(zs, root_s, w_s, params, needs, layout, st))
                rel = max(((a.double() - b).abs().max() / b.abs().max()).item()
                          for a, b in zip(one_pass[-1], dps_s) if b is not None)
                print(f"{label} IFT, every side from the float32 march: parameters worst"
                      f" max-relative {rel:.3e}; rows the backward marches in float64:"
                      f" {int(kink_rows(root_s, params, layout, st).sum().item())}")
            worst = max(range(len(sets)), key=lambda k: max(
                ((a.double() - b).abs().max() / b.abs().max()).item()
                for a, b in zip(one_pass[k], sets[k][3]) if b is not None))
            ift_row_diagnosis(label, *sets[worst][:3], params, p64, needs, layout, st)

    # (m)-(r): MLE on the samples the NSF serving phase drew (NCSF's wrapped
    # onto the circle) and reverse KL through the IFT on the ring energy,
    # from seeded weights at the flagships' widths
    fam_steps = {}
    for i, (key, (label, cls, kw, _, _)) in enumerate(families.items()):
        mode = nsf_fused._flatten_flow(fam_flagship[key])[2]["univ"]
        names = {k: nsf_fused._counter(k, mode) for k in NSF_KINDS}
        tags = {"ncsf": ("m", "n"), "sospf": ("o", "p"), "bpf": ("q", "r")}[key]
        torch.manual_seed(40 + i)
        flow_mle = cls(6, 0, transforms=3, device=dev, **kw)
        flow_rkl = copy.deepcopy(flow_mle)
        fam_batch = lambda j, key=key: (fam_batches[key][j % len(fam_batches[key])],)  # noqa: E731
        ops.reset_launches()
        init_fn, step_fns[f"{key}_mle"] = zt.make_mle_step(flow_mle, lr=1e-3)
        trained[f"{key}_mle"], _ = run(f"({tags[0]}) {label} MLE", step_fns[f"{key}_mle"],
                                       init_fn(), fam_batch, TRAIN_STEPS)
        counts = {k: v for k, v in ops.LAUNCHES.items() if v}
        print(f"training ({tags[0]}) {label} MLE: launches {counts}")
        check(counts == {names["nsf_density"]: TRAIN_STEPS},
              f"({tags[0]}): one {names['nsf_density']} launch a step, no other")
        train_launches[names["nsf_density"]] = ops.LAUNCHES[names["nsf_density"]]
        ops.reset_launches()
        init_fn, step_fns[f"{key}_rkl"] = zt.make_reverse_kl_step(
            flow_rkl, ring, n_samples=POLY_RKL_ROWS, lr=1e-3)
        trained[f"{key}_rkl"], _ = run(f"({tags[1]}) {label} reverse KL, IFT",
                                       step_fns[f"{key}_rkl"], init_fn(), generator, TRAIN_STEPS)
        counts = {k: v for k, v in ops.LAUNCHES.items() if v}
        print(f"training ({tags[1]}) {label} reverse KL, IFT: launches {counts}")
        check(counts == {names["nsf_sample_log_prob"]: TRAIN_STEPS},
              f"({tags[1]}): one {names['nsf_sample_log_prob']} launch a step, no other")
        train_launches[names["nsf_sample_log_prob"]] = ops.LAUNCHES[names["nsf_sample_log_prob"]]
        per_step[f"{key}_mle"] = time_step(
            f"{key}_mle", fam_batch, lambda f=flow_mle, key=key: f(None).log_prob(
                fam_batches[key][0]).mean())
        per_step[f"{key}_rkl"] = time_step(
            f"{key}_rkl", generator, lambda f=flow_rkl: f(None).sample_and_log_prob(
                (POLY_RKL_ROWS,), gen))
        # the kernels at the steps' shapes
        params, layout, st = plain_args(fam_flagship[key], torch.float32)
        with torch.no_grad():
            work = nsf_work(params, layout, st, fam_batches[key][0],
                            base_draws(POLY_MLE_ROWS, 6, st[5]))
            time_kernel(names["nsf_density"], POLY_MLE_ROWS, *work[names["nsf_density"]])
            work = nsf_work(params, layout, st, fam_batches[key][0][:POLY_RKL_ROWS],
                            base_draws(POLY_RKL_ROWS, 6, st[5]))
            time_kernel(names["nsf_sample_log_prob"], POLY_RKL_ROWS,
                        *work[names["nsf_sample_log_prob"]], runs=3, plain_runs=1)
        step_labels += ((f"{key}_mle", f"({tags[0]}) {label} MLE"),
                        (f"{key}_rkl", f"({tags[1]}) {label} reverse KL, IFT"))
        fam_steps.update({f"{key}_mle": POLY_MLE_ROWS, f"{key}_rkl": POLY_RKL_ROWS})
    print(f"NCSF, SOSPF and BPF phase: {time.perf_counter() - t15:.1f} s")

    # a training step beside the kernels it launches (their times at the
    # step's shapes, times the launches of one step)
    for key, label in (("mle", "(a) MLE"), ("rkl", "(b) reverse KL, IFT"),
                       ("rkl_inv", "(c) reverse KL, inverted flow"),
                       ("mle_unfused", "(d) MLE, unfused, per-op kernels"), *step_labels):
        s_ms, s_runs = step_ms[key]
        rows = {"naf_rkl": NAF_IFT_ROWS, "unaf_rkl": UNAF_IFT_ROWS,
                "cnf_mle": CNF_TRAIN_ROWS, "cnf_rkl": CNF_RKL_ROWS, **fam_steps}.get(key, GRAD_ROWS)
        k_ms = sum(timed[name, rows, ""]["ms"] * count / (3 if name == "masked_linear" else 1)
                   for name, count in per_step[key].items())
        print(f"training step {label}: {s_ms:.3f} ms {fmt(s_runs)}, launches per step"
              f" {per_step[key]}, their kernels {k_ms:.3f} ms, kernel share {k_ms / s_ms:.3f},"
              f" forward alone {forward_ms[key]:.3f} ms, {rows / s_ms / 1e3:.3f} M rows/s")

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
    launches.update(gf_launches)
    launches.update(naf_launches)
    launches.update(unaf_launches)
    launches.update(cnf_launches)
    launches["cnf_adjoint"] = adj_launches["cnf_adjoint"]
    launches.update({name: repair_launches[name] for name in wide_names})
    launches.update(fam_launches)
    launches.update(thread_launches)
    for name, (source, replaces) in origin.items():
        rows = report_rows.get(name, ROWS if name in launches else GRAD_ROWS)
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name] if name in launches else train_launches[name],
            "max_abs_err": errors[name, rows], "rows": rows, **timed[name, rows, ""],
            "max_abs_err_at_rows": {str(r): e for (n, r), e in errors.items() if n == name},
        })
        if name in gf_launches:
            kernels[-1]["batched_context"] = timed[name, rows, "batched context"]
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
