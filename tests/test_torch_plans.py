r"""Launch plans of the redesigned kernels, held without a GPU: the tiled
samplers' and the tiled density's tier and tile, UMNN and MNN
(``ops/naf_fused.py`` ``plan_naf``, ``umnn_tile_rows``, ``mnn_tile_rows``,
``density_tile_rows``, ``_tile_floats``, mirrored in ``csrc/naf_fused.cu``
``tile_plan``), the ``masked_linear`` kernel's
persistent launch (``ops/masked_linear.py`` ``plan_masked_linear``, mirrored
in ``csrc/masked_linear.cu``) and the CNF adjoint's cluster tier
(``ops/cnf_fused.py`` ``plan_cnf_adjoint``, ``_padded_weights``, mirrored in
``csrc/cnf_fused.cu`` ``adjoint_plan``), the closed-form NSF sampler's tile
(``ops/nsf_fused.py`` ``plan_nsf(..., sample=True)``, ``sample_tile_rows``,
``_sample_tile_floats``, ``_tiled_weights``, mirrored in
``csrc/nsf_fused.cu`` ``tile_plan``) and the closed-form density's and
apply's (``plan_nsf``, ``density_tile_rows``, ``_density_tile_floats``,
``tile_plan`` without targets), the CNF density's cluster tier
and sampler's (``plan_cnf``, mirrored in ``density_plan``), the tiled
Bernstein, circular and sum-of-squares samplers (``plan_nsf(..., sample=True)``
for ``bernstein``, ``crqs`` and ``sosp``), the circular spline's, the
Bernstein polynomial's and the sum of squares' tiled density and apply
(``plan_nsf`` for ``crqs``, ``bernstein`` and ``sosp``, mirrored in
``tiled``), the GF sampler's tile (``ops/gf_fused.py`` ``plan_gf(...,
sample=True)``, ``_tile_floats``, mirrored in ``csrc/gf_fused.cu``
``tile_plan``), and that the wrappers hand those plans to the C entry
points: a library that records its calls stands in for the built one, and
the tensors say they lie on the GPU."""

import contextlib
import types

import pytest
import torch

import zuko_tpu_torch as zt

from zuko_tpu_torch import ops
from zuko_tpu_torch.ops import (
    _build,
    _common,
    cnf_fused,
    gf_fused,
    masked_linear,
    naf_fused,
    nsf_fused,
)

torch.set_num_threads(1)

SHARED = 232448  # a block's shared memory on an H100


@pytest.fixture(autouse=True)
def _leave_torch_globals_as_found():
    """Other tests of the suite draw from torch's global generator unseeded
    and set its default dtype: run on float32 defaults, and hand both back
    as they were."""
    dtype = torch.get_default_dtype()
    torch.set_default_dtype(torch.float32)
    with torch.random.fork_rng(devices=[]):
        yield
    torch.set_default_dtype(dtype)


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the GPU."""

    is_cuda = property(lambda self: True)


def _unaf_shapes(context=0, **kwargs):
    torch.manual_seed(0)
    flow = zt.UNAF(6, context, transforms=3, signal=16, device="cpu", **kwargs)
    params, layout, F, S = naf_fused._flatten_naf(flow)
    kind, made_w, mono_w = naf_fused._widths(params, layout, F, context, S)
    assert kind == "umnn"
    return made_w, mono_w, F, S, len(layout)


@pytest.mark.parametrize("context, floats", [(0, 36348), (4, 36604)],
                         ids=["flagship", "conditional"])
def test_umnn_sampler_plans_the_tiled_tier(context, floats):
    """The flagship UNAF and the conditional UNAF(6, 4) sample through the
    tiled kernel whatever the rows: its shared memory at tiles of 64 rows
    (MADE 64 x 64, integrand 17-64-64-1: 145 KB for the flagship) is within
    227 KB. Each array starts on a 16-byte boundary."""
    made_w, mono_w, F, S, n_stages = _unaf_shapes(context)
    assert made_w == [6 + context, 64, 64, 102] and mono_w == [17, 64, 64, 1]
    got = naf_fused._umnn_tile_floats(made_w, mono_w, F, context, S, 64)
    # xc, a, b, y, sig, pre1, xp, g; act [64][256 + 4]; W2 [64][64] and its
    # bias; the x column, the last layer, its bias and the GL rules
    R = 64
    want = ((F + context) * R + 2 * 64 * R + F * R + 17 * R + 64 * R + 2 * R + 17 * R
            + 64 * 260 + 64 * 64 + 64 + (64 + 64 + 60))
    assert got == want == floats and 4 * got <= SHARED
    for rows in (1, 1 << 14, 1 << 16):
        plan = naf_fused.plan_naf("umnn", made_w, mono_w, F, context, S, n_stages, rows,
                                  sample=True)
        assert plan == _common.narrow_plan(rows)


@pytest.mark.parametrize("kwargs, sample_wide, density_wide", [
    ({"network": {"hidden_features": (128, 128)}}, False, False),
    ({"network": {"hidden_features": (128, 128, 128)}}, True, False),
    ({"hidden_features": (256, 256)}, True, False),
    ({"network": {"hidden_features": (130, 130)}}, True, True),
], ids=["two_128", "three_128", "made_256", "past_narrow"])
def test_umnn_sampler_past_its_shared_memory_plans_the_wide_tier(kwargs, sample_wide,
                                                                 density_wide):
    """A UNAF within the narrow limits whose tiled sampler would need more
    than 227 KB (three hidden layers of 128: 279 KB; MADE widths of 256: 244
    KB) samples through the wide tier, while its density stays narrow (the
    tiled density at a smaller tile); past the narrow limits (widths of 130)
    both go wide. Two layers of 128 fit (213 KB: fewer node rows a chunk,
    128)."""
    made_w, mono_w, F, S, n_stages = _unaf_shapes(**kwargs)
    fits = 4 * naf_fused._umnn_tile_floats(made_w, mono_w, F, 0, S, 64) <= SHARED
    sample = naf_fused.plan_naf("umnn", made_w, mono_w, F, 0, S, n_stages, 1 << 16, sample=True)
    density = naf_fused.plan_naf("umnn", made_w, mono_w, F, 0, S, n_stages, 1 << 16)
    assert (sample.wide, density.wide) == (sample_wide, density_wide)
    assert fits == (not sample_wide) or density_wide
    if sample.wide:
        assert sample.workspace_bytes <= _common.WORKSPACE_BYTES


@pytest.mark.parametrize("rows, sms, tile", [
    (1 << 16, 132, 64), (1 << 14, 132, 64), (132 * 64, 132, 64), (131 * 64, 132, 32),
    (132 * 32, 132, 32), (4096, 132, 16), (37, 132, 16), (1, 1, 64),
])
def test_umnn_tile_rows(rows, sms, tile):
    """Tiles of 64 rows as long as they cover every SM once (the tiled
    sampler runs one block an SM), else 32, else 16."""
    assert naf_fused.umnn_tile_rows(rows, sms) == tile


@pytest.mark.parametrize("n, in_f, out_f, plan", [
    # the flagship MADE at 262,144 rows: the split weights resident, two
    # blocks an SM, two x tiles; one warp across 64 outputs, two across 138
    ((1 << 18), 6, 64, (8, 1, 128, 6, 264, 16640, True)),
    ((1 << 18), 64, 64, (8, 1, 128, 64, 264, 102656, True)),
    ((1 << 18), 64, 138, (9, 2, 64, 64, 264, 109120, True)),
    ((1 << 18) - 37, 64, 138, (9, 2, 64, 64, 264, 109120, True)),
    (100, 37, 91, (6, 2, 64, 37, 2, 53632, True)),
    # resident at one block an SM
    (1 << 18, 96, 64, (8, 1, 128, 96, 132, 151808, True)),
    # past the planned shared memory: chunks of inputs, or of 256 outputs
    (4096, 2048, 64, (8, 1, 128, 104, 32, 108800, False)),
    (4096, 64, 300, (16, 2, 64, 64, 64, 149504, False)),
    (1000, 4096, 1000, (16, 2, 64, 48, 16, 112640, False)),
], ids=["6_64", "64_64", "64_138", "ragged", "odd", "one_block", "wide_in", "wide_out", "both"])
def test_masked_linear_plan(n, in_f, out_f, plan):
    """``(nt, wc, rows, kc, blocks, shared bytes, resident)``: two blocks
    an SM where their shared memory fits (1 KB reserved a block), else one,
    at most one a tile; past the shared memory, chunks of inputs that are
    multiples of 8 (the k-steps of mma.sync.m16n8k8); outputs past 256 in
    chunks."""
    got = masked_linear.plan_masked_linear(n, in_f, out_f, 132)
    assert tuple(got) == plan
    per_sm = 2 if got.shared_bytes <= (233472 - 2048) // 2 else 1
    assert got.blocks <= per_sm * 132 and got.shared_bytes <= (233472 - per_sm * 1024) // per_sm
    if got.kc < in_f:
        assert got.kc % 8 == 0


def _recorder(calls):
    """A stand-in for the built libraries: every entry point records its
    arguments and returns success."""
    def entry(name):
        return lambda *args: calls.append((name, args)) or 0
    return types.SimpleNamespace(**{name: entry(name) for library in _build._SIGNATURES.values()
                                    for name in library})


@pytest.fixture
def recorded(monkeypatch):
    calls = []
    lib = _recorder(calls)
    monkeypatch.setattr(_build, "load_library", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *args: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(_common, "_sm_count", lambda index: 132)
    ops.reset_launches()
    yield calls
    ops.reset_launches()


@pytest.mark.parametrize("n, in_f, out_f", [(1 << 18, 64, 138), (4096, 2048, 64), (300, 37, 91)])
def test_masked_linear_hands_its_plan_to_the_kernel(recorded, n, in_f, out_f):
    """The wrapper launches with the plan's chunk of inputs and blocks (no
    copy of a contiguous x, whatever its offset), counts one launch, and
    returns an (n, out_f) tensor."""
    torch.manual_seed(0)
    x = torch.randn(n * in_f + 1)[1:].view(n, in_f).as_subclass(_OnCard)
    W, M, b = (t.as_subclass(_OnCard)
               for t in (torch.randn(out_f, in_f), torch.ones(out_f, in_f), torch.randn(out_f)))
    with torch.no_grad():
        y = masked_linear.masked_linear(x, W, M, b)
    plan = masked_linear.plan_masked_linear(n, in_f, out_f, 132)
    [(name, args)] = recorded
    assert name == "masked_linear_f32"
    assert args[0] == x.data_ptr() and args[5:8] == (n, in_f, out_f)
    assert args[8:10] == (plan.kc, plan.blocks)
    assert y.shape == (n, out_f) and ops.LAUNCHES["masked_linear"] == 1


@pytest.mark.parametrize("rows", [1 << 16, 4096])
def test_naf_sampler_hands_the_tile_to_the_kernel(recorded, rows):
    """A UNAF's sampler launches its narrow tier (the tiled kernel) with
    the tile rows of ``umnn_tile_rows``; the density too takes a tile
    argument; the counts stay under their names."""
    torch.manual_seed(0)
    flow = zt.UNAF(6, 0, transforms=3, signal=16, device="cpu")
    params, layout, F, S = naf_fused._flatten_naf(flow)
    params = [p.detach().as_subclass(_OnCard) for p in params]
    z = torch.randn(rows, 6).as_subclass(_OnCard)
    naf_fused.naf_sample(z, params, layout, F, S)
    naf_fused.naf_sample(z, params, layout, F, S, want_log_prob=True)
    naf_fused.naf_density(z, params, layout, F, S)
    names = [name for name, _ in recorded]
    assert names == ["naf_sample_f32", "naf_sample_f32", "naf_density_f32"]
    sig = _build._SIGNATURES["naf_fused"]
    for name, args in recorded:
        assert len(args) == len(sig[name][0])
    for _, args in recorded[:2]:
        assert args[-8] == 0  # the narrow tier
        assert args[-2] == naf_fused.umnn_tile_rows(rows, 132)
    assert {k: v for k, v in ops.LAUNCHES.items() if v} == {
        "naf_sample_umnn": 1, "naf_sample_umnn_log_prob": 1, "naf_density_umnn": 1}


def _naf_shapes(features=6, context=0, **kwargs):
    torch.manual_seed(0)
    flow = zt.NAF(features, context, signal=16, device="cpu", **{"transforms": 3, **kwargs})
    params, layout, F, S = naf_fused._flatten_naf(flow)
    kind, made_w, mono_w = naf_fused._widths(params, layout, F, context, S)
    assert kind == "mnn"
    return made_w, mono_w, F, S, len(layout)


@pytest.mark.parametrize("features, context, kwargs, floats", [
    (6, 0, {}, 49732), (6, 4, {}, 50244), (32, 0, {"transforms": 2}, 56388),
], ids=["flagship", "conditional", "features_32"])
def test_mnn_sampler_plans_the_tiled_tier(features, context, kwargs, floats):
    """The flagship NAF, the conditional NAF(6, 4) and NAF(32) sample
    through the tiled kernel whatever the rows: its shared memory at tiles
    of 128 rows (MADE 64 x 64, monotone networks 17-64-64-1: 194 KB for the
    flagship, 220 KB for 32 features) is within 227 KB. Each array starts
    on a 16-byte boundary; a chunk holds 128 value rows and their tangent
    rows, 2 x 128 + 4 slots."""
    made_w, mono_w, F, S, n_stages = _naf_shapes(features, context, **kwargs)
    assert made_w == [F + context, 64, 64, 16 * F] and mono_w == [17, 64, 64, 1]
    got = naf_fused._tile_floats("mnn", made_w, mono_w, F, context, S, 128)
    # xc, a, b, y, sig, pre1, xp, g (two values and a derivative a row);
    # act [64][2 x 128 + 4]; W2 [64][64] and its bias; the x column, the
    # last layer and its bias
    R = 128
    want = ((F + context) * R + 2 * 64 * R + F * R + 16 * R + 64 * R + 2 * R + 3 * R
            + 64 * 260 + 64 * 64 + 64 + (64 + 64 + 4))
    assert got == want == floats and 4 * got <= SHARED
    for rows in (1, 1 << 14, 1 << 18):
        plan = naf_fused.plan_naf("mnn", made_w, mono_w, F, context, S, n_stages, rows,
                                  sample=True)
        assert plan == _common.narrow_plan(rows)


@pytest.mark.parametrize("kwargs", [
    {"network": {"hidden_features": (128, 128)}}, {"hidden_features": (256, 256)},
], ids=["net_128", "made_256"])
def test_mnn_sampler_past_its_shared_memory_plans_the_wide_tier(kwargs):
    """A NAF within the narrow limits whose tiled sampler would need more
    than 227 KB at tiles of 128 rows (monotone networks of 128: 276 KB, a
    chunk of 64 value rows; MADE widths of 256: 386 KB) samples through the
    wide tier, while its density stays narrow (the tiled density at a
    smaller tile)."""
    made_w, mono_w, F, S, n_stages = _naf_shapes(**kwargs)
    assert 4 * naf_fused._tile_floats("mnn", made_w, mono_w, F, 0, S, 128) > SHARED
    sample = naf_fused.plan_naf("mnn", made_w, mono_w, F, 0, S, n_stages, 1 << 16, sample=True)
    density = naf_fused.plan_naf("mnn", made_w, mono_w, F, 0, S, n_stages, 1 << 16)
    assert sample.wide and not density.wide
    assert sample.workspace_bytes <= _common.WORKSPACE_BYTES


@pytest.mark.parametrize("rows, sms, tile", [
    (1 << 18, 132, 128), (1 << 16, 132, 128), (132 * 128, 132, 128), (131 * 128, 132, 64),
    (1 << 14, 132, 64), (4096, 132, 32), (37, 132, 32), (1, 1, 128),
])
def test_mnn_tile_rows(rows, sms, tile):
    """Tiles of 128 rows as long as they cover every SM once (one block an
    SM), else 64, else 32."""
    assert naf_fused.mnn_tile_rows(rows, sms) == tile


@pytest.mark.parametrize("rows", [1 << 16, 4096])
def test_naf_sampler_hands_the_mnn_tile_to_the_kernel(recorded, rows):
    """A NAF's sampler launches its narrow tier (the tiled kernel) with the
    tile rows of ``mnn_tile_rows``; the counts stay under their names."""
    torch.manual_seed(0)
    flow = zt.NAF(6, 0, transforms=3, signal=16, device="cpu")
    params, layout, F, S = naf_fused._flatten_naf(flow)
    params = [p.detach().as_subclass(_OnCard) for p in params]
    z = torch.randn(rows, 6).as_subclass(_OnCard)
    naf_fused.naf_sample(z, params, layout, F, S)
    naf_fused.naf_sample(z, params, layout, F, S, want_log_prob=True)
    assert [name for name, _ in recorded] == ["naf_sample_f32"] * 2
    for _, args in recorded:
        assert len(args) == len(_build._SIGNATURES["naf_fused"]["naf_sample_f32"][0])
        assert args[-8] == 0 and args[-2] == naf_fused.mnn_tile_rows(rows, 132)
    assert {k: v for k, v in ops.LAUNCHES.items() if v} == {
        "naf_sample": 1, "naf_sample_log_prob": 1}


def _shapes(cls, context=0, **kwargs):
    torch.manual_seed(0)
    flow = cls(6, context, signal=16, device="cpu", **{"transforms": 3, **kwargs})
    params, layout, F, S = naf_fused._flatten_naf(flow)
    kind, made_w, mono_w = naf_fused._widths(params, layout, F, context, S)
    return flow, kind, made_w, mono_w, F, S, len(layout)


@pytest.mark.parametrize("cls, context, tile, floats", [
    (zt.NAF, 0, 128, 49732), (zt.NAF, 4, 128, 50244), (zt.UNAF, 0, 64, 36348),
    (zt.UNAF, 4, 64, 36604),
], ids=["naf", "naf_conditional", "unaf", "unaf_conditional"])
def test_density_plans_the_largest_tile(cls, context, tile, floats):
    """The flagship NAF and UNAF and their conditional (6, 4) forms take the
    tiled density at the largest tile of their kind (128 rows a NAF, 64 a
    UNAF), the sampler's plan at that tile (its floats pinned against
    ``tile_plan``'s sum in the sampler's tests), at most the tile that keeps
    every SM busy: at 4,096 rows 32 and 16."""
    _, kind, made_w, mono_w, F, S, n_stages = _shapes(cls, context)
    assert naf_fused.density_tile_rows(kind, made_w, mono_w, F, context, S, 1 << 20, 132) == tile
    assert naf_fused._tile_floats(kind, made_w, mono_w, F, context, S, tile) == floats
    assert 4 * floats <= SHARED
    small = naf_fused.density_tile_rows(kind, made_w, mono_w, F, context, S, 4096, 132)
    assert small == (32 if kind == "mnn" else 16)
    for rows in (1, 1 << 18, 1 << 20):
        assert naf_fused.plan_naf(kind, made_w, mono_w, F, context, S, n_stages, rows) \
            == _common.narrow_plan(rows)


@pytest.mark.parametrize("cls, kwargs, tile, nbytes", [
    (zt.NAF, {"hidden_features": (256, 256)}, 32, 161680),
    (zt.UNAF, {"hidden_features": (256, 256)}, 32, 163824),
    (zt.NAF, {"network": {"hidden_features": (128, 128)}}, 64, 208656),
    (zt.UNAF, {"network": {"hidden_features": (128,) * 3}}, 16, 220400),
], ids=["naf_made_256", "unaf_made_256", "naf_net_128", "unaf_three_128"])
def test_density_takes_a_smaller_tile_where_the_largest_does_not_fit(cls, kwargs, tile, nbytes):
    """Where the largest tile's shared memory passes 227 KB (MADE widths of
    256, networks of 128), the density takes the largest tile that fits; the
    sampler of the same flow goes wide."""
    _, kind, made_w, mono_w, F, S, n_stages = _shapes(cls, **kwargs)
    assert naf_fused.density_tile_rows(kind, made_w, mono_w, F, 0, S, 1 << 20, 132) == tile
    assert 4 * naf_fused._tile_floats(kind, made_w, mono_w, F, 0, S, tile) == nbytes <= SHARED
    larger = [R for R in naf_fused._TILES[kind] if R > tile]
    assert all(4 * naf_fused._tile_floats(kind, made_w, mono_w, F, 0, S, R) > SHARED
               for R in larger)
    assert not naf_fused.plan_naf(kind, made_w, mono_w, F, 0, S, n_stages, 1 << 16).wide
    assert naf_fused.plan_naf(kind, made_w, mono_w, F, 0, S, n_stages, 1 << 16, sample=True).wide


@pytest.mark.parametrize("cls, kwargs", [
    (zt.NAF, {"network": {"hidden_features": (128,) * 3}}),
    (zt.UNAF, {"network": {"hidden_features": (128,) * 4}}),
], ids=["naf_three_128", "unaf_four_128"])
def test_density_that_fits_no_tile_plans_the_wide_tier(cls, kwargs):
    """Within the narrow limits, a flow whose tiled density fits at no tile
    (its networks' weights and activations alone pass 227 KB) takes the
    wide tier."""
    _, kind, made_w, mono_w, F, S, n_stages = _shapes(cls, **kwargs)
    smallest = naf_fused._TILES[kind][0]
    assert 4 * naf_fused._tile_floats(kind, made_w, mono_w, F, 0, S, smallest) > SHARED
    assert naf_fused.density_tile_rows(kind, made_w, mono_w, F, 0, S, 1 << 20, 132) is None
    plan = naf_fused.plan_naf(kind, made_w, mono_w, F, 0, S, n_stages, 1 << 16)
    assert plan.wide and plan.workspace_bytes <= _common.WORKSPACE_BYTES


@pytest.mark.parametrize("cls, kwargs, rows, tile, counter", [
    (zt.NAF, {}, 1 << 16, 128, "naf_density"),
    (zt.NAF, {}, 4096, 32, "naf_density"),
    (zt.UNAF, {}, 1 << 16, 64, "naf_density_umnn"),
    (zt.UNAF, {"network": {"hidden_features": (128,) * 3}}, 1 << 16, 16, "naf_density_umnn"),
    (zt.UNAF, {"network": {"hidden_features": (128,) * 4}}, 1 << 16, 0, "naf_density_umnn_wide"),
], ids=["naf", "naf_few_rows", "unaf", "unaf_small_tile", "unaf_wide"])
def test_density_hands_its_tile_to_the_kernel(recorded, cls, kwargs, rows, tile, counter):
    """The density launches its narrow tier with the tile of
    ``density_tile_rows`` (the wide tier, where none fits, with 0) and
    counts under its name."""
    flow, *_ = _shapes(cls, **kwargs)
    params, layout, F, S = naf_fused._flatten_naf(flow)
    params = [p.detach().as_subclass(_OnCard) for p in params]
    x = torch.randn(rows, 6).as_subclass(_OnCard)
    naf_fused.naf_density(x, params, layout, F, S)
    [(name, args)] = recorded
    assert name == "naf_density_f32"
    assert len(args) == len(_build._SIGNATURES["naf_fused"]["naf_density_f32"][0])
    assert args[-8] == int(tile == 0) and args[-2] == tile
    assert {k: v for k, v in ops.LAUNCHES.items() if v} == {counter: 1}


def _cnf_widths(make):
    torch.manual_seed(0)
    transform = make().transform
    linears = transform.ode.layers[0::2]
    F = linears[-1].out_features
    return [F] + [layer.out_features for layer in linears], transform.freqs.numel()


@pytest.mark.parametrize("make, row_bias, plan", [
    (lambda: zt.CNF(6, device="cpu"), False, (84, 16384, 16527360, 214520, True, True)),
    (lambda: zt.CNF(6, 4, device="cpu"), True, (276, 16384, 28979200, 214520, True, True)),
    (lambda: zt.CNF(6, 4, exact=False, device="cpu"), True,
     (276, 16384, 28979200, 214520, True, True)),
    (lambda: zt.CNF(8, hidden_features=(128, 96), device="cpu"), False,
     (1304, 16384, 116342784, 113280, True, False)),
], ids=["flagship", "conditional", "hutchinson", "rows_in_workspace"])
def test_cnf_adjoint_plans_a_cluster_a_tile(make, row_bias, plan):
    """The adjoint's narrow tier: a tile of 256 rows is a cluster of 4
    blocks of 64 rows. Shared memory holds the padded linears (``in
    pad8(out) + out pad8(in)`` each: 9,984 floats for the flagship), the
    time-embedding term and the block max, and the rows' columns (``5 F + 4
    sum(hidden) + 2 max(widths)``, 670 floats for the flagship, at a stride
    of 65): 214,520 bytes; a network whose columns do not fit keeps them in
    the workspace. The workspace: ``14 F`` floats a row (``3 H1`` more with
    a per-row first bias, the columns where shared memory does not hold
    them) and ``2 P`` a block."""
    widths, nf = _cnf_widths(make)
    slots, chunk, work, shared, weights_shared, rows_shared = plan
    got = cnf_fused.plan_cnf_adjoint(widths, nf, 1 << 14, True, row_bias)
    assert got == (False, slots, chunk, work, 0, 4, 64, shared, weights_shared, rows_shared)
    F, hidden, H1 = widths[0], widths[1:-1], widths[1]
    pairs = list(zip(widths[:-1], widths[1:]))
    padded = sum(i * -(-o // 8) * 8 + o * -(-i // 8) * 8 for i, o in pairs)
    hot = 5 * F + 4 * sum(hidden) + 2 * max(widths)
    assert shared == 4 * (padded + H1 + 32 + (65 * hot if rows_shared else 0)) <= SHARED
    P = cnf_fused._weights(widths, nf) - (H1 if row_bias else 0)
    assert slots == 14 * F + (3 * H1 if row_bias else 0) + (0 if rows_shared else hot)
    assert work == 4 * (slots * chunk + 2 * P * chunk // 64) <= _common.WORKSPACE_BYTES
    # the same without a trace, and past the narrow limits the wide tier
    assert cnf_fused.plan_cnf_adjoint(widths, nf, 1 << 14, None, row_bias) == got
    assert cnf_fused.plan_cnf_adjoint([F, 256, 256, F], nf, 1 << 14, True, row_bias).wide


def test_padded_weights_hold_each_linear_transposed_and_padded():
    """``_padded_weights``: per linear of the kernel parameters (``W1_x``,
    then ``W2``, ``W3``), ``W^T`` with its rows padded to a multiple of 8,
    then ``W`` likewise, zeros in the padding."""
    torch.manual_seed(0)
    W1x, W2, W3 = torch.randn(64, 6), torch.randn(64, 64), torch.randn(6, 64)
    kp = [W1x, torch.randn(64, 6), torch.randn(64), W2, torch.randn(64), W3, torch.randn(6)]
    got = cnf_fused._padded_weights(kp)
    at = 0
    for W in (W1x, W2, W3):
        for M in (W.T, W):
            block = got[at: at + M.shape[0] * -(-M.shape[1] // 8) * 8].view(M.shape[0], -1)
            assert torch.equal(block[:, : M.shape[1]], M)
            assert not block[:, M.shape[1]:].any()
            at += block.numel()
    assert at == got.numel() == 6 * 64 + 64 * 8 + 2 * 64 * 64 + 64 * 8 + 6 * 64


@pytest.mark.parametrize("context", [None, "rows"], ids=["flagship", "conditional"])
def test_cnf_adjoint_hands_its_plan_to_the_kernel(recorded, context):
    """The adjoint launches its narrow tier with the padded linears, the
    tile of ``TILE`` rows and the plan's workspace; with log q it counts
    under ``cnf_adjoint_log_prob``, without under ``cnf_adjoint``."""
    torch.manual_seed(0)
    n = 300
    flow = zt.CNF(6, 0 if context is None else 4, device="cpu")
    c = None if context is None else torch.randn(n, 4)
    params, _, cfg = cnf_fused._flatten_cnf(flow, flow.transform(c), c)
    card = [p.detach().as_subclass(_OnCard) for p in params]
    x, gx = torch.randn(n, 6).as_subclass(_OnCard), torch.randn(n, 6).as_subclass(_OnCard)
    glq = torch.randn(n).as_subclass(_OnCard)
    cc = None if c is None else c.as_subclass(_OnCard)
    with torch.no_grad():
        cnf_fused.cnf_adjoint(x, gx, glq, None, card, cc, cfg)
        cnf_fused.cnf_adjoint(x, gx, None, None, card, cc, cfg)
    assert [name for name, _ in recorded] == ["cnf_adjoint_f32"] * 2
    kp = cnf_fused._kernel_params(params[0::2], params[1::2], c, cfg)
    plan = cnf_fused.plan_cnf_adjoint(cnf_fused._widths(kp), cfg["nf"], n, True, c is not None)
    for _, args in recorded:
        assert len(args) == len(_build._SIGNATURES["cnf_fused"]["cnf_adjoint_f32"][0])
        assert args[10] is not None  # the padded linears
        assert args[19:22] == (n, cnf_fused.TILE, 0)
        assert args[23:25] == (plan.workspace_bytes // 4, plan.chunk_rows)
        assert (args[4] is None) == (c is None)
    assert {k: v for k, v in ops.LAUNCHES.items() if v} == {
        "cnf_adjoint": 1, "cnf_adjoint_log_prob": 1}


def _nsf_shapes(make):
    torch.manual_seed(0)
    flow = make()
    params, layout, cfg = nsf_fused._flatten_flow(flow)
    F = params[-3].shape[0] // nsf_fused._univ_size(cfg["univ"], cfg["bins"])
    C = params[0].shape[1] - F
    _, widths, passes = nsf_fused._pack_weights(params, layout, F, C, cfg["bins"], cfg["univ"])
    return flow, params, layout, cfg, F, widths, len(passes)


@pytest.mark.parametrize("make, widths, tile, nbytes", [
    (lambda: zt.NSF(6, 0, transforms=3, device="cpu"), [6, 64, 64, 138], 128, 201280),
    (lambda: zt.NSF(3, 5, transforms=3, device="cpu"), [8, 64, 64, 69], 128, 145696),
    (lambda: zt.MAF(6, 0, transforms=3, device="cpu"), [6, 64, 64, 12], 128, 102464),
    (lambda: zt.NSF(6, 0, transforms=3, hidden_features=(128, 128), device="cpu"),
     [6, 128, 128, 138], 32, 196672),
], ids=["flagship", "conditional", "maf", "hidden_128"])
def test_nsf_sampler_plans_the_tiled_tier(make, widths, tile, nbytes):
    """The closed-form sampler's narrow tier is the tiled kernel: a tile of
    128 rows where its shared memory fits 227 KB (the flagship NSF: one
    layer's linears as ``W^T [in][pad8(out)]`` and padded biases, 13,968
    floats, then ``[F + C][R]``, ``[F][R]``, two hidden buffers ``[64][R]``
    and the last linear's outputs ``[144][R]``: 201,280 bytes), else 64 or
    32 (hidden widths of 128: 32). The density plans the same tile
    without the targets ``[F][R]``."""
    _, _, _, cfg, F, got, n_ar = _nsf_shapes(make)
    assert got == widths
    K, univ = cfg["bins"], cfg["univ"]
    T = nsf_fused._univ_size(univ, K)
    weights = sum(i * -(-o // 8) * 8 + -(-o // 8) * 8 for i, o in zip(widths[:-1], widths[1:]))
    hp = -(-max(widths[1:-1]) // 8) * 8
    floats = weights + (widths[0] + F + 2 * hp + -(-F * T // 8) * 8) * tile
    assert nsf_fused._sample_tile_floats(widths, T, tile) == floats and 4 * floats == nbytes
    assert nbytes <= SHARED and nsf_fused.sample_tile_rows(widths, K, univ) == tile
    for rows in (1, 1 << 20):
        plan = nsf_fused.plan_nsf(widths, K, univ, n_ar, rows, SHARED, sample=True)
        assert plan == (False, 0, rows, 0, 0, tile, nbytes)
        assert nsf_fused.plan_nsf(widths, K, univ, n_ar, rows, SHARED) == (
            False, 0, rows, 0, 0, tile, nbytes - 4 * F * tile)


@pytest.mark.parametrize("make, widths, nbytes", [
    (lambda: zt.NSF(6, 0, transforms=3, device="cpu"), [6, 64, 64, 138], 198208),
    (lambda: zt.NSF(3, 5, transforms=3, device="cpu"), [8, 64, 64, 69], 144160),
    (lambda: zt.MAF(6, 0, transforms=3, device="cpu"), [6, 64, 64, 12], 99392),
], ids=["flagship", "conditional", "maf"])
def test_nsf_density_plans_the_tiled_tier(make, widths, nbytes):
    """The closed-form density and apply (affine, RQS) plan the tiled
    kernel, a tile of 128 rows: one layer's staged linears (13,968 floats
    for the flagship NSF), then ``[F + C][R]``, two hidden buffers
    ``[64][R]`` and the last linear's outputs ``[pad8(F T)][R]``, no
    targets (the flagship: 49,552 floats, 198,208 bytes; the conditional
    NSF's 69 outputs pad to 72), at any number of rows."""
    _, _, _, cfg, F, got, n_ar = _nsf_shapes(make)
    assert got == widths
    K, univ = cfg["bins"], cfg["univ"]
    T = nsf_fused._univ_size(univ, K)
    weights = sum(i * -(-o // 8) * 8 + -(-o // 8) * 8 for i, o in zip(widths[:-1], widths[1:]))
    floats = weights + (widths[0] + 2 * 64 + -(-F * T // 8) * 8) * 128
    assert nsf_fused._density_tile_floats(widths, T, 128) == floats and 4 * floats == nbytes
    assert nsf_fused.density_tile_rows(widths, K, univ) == 128
    for rows in (1, 1 << 18, 1 << 20):
        plan = nsf_fused.plan_nsf(widths, K, univ, n_ar, rows, SHARED)
        assert isinstance(plan, nsf_fused.TilePlan) and plan == (False, 0, rows, 0, 0, 128, nbytes)


@pytest.mark.parametrize("make, widths", [
    (lambda: zt.NSF(6, 0, transforms=3, hidden_features=(256, 256), device="cpu"),
     [6, 256, 256, 138]),
    (lambda: zt.NSF(3, 0, transforms=2, bins=40, device="cpu"), [3, 64, 64, 357]),
    (lambda: zt.MAF(6, 0, transforms=3, hidden_features=(300,), device="cpu"), [6, 300, 12]),
], ids=["hidden_256", "bins_40", "width_300"])
def test_nsf_density_past_the_limits_plans_the_wide_tier(make, widths):
    """A closed-form density that fits no tile (hidden widths of 256: 418 KB
    of staged linears) or passes the narrow limits (40 bins, a width of 300)
    plans the wide tier, as the per-thread tier's limits did."""
    _, _, _, cfg, F, got, n_ar = _nsf_shapes(make)
    assert got == widths
    K, univ = cfg["bins"], cfg["univ"]
    plan = nsf_fused.plan_nsf(widths, K, univ, n_ar, 1 << 16, SHARED)
    assert plan.wide and not isinstance(plan, nsf_fused.TilePlan)
    assert plan.workspace_bytes <= _common.WORKSPACE_BYTES


@pytest.mark.parametrize("univ, hidden, tile, nbytes", [
    ("affine", 16, 128, 30272), ("affine", 32, 128, 51264), ("affine", 48, 128, 74304),
    ("affine", 64, 128, 99392), ("affine", 96, 128, 155712), ("affine", 128, 128, 220224),
    ("affine", 160, 64, 205376), ("affine", 192, 32, 217920), ("affine", 224, None, None),
    ("affine", 256, None, None),
    ("rqs", 16, 128, 104512), ("rqs", 32, 128, 133696), ("rqs", 48, 128, 164928),
    ("rqs", 64, 128, 198208), ("rqs", 96, 64, 183360), ("rqs", 128, 32, 195904),
    ("rqs", 160, None, None), ("rqs", 192, None, None), ("rqs", 224, None, None),
    ("rqs", 256, None, None),
])
def test_nsf_density_tile_shrinks_with_the_hidden_width(univ, hidden, tile, nbytes):
    """Six features, two hidden layers of ``hidden`` (8 bins for the
    spline): the tiled density's tile is the largest of 128, 64 and 32 rows
    that fits 227 KB, so it shrinks as the hidden layers widen (the
    spline's 138 outputs a row sooner than the affine map's 12), and past
    the last tile the flow, still within the narrow limits, plans the wide
    tier, at any number of rows."""
    T = nsf_fused._univ_size(univ, 8)
    widths = [6, hidden, hidden, 6 * T]
    assert nsf_fused.density_tile_rows(widths, 8, univ) == tile
    for rows in (1, 1 << 20):
        plan = nsf_fused.plan_nsf(widths, 8, univ, 3, rows, SHARED)
        if tile is None:
            assert plan.wide and not isinstance(plan, nsf_fused.TilePlan)
        else:
            assert plan == (False, 0, rows, 0, 0, tile, nbytes)
            assert nbytes == 4 * nsf_fused._density_tile_floats(widths, T, tile) <= SHARED


@pytest.mark.parametrize("make", [
    lambda: zt.SOSPF(6, 0, transforms=3, polynomials=6, degree=4, device="cpu"),
    lambda: zt.SOSPF(6, 4, transforms=3, polynomials=2, degree=8, device="cpu"),
    lambda: zt.BPF(6, 0, transforms=3, degree=30, device="cpu"),
    lambda: zt.BPF(6, 4, transforms=3, degree=30, device="cpu"),
], ids=["sospf", "sospf_conditional", "bpf_degree_30", "bpf_degree_30_conditional"])
def test_other_densities_keep_the_per_thread_tier(make):
    """A sum of squares' density past the 24 coefficients the tiled kernel
    holds in registers (6 polynomials of degree 4: 30) or past its 8
    Gauss-Legendre nodes (degree 8: 9), and a Bernstein polynomial's past
    its 24 coefficients (degree 30: 36), keep the per-thread narrow tier:
    no tile, at any number of rows."""
    _, _, _, cfg, F, widths, n_ar = _nsf_shapes(make)
    assert not nsf_fused._tiled(cfg["univ"], cfg["bins"])
    for rows in (1, 1 << 20):
        plan = nsf_fused.plan_nsf(widths, cfg["bins"], cfg["univ"], n_ar, rows, SHARED)
        assert plan == (False, 0, rows, 0, 0) and not isinstance(plan, nsf_fused.TilePlan)


def test_nsf_sampler_that_fits_no_tile_plans_the_wide_tier():
    """Hidden widths of 256: one layer's staged linears alone (418 KB) pass
    227 KB, so no tile fits and the sampler takes the wide tier, as the
    density does; the circular sampler, whose tile is the NSF's, takes the
    same wide tier there."""
    _, _, _, cfg, F, widths, n_ar = _nsf_shapes(
        lambda: zt.NSF(6, 0, transforms=3, hidden_features=(256, 256), device="cpu"))
    assert widths == [6, 256, 256, 138]
    assert nsf_fused.sample_tile_rows(widths, 8, "rqs") is None
    plan = nsf_fused.plan_nsf(widths, 8, "rqs", n_ar, 1 << 16, SHARED, sample=True)
    assert plan.wide and not isinstance(plan, nsf_fused.TilePlan)
    assert plan.workspace_bytes <= _common.WORKSPACE_BYTES
    assert plan == nsf_fused.plan_nsf(widths, 8, "rqs", n_ar, 1 << 16, SHARED)
    circular = nsf_fused.plan_nsf(widths, 8, "crqs", n_ar, 1 << 16, SHARED, sample=True)
    assert circular == plan


def test_tiled_weights_hold_each_linear_transposed_and_padded():
    """``_tiled_weights``: per AR layer and linear, ``(M ⊙ W)^T`` with its
    outputs padded to a multiple of 8, then the bias padded likewise, zeros
    in the padding."""
    flow, params, layout, cfg, F, widths, _ = _nsf_shapes(
        lambda: zt.NSF(6, 0, transforms=2, device="cpu"))
    got = nsf_fused._tiled_weights(params, layout)
    at = 0
    for ps, _ in nsf_fused._split_layers(params, layout):
        for i in range(len(ps) // 3):
            W, b, M = ps[3 * i: 3 * i + 3]
            out, inp = W.shape
            dp = -(-out // 8) * 8
            block = got[at: at + inp * dp].view(inp, dp)
            assert torch.equal(block[:, :out], (M * W).T) and not block[:, out:].any()
            bias = got[at + inp * dp: at + inp * dp + dp]
            assert torch.equal(bias[:out], b) and not bias[out:].any()
            at += inp * dp + dp
    assert at == got.numel()


@pytest.mark.parametrize("mode, name, counter", [
    (False, "nsf_sample_f32", "nsf_sample"),
    (True, "nsf_sample_f32", "nsf_sample_log_prob"),
    ("raw", "nsf_sample_raw_f32", "nsf_sample_raw"),
], ids=["sample", "log_prob", "raw"])
def test_nsf_sampler_hands_the_tile_to_the_kernel(recorded, monkeypatch, mode, name, counter):
    """The closed-form sampler launches its narrow tier with the staged
    weights of ``_tiled_weights`` and the tile of 128 rows (the last two
    arguments, after the stream), and counts under its name; so does the
    density, under its own."""
    flow, params, layout, cfg, F, widths, _ = _nsf_shapes(
        lambda: zt.NSF(6, 0, transforms=3, device="cpu"))
    lib = _build.load_library("nsf_fused")
    monkeypatch.setattr(lib, "nsf_max_shared_bytes", lambda device: SHARED)
    card = [p.detach().as_subclass(_OnCard) for p in params]
    z = torch.randn(300, 6).as_subclass(_OnCard)
    st = nsf_fused._statics(cfg, F)
    nsf_fused.nsf_sample(z, card, layout, *st, want_log_prob=mode)
    nsf_fused.nsf_density(z, card, layout, *st)
    [(first, args), (second, dargs)] = recorded
    assert (first, second) == (name, "nsf_density_f32")
    assert len(args) == len(_build._SIGNATURES["nsf_fused"][name][0])
    assert len(dargs) == len(_build._SIGNATURES["nsf_fused"]["nsf_density_f32"][0])
    assert args[-9] == 0 and args[-3] is not None  # the narrow tier; a stream
    for a in (args, dargs):
        assert a[-2] is not None and a[-1] == 128
    assert {k: v for k, v in ops.LAUNCHES.items() if v} == {counter: 1, "nsf_density": 1}


@pytest.mark.parametrize("make, univ, tile", [
    (lambda: zt.NSF(6, 0, transforms=3, device="cpu"), "rqs", 128),
    (lambda: zt.NSF(3, 5, transforms=3, device="cpu"), "rqs", 128),
    (lambda: zt.MAF(6, 0, transforms=3, device="cpu"), "affine", 128),
    (lambda: zt.NCSF(6, 0, transforms=3, device="cpu"), "crqs", 128),
    (lambda: zt.NCSF(6, 4, transforms=3, device="cpu"), "crqs", 128),
    (lambda: zt.BPF(6, 0, transforms=3, device="cpu"), "bernstein", 64),
    (lambda: zt.BPF(6, 4, transforms=3, device="cpu"), "bernstein", 64),
    (lambda: zt.SOSPF(6, 0, transforms=3, device="cpu"), "sosp", 64),
], ids=["flagship", "conditional", "maf", "ncsf", "ncsf_conditional", "bpf", "bpf_conditional",
        "sospf"])
def test_nsf_density_and_apply_hand_the_tile_to_the_kernel(recorded, monkeypatch, make, univ,
                                                            tile):
    """``nsf_density`` and ``nsf_apply`` hand the C entry points the
    buffer ``_tiled_weights`` builds for this call and the tile (the last
    two arguments, after the stream) on the narrow tier, and no packed
    weights (null: the tiled tier reads the staged ones alone): 128 rows for
    the closed-form univariates and the circular spline, 64 for the
    polynomials. Each counts under its mode's names (``nsf_density`` and
    ``nsf_apply`` for the closed-form ones, ``nsf_density_<mode>`` and
    ``nsf_apply_<mode>`` for the others)."""
    flow, params, layout, cfg, F, widths, _ = _nsf_shapes(make)
    assert cfg["univ"] == univ
    lib = _build.load_library("nsf_fused")
    monkeypatch.setattr(lib, "nsf_max_shared_bytes", lambda device: SHARED)
    staged, tiled_weights = [], nsf_fused._tiled_weights
    monkeypatch.setattr(nsf_fused, "_tiled_weights",
                        lambda *a: staged.append(tiled_weights(*a)) or staged[-1])
    card = [p.detach().as_subclass(_OnCard) for p in params]
    xc = torch.randn(300, params[0].shape[1]).as_subclass(_OnCard)
    st = nsf_fused._statics(cfg, F)
    nsf_fused.nsf_density(xc, card, layout, *st)
    nsf_fused.nsf_apply(xc, card, layout, *st)
    assert [name for name, _ in recorded] == ["nsf_density_f32", "nsf_apply_f32"]
    assert len(staged) == 2
    for (name, args), buffer, n_out in zip(recorded, staged, (1, 2)):
        assert len(args) == len(_build._SIGNATURES["nsf_fused"][name][0])
        assert args[-9] == 0 and args[-3] is not None  # the narrow tier; a stream
        assert torch.equal(buffer, tiled_weights(params, layout))
        assert args[-2] == buffer.data_ptr() and args[-1] == tile
        assert args[1 + n_out] is None  # no packed weights
    names = [nsf_fused._counter(k, univ) for k in ("nsf_density", "nsf_apply")]
    assert {k: v for k, v in ops.LAUNCHES.items() if v} == dict.fromkeys(names, 1)


def _tile_plan_floats(widths, F, R):
    """Floats of ``csrc/nsf_fused.cu`` ``tile_plan(d, R, false)``, its
    offsets transcribed: the staged linears, then ``xc``, ``a``, ``b`` and
    ``p`` (no targets ``y``); each offset a multiple of 4 floats."""
    pad8 = lambda v: -(-v // 8) * 8  # noqa: E731
    hidden = max(widths[1:-1], default=0)
    wfloats = sum(i * pad8(o) + pad8(o) for i, o in zip(widths[:-1], widths[1:]))
    xc = wfloats
    a = xc + widths[0] * R
    b = a + pad8(hidden) * R
    p = b + pad8(hidden) * R
    assert all(v % 4 == 0 for v in (wfloats, xc, a, b, p))
    return p + pad8(widths[-1]) * R


@pytest.mark.parametrize("make, widths, tile, nbytes", [
    (lambda: zt.NCSF(6, 0, transforms=3, device="cpu"), [6, 64, 64, 138], 128, 198208),
    (lambda: zt.NCSF(6, 4, transforms=3, device="cpu"), [10, 64, 64, 138], 128, 201280),
    (lambda: zt.BPF(6, 0, transforms=3, device="cpu"), [6, 64, 64, 102], 64, 106400),
    (lambda: zt.BPF(6, 4, transforms=3, device="cpu"), [10, 64, 64, 102], 64, 108448),
], ids=["ncsf", "ncsf_conditional", "bpf", "bpf_conditional"])
def test_ncsf_and_bpf_densities_plan_the_tiled_tier(make, widths, tile, nbytes):
    """The circular spline's density and apply plan the NSF's tiled density
    (T = 23: 128 rows, 198,208 bytes for the flagship NCSF, 201,280 for
    NCSF(6, 4)), and the Bernstein polynomial's (M = 17 raw parameters a
    feature, 22 coefficients in registers) the largest of 64 and 32 rows of
    which two blocks share an SM (106,400 bytes for the flagship BPF,
    108,448 for BPF(6, 4), at most 115,712 each): ``_density_tile_floats``
    is ``tile_plan(d, R, false)`` of the C++ at each tile, and the plan
    holds at any number of rows."""
    _, _, _, cfg, F, got, n_ar = _nsf_shapes(make)
    K, univ = cfg["bins"], cfg["univ"]
    assert got == widths and nsf_fused._tiled(univ, K)
    T = nsf_fused._univ_size(univ, K)
    for R in (32, 64, 128):
        assert nsf_fused._density_tile_floats(widths, T, R) == _tile_plan_floats(widths, F, R)
    assert 4 * _tile_plan_floats(widths, F, tile) == nbytes <= SHARED
    assert nsf_fused.density_tile_rows(widths, K, univ) == tile
    if univ == "bernstein":
        assert nbytes <= (233472 - 2048) // 2
    for rows in (1, (1 << 16) - 37, 1 << 20):
        plan = nsf_fused.plan_nsf(widths, K, univ, n_ar, rows, SHARED)
        assert isinstance(plan, nsf_fused.TilePlan) and plan == (False, 0, rows, 0, 0, tile, nbytes)


@pytest.mark.parametrize("univ, hidden, tile, nbytes", [
    ("crqs", 16, 128, 104512), ("crqs", 64, 128, 198208), ("crqs", 96, 64, 183360),
    ("crqs", 128, 32, 195904), ("crqs", 160, None, None), ("crqs", 256, None, None),
    ("bernstein", 16, 64, 44960), ("bernstein", 32, 64, 63392), ("bernstein", 48, 64, 83872),
    ("bernstein", 64, 64, 106400), ("bernstein", 96, 64, 157600),
    ("bernstein", 128, 64, 216992), ("bernstein", 160, 32, 229536),
    ("bernstein", 192, None, None), ("bernstein", 256, None, None),
])
def test_ncsf_and_bpf_density_tile_shrinks_with_the_hidden_width(univ, hidden, tile, nbytes):
    """Six features, two hidden layers of ``hidden`` (8 bins for the
    circular spline, degree 16 for the Bernstein polynomial): the circular
    spline's density tile is the NSF's, the largest of 128, 64 and 32 rows
    that fits 227 KB; the Bernstein polynomial's is 64 or 32 rows where two
    blocks share an SM (to hidden widths of 64, even where 128 rows would
    fit), else the largest that fits alone (96 and 128: 64 rows; 160: 32),
    and past the last tile the flow, still within the narrow limits, plans
    the wide tier, at any number of rows."""
    K = 8 if univ == "crqs" else 17
    T = nsf_fused._univ_size(univ, K)
    widths = [6, hidden, hidden, 6 * T]
    assert nsf_fused.density_tile_rows(widths, K, univ) == tile
    if univ == "bernstein" and tile is not None:
        two = 4 * nsf_fused._density_tile_floats(widths, T, 32) <= (233472 - 2048) // 2
        assert (nbytes <= (233472 - 2048) // 2) == two
    for rows in (1, 1 << 20):
        plan = nsf_fused.plan_nsf(widths, K, univ, 3, rows, SHARED)
        if tile is None:
            assert plan.wide and not isinstance(plan, nsf_fused.TilePlan)
        else:
            assert plan == (False, 0, rows, 0, 0, tile, nbytes)
            assert nbytes == 4 * _tile_plan_floats(widths, 6, tile) <= SHARED


@pytest.mark.parametrize("make, widths, nbytes", [
    (lambda: zt.SOSPF(6, 0, transforms=3, device="cpu"), [6, 64, 64, 96], 102272),
    (lambda: zt.SOSPF(6, 4, transforms=3, device="cpu"), [10, 64, 64, 96], 104320),
], ids=["sospf", "sospf_conditional"])
def test_sosp_density_plans_the_tiled_tier(make, widths, nbytes):
    """The sum of squares' density and apply (P (L + 1) = 15 coefficients
    and the shift, T = 16 raw parameters a feature) plan the tiled density
    at 64 rows, two blocks an SM as the polynomial samplers do: 10,848
    floats of linears for the flagship SOSPF, then ``[F + C][R]``, two
    hidden buffers ``[64][R]`` and the last linear's outputs ``[96][R]``:
    102,272 bytes (104,320 for SOSPF(6, 4)), at most 115,712;
    ``_density_tile_floats`` is ``tile_plan(d, R, false)`` of the C++ at
    each tile, and the plan holds at any number of rows."""
    _, _, _, cfg, F, got, n_ar = _nsf_shapes(make)
    K, univ = cfg["bins"], cfg["univ"]
    assert got == widths and univ == "sosp" and K == (3, 5) and nsf_fused._tiled(univ, K)
    T = nsf_fused._univ_size(univ, K)
    assert T == 16
    for R in (32, 64, 128):
        assert nsf_fused._density_tile_floats(widths, T, R) == _tile_plan_floats(widths, F, R)
    assert 4 * _tile_plan_floats(widths, F, 64) == nbytes <= (233472 - 2048) // 2
    assert 4 * _tile_plan_floats(widths, F, 128) <= SHARED  # 64 rows by choice, not by room
    assert nsf_fused.density_tile_rows(widths, K, univ) == 64
    for rows in (1, (1 << 16) - 37, 1 << 20):
        plan = nsf_fused.plan_nsf(widths, K, univ, n_ar, rows, SHARED)
        assert isinstance(plan, nsf_fused.TilePlan) and plan == (False, 0, rows, 0, 0, 64, nbytes)


@pytest.mark.parametrize("make, widths, tile, nbytes", [
    (lambda: zt.BPF(6, 0, transforms=3, device="cpu"), [6, 64, 64, 102], 64, 107936),
    (lambda: zt.BPF(6, 4, transforms=3, device="cpu"), [10, 64, 64, 102], 64, 109984),
    (lambda: zt.BPF(3, 0, transforms=3, degree=18, device="cpu"), [3, 64, 64, 57], 64, 84992),
    (lambda: zt.BPF(6, 0, transforms=3, hidden_features=(128, 128), device="cpu"),
     [6, 128, 128, 102], 64, 218528),
], ids=["flagship", "conditional", "degree_18", "hidden_128"])
def test_bernstein_sampler_plans_the_tiled_tier(make, widths, tile, nbytes):
    """The Bernstein sampler's narrow tier is the tiled kernel where its
    ``M + 5`` coefficients fit the registers (at most 24: degree 18): the
    closed-form sampler's tile with ``T = M`` raw parameters a feature (the
    flagship BPF, M = 17: 11,368 floats of linears, then ``[F + C][R]``,
    ``[F][R]``, two hidden buffers ``[64][R]`` and the last linear's outputs
    ``[104][R]``: 107,936 bytes at 64 rows), the largest of 64 and 32 rows
    of which two blocks share an SM (at most 115,712 bytes each), else the
    largest tile that fits 227 KB (hidden widths of 128: 64 rows alone).
    The density plans the same tile without the targets ``[F][R]``."""
    _, _, _, cfg, F, got, n_ar = _nsf_shapes(make)
    assert got == widths and cfg["univ"] == "bernstein"
    K = cfg["bins"]
    assert K + 5 <= 24 and nsf_fused._tiled("bernstein", K)
    floats = nsf_fused._sample_tile_floats(widths, K, tile)
    assert 4 * floats == nbytes <= SHARED
    assert nsf_fused.sample_tile_rows(widths, K, "bernstein") == tile
    two = 4 * nsf_fused._sample_tile_floats(widths, K, 32) <= (233472 - 2048) // 2
    assert (nbytes <= (233472 - 2048) // 2) == two
    for rows in (1, 1 << 14, 1 << 18):
        plan = nsf_fused.plan_nsf(widths, K, "bernstein", n_ar, rows, SHARED, sample=True)
        assert plan == (False, 0, rows, 0, 0, tile, nbytes)
        assert nsf_fused.plan_nsf(widths, K, "bernstein", n_ar, rows, SHARED) == (
            False, 0, rows, 0, 0, tile, nbytes - 4 * F * tile)


@pytest.mark.parametrize("make", [
    lambda: zt.BPF(3, 0, transforms=3, degree=19, device="cpu"),
    lambda: zt.BPF(3, 0, transforms=3, degree=27, device="cpu"),
    lambda: zt.BPF(3, 0, transforms=3, degree=58, device="cpu"),
], ids=["degree_19", "degree_27", "degree_58"])
def test_bernstein_sampler_past_its_registers_keeps_the_per_thread_kernel(make):
    """25 to 64 Bernstein coefficients (degrees 19-58) do not fit the
    tiled sampler's registers but fit the per-thread kernel's arrays: the
    sampler plans that narrow tier, as the sum of squares does, and the
    density its own, the same."""
    _, _, _, cfg, F, widths, n_ar = _nsf_shapes(make)
    K = cfg["bins"]
    assert 24 < K + 5 <= 64 and not nsf_fused._tiled("bernstein", K)
    for rows in (1 << 14, 1 << 18):
        plan = nsf_fused.plan_nsf(widths, K, "bernstein", n_ar, rows, SHARED, sample=True)
        assert plan == _common.narrow_plan(rows)
        assert nsf_fused.plan_nsf(widths, K, "bernstein", n_ar, rows, SHARED) == plan


@pytest.mark.parametrize("make", [
    lambda: zt.BPF(3, 0, transforms=3, degree=59, device="cpu"),
    lambda: zt.BPF(4, degree=60, device="cpu"),
], ids=["degree_59", "degree_60"])
def test_bernstein_sampler_past_its_registers_plans_the_wide_tier(make):
    """65 or more Bernstein coefficients (degree 59; phase 12's
    ``BPF(4, degree=60)``, 66) fit neither the tiled sampler's registers
    nor the per-thread kernel's arrays: the sampler and the density take
    the wide tier."""
    _, _, _, cfg, F, widths, n_ar = _nsf_shapes(make)
    K = cfg["bins"]
    assert K + 5 > 64 and not nsf_fused._tiled("bernstein", K)
    plan = nsf_fused.plan_nsf(widths, K, "bernstein", n_ar, 1 << 14, SHARED, sample=True)
    assert plan.wide and not isinstance(plan, nsf_fused.TilePlan)
    assert plan.workspace_bytes <= _common.WORKSPACE_BYTES
    assert nsf_fused.plan_nsf(widths, K, "bernstein", n_ar, 1 << 14, SHARED).wide


@pytest.mark.parametrize("make, widths, tile, nbytes", [
    (lambda: zt.NCSF(6, 0, transforms=3, device="cpu"), [6, 64, 64, 138], 128, 201280),
    (lambda: zt.NCSF(6, 4, transforms=3, device="cpu"), [10, 64, 64, 138], 128, 204352),
    (lambda: zt.SOSPF(6, 0, transforms=3, device="cpu"), [6, 64, 64, 96], 64, 103808),
    (lambda: zt.SOSPF(6, 4, transforms=3, device="cpu"), [10, 64, 64, 96], 64, 105856),
], ids=["ncsf", "ncsf_conditional", "sospf", "sospf_conditional"])
def test_circular_and_sosp_samplers_plan_the_tiled_tier(make, widths, tile, nbytes):
    """The circular spline's sampler takes the NSF's tile (T = 3K - 1 = 23
    raw parameters a feature: 128 rows, 201,280 bytes for the flagship
    NCSF), and the sum of squares' (P (L + 1) = 15 coefficients in
    registers, T = 16 with the shift) the Bernstein polynomial's plan: the
    largest of 64 and 32 rows of which two blocks share an SM (the flagship
    SOSPF: 10,848 floats of linears, then ``[F + C][R]``, ``[F][R]``, two
    hidden buffers ``[64][R]`` and the last linear's outputs ``[96][R]``:
    103,808 bytes at 64 rows). Each density plans the same tile without the
    targets ``[F][R]``."""
    _, _, _, cfg, F, got, n_ar = _nsf_shapes(make)
    K, univ = cfg["bins"], cfg["univ"]
    assert got == widths and nsf_fused._tiled(univ, K)
    T = nsf_fused._univ_size(univ, K)
    assert 4 * nsf_fused._sample_tile_floats(widths, T, tile) == nbytes <= SHARED
    assert nsf_fused.sample_tile_rows(widths, K, univ) == tile
    if univ == "sosp":
        assert K == (3, 5) and K[0] * K[1] <= 24 and nbytes <= (233472 - 2048) // 2
    for rows in (1, 1 << 14, 1 << 20):
        plan = nsf_fused.plan_nsf(widths, K, univ, n_ar, rows, SHARED, sample=True)
        assert plan == (False, 0, rows, 0, 0, tile, nbytes)
        assert nsf_fused.plan_nsf(widths, K, univ, n_ar, rows, SHARED) == (
            False, 0, rows, 0, 0, tile, nbytes - 4 * F * tile)


@pytest.mark.parametrize("make", [
    lambda: zt.NCSF(4, 2, bins=40, device="cpu"),
    lambda: zt.NCSF(3, 0, transforms=3, bins=33, device="cpu"),
], ids=["bins_40", "bins_33"])
def test_circular_sampler_past_its_bins_plans_the_wide_tier(make):
    """Past 32 bins (phase 12's ``NCSF(4, 2, bins=40)``) the circular spline
    fits neither tile nor narrow arrays: the sampler takes the wide tier, as
    the density does."""
    _, _, _, cfg, F, widths, n_ar = _nsf_shapes(make)
    K = cfg["bins"]
    assert cfg["univ"] == "crqs" and K > 32 and nsf_fused._tiled("crqs", K)
    plan = nsf_fused.plan_nsf(widths, K, "crqs", n_ar, 1 << 14, SHARED, sample=True)
    assert plan.wide and not isinstance(plan, nsf_fused.TilePlan)
    assert plan.workspace_bytes <= _common.WORKSPACE_BYTES
    assert plan == nsf_fused.plan_nsf(widths, K, "crqs", n_ar, 1 << 14, SHARED)


@pytest.mark.parametrize("make, coefficients", [
    (lambda: zt.SOSPF(4, polynomials=6, degree=4, device="cpu"), 30),
    (lambda: zt.SOSPF(3, 0, transforms=3, polynomials=5, degree=4, device="cpu"), 25),
    (lambda: zt.SOSPF(3, 0, transforms=3, polynomials=2, degree=15, device="cpu"), 32),
    (lambda: zt.SOSPF(3, 0, transforms=3, polynomials=2, degree=8, device="cpu"), 18),
], ids=["p6_degree_4", "p5_degree_4", "p2_degree_15", "p2_degree_8"])
def test_sosp_sampler_past_its_registers_keeps_the_per_thread_kernel(make, coefficients):
    """More than 24 sum-of-squares coefficients P (L + 1) (phase 12's
    ``SOSPF(4, polynomials=6, degree=4)``: 30), or more than the 8
    Gauss-Legendre nodes L + 1 the tiled kernel unrolls (degree 8), do not
    fit the tiled sampler's registers but fit the per-thread kernel's
    arrays: the sampler plans that narrow tier, as the density its own."""
    _, _, _, cfg, F, widths, n_ar = _nsf_shapes(make)
    K = cfg["bins"]
    assert K[0] * K[1] == coefficients and not nsf_fused._tiled("sosp", K)
    for rows in (1 << 14, 1 << 18):
        plan = nsf_fused.plan_nsf(widths, K, "sosp", n_ar, rows, SHARED, sample=True)
        assert plan == _common.narrow_plan(rows)
        assert nsf_fused.plan_nsf(widths, K, "sosp", n_ar, rows, SHARED) == plan


@pytest.mark.parametrize("make", [
    lambda: zt.SOSPF(4, polynomials=8, degree=15, device="cpu"),
    lambda: zt.SOSPF(3, 0, transforms=3, polynomials=3, degree=31, device="cpu"),
], ids=["t_129", "t_97"])
def test_sosp_sampler_past_the_narrow_limits_plans_the_wide_tier(make):
    """A sum of squares of more than 95 raw parameters a feature (phase
    12's ``SOSPF(4, polynomials=8, degree=15)``: T = 129) fits neither the
    registers nor the per-thread arrays: the sampler and the density take
    the wide tier."""
    _, _, _, cfg, F, widths, n_ar = _nsf_shapes(make)
    K = cfg["bins"]
    assert nsf_fused._univ_size("sosp", K) > 95 and not nsf_fused._tiled("sosp", K)
    plan = nsf_fused.plan_nsf(widths, K, "sosp", n_ar, 1 << 14, SHARED, sample=True)
    assert plan.wide and not isinstance(plan, nsf_fused.TilePlan)
    assert plan.workspace_bytes <= _common.WORKSPACE_BYTES
    assert nsf_fused.plan_nsf(widths, K, "sosp", n_ar, 1 << 14, SHARED).wide


@pytest.mark.parametrize("make, code, K, tile", [
    (lambda: zt.NCSF(6, 0, transforms=3, device="cpu"), 2, (8, 0), 128),
    (lambda: zt.SOSPF(6, 0, transforms=3, device="cpu"), 3, (3, 5), 64),
], ids=["ncsf", "sospf"])
@pytest.mark.parametrize("mode, name, kind", [
    (False, "nsf_sample_f32", "nsf_sample"),
    (True, "nsf_sample_f32", "nsf_sample_log_prob"),
    ("raw", "nsf_sample_raw_f32", "nsf_sample_raw"),
], ids=["sample", "log_prob", "raw"])
def test_circular_and_sosp_samplers_hand_the_tile_to_the_kernel(recorded, monkeypatch, make, code,
                                                                K, tile, mode, name, kind):
    """The NCSF and SOSPF samplers launch their tiled tier with the staged
    weights of ``_tiled_weights`` and their tile (the last two arguments,
    after the stream), the univariate's code and sizes (NCSF: 2, K = 8, the
    box base; SOSPF: 3, P = 3, L + 1 = 5), and count under their mode's
    name."""
    flow, params, layout, cfg, F, widths, _ = _nsf_shapes(make)
    lib = _build.load_library("nsf_fused")
    monkeypatch.setattr(lib, "nsf_max_shared_bytes", lambda device: SHARED)
    card = [p.detach().as_subclass(_OnCard) for p in params]
    z = torch.rand(300, 6).as_subclass(_OnCard)
    nsf_fused.nsf_sample(z, card, layout, *nsf_fused._statics(cfg, F), want_log_prob=mode)
    [(first, args)] = recorded
    assert first == name and len(args) == len(_build._SIGNATURES["nsf_fused"][name][0])
    assert args[13] == code and (args[11], args[12]) == K
    assert args[18] == (code == 2)  # the box base
    assert args[-9] == 0 and args[-3] is not None  # the narrow tier; a stream
    assert args[-2] is not None and args[-1] == tile
    assert {k: v for k, v in ops.LAUNCHES.items() if v} == {
        nsf_fused._counter(kind, cfg["univ"]): 1}


@pytest.mark.parametrize("mode, name, kind", [
    (False, "nsf_sample_f32", "nsf_sample"),
    (True, "nsf_sample_f32", "nsf_sample_log_prob"),
    ("raw", "nsf_sample_raw_f32", "nsf_sample_raw"),
], ids=["sample", "log_prob", "raw"])
def test_bernstein_sampler_hands_the_tile_to_the_kernel(recorded, monkeypatch, mode, name, kind):
    """The BPF sampler launches its tiled tier with the staged weights of
    ``_tiled_weights`` and the tile of 64 rows (the last two arguments,
    after the stream), the univariate's code 4 and M = 17, and counts under
    its mode's name, with no packed weights (null); a SOSPF past the
    registers (P (L + 1) = 30, the per-thread kernel) takes neither the
    staged weights nor a tile, but the packed weights."""
    flow, params, layout, cfg, F, widths, _ = _nsf_shapes(
        lambda: zt.BPF(6, 0, transforms=3, device="cpu"))
    lib = _build.load_library("nsf_fused")
    monkeypatch.setattr(lib, "nsf_max_shared_bytes", lambda device: SHARED)
    card = [p.detach().as_subclass(_OnCard) for p in params]
    z = torch.randn(300, 6).as_subclass(_OnCard)
    nsf_fused.nsf_sample(z, card, layout, *nsf_fused._statics(cfg, F), want_log_prob=mode)
    sflow, sparams, slayout, scfg, _, _, _ = _nsf_shapes(
        lambda: zt.SOSPF(6, 0, transforms=3, polynomials=6, degree=4, device="cpu"))
    scard = [p.detach().as_subclass(_OnCard) for p in sparams]
    nsf_fused.nsf_sample(z, scard, slayout, *nsf_fused._statics(scfg, F), want_log_prob=mode)
    [(first, args), (second, sargs)] = recorded
    assert first == second == name
    assert len(args) == len(sargs) == len(_build._SIGNATURES["nsf_fused"][name][0])
    assert args[13] == 4 and args[11] == 17  # bernstein, M
    assert args[-9] == 0 and args[-3] is not None  # the narrow tier; a stream
    assert args[-2] is not None and args[-1] == 64 and args[3] is None  # no packed weights
    assert sargs[-9] == 0 and sargs[-2] is None and sargs[-1] == 0 and sargs[3] is not None
    assert {k: v for k, v in ops.LAUNCHES.items() if v} == {
        nsf_fused._counter(kind, "bernstein"): 1, nsf_fused._counter(kind, "sosp"): 1}


@pytest.mark.parametrize("make, plan", [
    (lambda: zt.CNF(6, device="cpu"), (4, 64, 6, 186752)),
    (lambda: zt.CNF(6, 4, device="cpu"), (4, 64, 6, 186752)),
    (lambda: zt.CNF(6, 4, exact=False, device="cpu"), (4, 64, 1, 104832)),
    (lambda: zt.CNF(8, hidden_features=(128, 96), device="cpu"), (4, 64, 1, 204416)),
    (lambda: zt.CNF(16, hidden_features=(128, 128), device="cpu"), (8, 32, 4, 220800)),
], ids=["flagship", "conditional", "hutchinson", "one_column", "blocks_of_32"])
def test_cnf_density_plans_a_cluster_a_tile(make, plan):
    """K10's narrow tier: a tile of 256 rows is a cluster of 4 blocks of 64
    rows (8 of 32 where 64 do not fit). Shared memory holds each linear's
    ``W^T [in][pad8(out)]`` (4,992 floats for the flagship), the
    time-embedding term and the block max, then the rows' columns (``3 F +
    1 + 7 (F + 1) + pad8(widest hidden) + sum(hidden) + F``, 266 for the
    flagship) and the exact trace's tangents, ``pad8(widest hidden)`` rows
    of ``nc rb`` columns: all F columns in one pass for the flagship, one
    with Hutchinson's trace, fewer a pass where 227 KB cannot hold them.
    The sampler (K11) with log q carries the same trace and plans the same;
    without it see :func:`test_cnf_sampler_plans_a_cluster_a_tile`."""
    torch.manual_seed(0)
    transform = make().transform
    widths, nf = _cnf_widths(make)
    cluster, rb, nc, nbytes = plan
    got = cnf_fused.plan_cnf(widths, nf, 1 << 14, exact=transform.exact)
    assert got == (False, 0, 1 << 14, 0, 0, cluster, rb, nc, nbytes)
    F, hidden = widths[0], widths[1:-1]
    hp = -(-max(hidden) // 8) * 8
    weights = sum(i * -(-o // 8) * 8 for i, o in zip(widths[:-1], widths[1:]))
    rows = 3 * F + 1 + 7 * (F + 1) + hp + sum(hidden) + F
    assert nbytes == 4 * (weights + widths[1] + 32 + rows * rb + hp * nc * rb) <= SHARED
    untraced = cnf_fused.plan_cnf(widths, nf, 1 << 14, exact=None)
    assert untraced[:5] == (False, 0, 1 << 14, 0, 0) and untraced.columns == 0
    assert untraced.cluster * untraced.block_rows == cnf_fused.TILE
    assert untraced.shared_bytes < nbytes
    wide = cnf_fused.plan_cnf([F, 256, 256, F], nf, 1 << 14)
    assert wide.wide and wide.cluster == 0


@pytest.mark.parametrize("make, nbytes", [
    (lambda: zt.CNF(6, device="cpu"), 50560),
    (lambda: zt.CNF(6, 4, device="cpu"), 50560),
    (lambda: zt.CNF(6, 4, exact=False, device="cpu"), 50560),
    (lambda: zt.CNF(8, hidden_features=(128, 96), device="cpu"), 108160),
    (lambda: zt.CNF(16, hidden_features=(128, 128), device="cpu"), 152192),
], ids=["flagship", "conditional", "hutchinson", "wider", "features_16"])
@pytest.mark.parametrize("exact", [True, None], ids=["log_q", "no_log_q"])
def test_cnf_sampler_plans_a_cluster_a_tile(make, nbytes, exact):
    """K11's narrow tier is K10's cluster tier: with log q the exact trace
    (or Hutchinson's) plans as the density does; without it a tile of 256
    rows is a cluster of 4 blocks of 64 rows whose shared memory holds the
    linears ``W^T [in][pad8(out)]``, the time-embedding term, the block max
    and only ``2 F + 7 F + pad8(widest hidden)`` floats a row (x, the stage
    inputs, the slopes of x, the activations): no probe, l, ELU derivatives
    or tangents; past the narrow limits the wide tier."""
    torch.manual_seed(0)
    transform = make().transform
    widths, nf = _cnf_widths(make)
    trace = None if exact is None else transform.exact
    got = cnf_fused.plan_cnf(widths, nf, 1 << 14, exact=trace)
    F, hidden = widths[0], widths[1:-1]
    hp = -(-max(hidden) // 8) * 8
    weights = sum(i * -(-o // 8) * 8 for i, o in zip(widths[:-1], widths[1:]))
    if exact is None:
        assert got == (False, 0, 1 << 14, 0, 0, 4, 64, 0, nbytes)
        assert nbytes == 4 * (weights + hp + 32 + (9 * F + hp) * 64) <= SHARED
    else:
        rb, nc, floats = cnf_fused._cluster_tile(widths, trace)
        assert got == (False, 0, 1 << 14, 0, 0, cnf_fused.TILE // rb, rb, nc, 4 * floats)
        assert got.shared_bytes > nbytes
    wide = cnf_fused.plan_cnf([F, 256, 256, F], nf, 1 << 14, exact=trace)
    assert wide.wide and wide.cluster == 0 and wide.chunk_rows % cnf_fused.TILE == 0


@pytest.mark.parametrize("context", [None, "rows"], ids=["flagship", "conditional"])
def test_cnf_density_hands_its_cluster_to_the_kernel(recorded, context):
    """The density launches its cluster tier with the padded linears and
    the tile of ``TILE`` rows (the last two arguments), counted under
    ``cnf_density``; so does the sampler, under ``cnf_sample_log_prob``."""
    torch.manual_seed(0)
    n = 300
    flow = zt.CNF(6, 0 if context is None else 4, device="cpu")
    c = None if context is None else torch.randn(n, 4)
    params, _, cfg = cnf_fused._flatten_cnf(flow, flow.transform(c), c)
    card = [p.detach().as_subclass(_OnCard) for p in params]
    x = torch.randn(n, 6).as_subclass(_OnCard)
    cc = None if c is None else c.as_subclass(_OnCard)
    with torch.no_grad():
        cnf_fused.cnf_density(x, None, card, cc, cfg)
        cnf_fused.cnf_sample(x, None, card, cc, cfg, True)
    [(first, args), (second, sargs)] = recorded
    assert (first, second) == ("cnf_density_f32", "cnf_sample_f32")
    sig = _build._SIGNATURES["cnf_fused"]
    assert len(args) == len(sig[first][0]) and len(sargs) == len(sig[second][0])
    assert args[-9] == 0 and args[-2] is not None and args[-1] == cnf_fused.TILE
    assert sargs[-9] == 0 and sargs[-2] is not None and sargs[-1] == cnf_fused.TILE
    assert (args[2] is None) == (c is None)  # a per-row first bias
    assert {k: v for k, v in ops.LAUNCHES.items() if v} == {
        "cnf_density": 1, "cnf_sample_log_prob": 1}


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "hutchinson"])
@pytest.mark.parametrize("want", [False, True], ids=["sample", "log_prob"])
def test_cnf_sampler_hands_its_cluster_to_the_kernel(recorded, exact, want):
    """The sampler launches its cluster tier with the padded linears of
    ``_padded_weights`` and the tile of ``TILE`` rows (the last two
    arguments), the trace code of its mode (0 without log q, whatever the
    flow's trace) and the probe only with Hutchinson's trace and log q;
    counted under ``cnf_sample`` or ``cnf_sample_log_prob``."""
    torch.manual_seed(0)
    n = 300
    flow = zt.CNF(6, 4, exact=exact, device="cpu")
    c = torch.randn(n, 4)
    t = flow.transform(c, generator=torch.Generator().manual_seed(0))
    params, _, cfg = cnf_fused._flatten_cnf(flow, t, c)
    card = [p.detach().as_subclass(_OnCard) for p in params]
    z, eps = (torch.randn(n, 6).as_subclass(_OnCard) for _ in range(2))
    with torch.no_grad():
        cnf_fused.cnf_sample(z, eps, card, c.as_subclass(_OnCard), cfg, want)
    [(name, args)] = recorded
    assert name == "cnf_sample_f32"
    assert len(args) == len(_build._SIGNATURES["cnf_fused"][name][0])
    kp = cnf_fused._kernel_params(params[0::2], params[1::2], c, cfg)
    padded = args[-2].value if hasattr(args[-2], "value") else args[-2]
    assert padded is not None and args[-1] == cnf_fused.TILE and args[-9] == 0
    assert args[14] == (cnf_fused._TRACE_CODE[exact] if want else 0)
    assert (args[1] is not None) == (want and not exact)  # the probe
    assert (args[4] is not None) == want  # log q
    assert args[2] is not None  # the per-row first bias
    plan = cnf_fused.plan_cnf(cnf_fused._widths(kp), cfg["nf"], n, exact=exact if want else None)
    assert not plan.wide and plan.cluster * plan.block_rows == cnf_fused.TILE
    counter = "cnf_sample_log_prob" if want else "cnf_sample"
    assert {k: v for k, v in ops.LAUNCHES.items() if v} == {counter: 1}


def _gf_layout(make, c=None):
    torch.manual_seed(0)
    with torch.no_grad():
        params, layout, F, _ = gf_fused._flatten_gf(make(), c)
    return params, layout, F


@pytest.mark.parametrize("make, context, nbytes", [
    (lambda: zt.GF(6, 0, transforms=3, components=8, device="cpu"), None, 9360),
    (lambda: zt.GF(6, 4, transforms=3, device="cpu"), torch.zeros(5, 4), 9360),
], ids=["flagship", "conditional"])
def test_gf_sampler_plans_the_tiled_tier(make, context, nbytes):
    """The GF sampler's narrow tier is tiled where every gaussianization
    layer has the same K <= 16 components (the flagship's and GF(6, 4)'s 8,
    under a batched context too): a tile of 128 rows whose shared memory
    holds the values, a rotation's output and the ladjs, ``[F][R]`` each,
    and the rotation ``[F][F]`` (``tile_plan`` in ``csrc/gf_fused.cu``:
    9,360 bytes for F = 6, 114,688 for F = 64), at any number of rows; the
    density keeps its narrow tier. Layers of 17 to 32 components, or of
    different counts, keep the per-row narrow sampler; past the narrow
    limits (65 features) the wide tier."""
    _, layout, F = _gf_layout(make, context)
    kinds = {entry[0] for entry in layout}
    assert F == 6 and kinds == {"gauss" if context is None else "gaussb", "rot"}
    assert {entry[1] for entry in layout if entry[0] != "rot"} == {8}
    tile = gf_fused._GF_TILE
    assert tile == 128 and gf_fused._GF_REGS == 16
    for R in (32, 64, 128):  # tile_plan: y, t and lad at 0, F R and 2 F R, then rot
        assert gf_fused._tile_floats(F, R) == 3 * F * R + F * F
    assert 4 * gf_fused._tile_floats(F, tile) == nbytes
    assert 4 * gf_fused._tile_floats(64, tile) == 114688 <= SHARED
    for rows in (1, (1 << 18) - 37, 1 << 20):
        plan = gf_fused.plan_gf(layout, F, rows, sample=True)
        assert isinstance(plan, nsf_fused.TilePlan) and plan == (False, 0, rows, 0, 0, tile, nbytes)
        assert gf_fused.plan_gf(layout, F, rows) == _common.narrow_plan(rows)
    for other in ([(kind, 24) if kind != "rot" else (kind,) for kind, *_ in layout],
                  [layout[0], layout[1], (layout[2][0], 4)] + list(layout[3:])):
        assert gf_fused.plan_gf(tuple(other), F, 1 << 20, sample=True) == _common.narrow_plan(1 << 20)
    assert gf_fused.plan_gf(layout, 65, 1 << 20, sample=True).wide


def test_gf_sampler_hands_its_tile_to_the_kernel(recorded):
    """The GF sampler launches its tiled tier with the tile of its plan (the
    last argument, after the stream) in both modes, and a GF of 24
    components (the per-row narrow sampler) with 0; the density's entry
    point takes no tile. Each counts under its name."""
    params, layout, F = _gf_layout(lambda: zt.GF(6, 0, transforms=3, components=8, device="cpu"))
    card = [p.detach().as_subclass(_OnCard) for p in params]
    z = torch.randn(300, F).as_subclass(_OnCard)
    gf_fused.gf_sample(z, card, layout, F)
    gf_fused.gf_sample(z, card, layout, F, want_log_prob=True)
    gf_fused.gf_density(z, card, layout, F)
    wparams, wlayout, _ = _gf_layout(
        lambda: zt.GF(6, 0, transforms=2, components=24, device="cpu"))
    gf_fused.gf_sample(z, [p.detach().as_subclass(_OnCard) for p in wparams], wlayout, F)
    names = [name for name, _ in recorded]
    assert names == ["gf_sample_f32", "gf_sample_f32", "gf_density_f32", "gf_sample_f32"]
    sig = _build._SIGNATURES["gf_fused"]
    for name, args in recorded:
        assert len(args) == len(sig[name][0])
    for _, args in recorded[:2]:
        assert args[-8] == 0 and args[-2] is not None  # the narrow tier; a stream
        assert args[-1] == gf_fused._GF_TILE == 128
    assert recorded[1][1][2] is not None  # log q
    assert recorded[2][1][-7] == 0 and recorded[3][1][-1] == 0
    assert {k: v for k, v in ops.LAUNCHES.items() if v} == {
        "gf_sample": 2, "gf_sample_log_prob": 1, "gf_density": 1}
