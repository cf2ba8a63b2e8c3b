r"""The IFT backward at a kink of a MADE's ReLU (``zuko_tpu_torch.ops.ift``),
on the CPU and without ``zuko_tpu``.

A row whose hidden pre-activation lies within float32 rounding of the ReLU's
kink can take the other side in a float32 backward than in float64 at the
same root, and its whole parameter term then comes from the other branch.
On a reverse-KL loss, whose parameter gradients are sums of terms that
cancel, one such row moves a gradient by far more than float32 rounding
does. The float32 backward takes the ReLUs' sides of the rows near a kink
from a float64 march; these tests hold it against the float64 backward at
the same root, parameters
max-relative (each parameter's largest ``|diff|`` over its largest
``|gradient|``) within 1e-4, as ``chip_smoke.py`` holds the card.
"""

from pathlib import Path

import pytest
import torch

import zuko_tpu_torch as zt

from zuko_tpu_torch.ops import ift, naf_fused
from zuko_tpu_torch.ops import nsf_fused as nf

torch.set_num_threads(1)

TOL = 1e-4

# A root of the BPF flagship (float32 values) whose second layer's MADE has a
# hidden unit 2.4e-7 from its kink: float32 and float64 march it to
# opposite sides of it.
KINK_ROW = [-1.1813246011734009, -0.913875162601471, 0.6208949685096741, -1.029905915260315,
            -1.3483611345291138, 0.2190311998128891]


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


def _max_relative(got, want):
    return max(((a.double() - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
               for a, b in zip(got, want) if b is not None)


def _bpf():
    flow = zt.BPF(6, 0, transforms=3, device="cpu")
    zt.load_params(flow, Path(__file__).resolve().parents[1] / "zuko_tpu_torch" / "assets"
                   / "bpf_flagship.npz")
    params, layout, cfg = nf._flatten_flow(flow)
    return [p.detach() for p in params], layout, nf._statics(cfg, 6)


def _bpf_at_a_kink():
    """The BPF flagship's IFT at 32 roots, the first of them ``KINK_ROW``,
    and their draws (the float64 forward of the roots)."""
    params, layout, st = _bpf()
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        x = torch.cat([torch.tensor([KINK_ROW]),
                       nf._sample_math(torch.randn(31, 6, generator=g), params, layout, *st)])
        z = nf._full_math(x.double(), [p.double() for p in params], layout, *st,
                          raw=True)[0].float()
    return ift._ift_bwd_math, z, x, params, [i % 3 != 2 for i in range(len(params))], (
        layout, *st)


def _float32_sides(monkeypatch):
    """Every ReLU's side from the float32 march, as the backward took them
    before it marched rows in float64."""
    made = ift._made_sided
    monkeypatch.setattr(ift, "_made_sided", lambda xc, linears, kinks: made(xc, linears, None))


def _ift_loss_grads(bwd, zc, x, params, needs, *statics):
    """Parameter gradients of the reverse-KL-shaped loss ``mean(log q +
    |x|^2)`` at the root ``x`` of the draws ``zc``."""
    n = x.shape[0]
    w = torch.full((n,), 1.0 / n, dtype=x.dtype)
    _, dps = bwd(zc, x, 2 * x * w[:, None], w, params, needs, *statics)
    return dps


def test_bpf_row_at_a_kink_takes_the_float64_side(monkeypatch):
    """The BPF flagship's IFT at 32 roots, one of them at a kink: the float32
    backward within 1e-4 of float64's, where a float32 march's sides put it
    1e-2 off (the row's term from the other branch)."""
    _, z, x, params, needs, (layout, *st) = _bpf_at_a_kink()
    p64 = [p.double() for p in params]
    # the mechanism: the second layer's MADE, at its input as each dtype
    # marches it, puts a hidden unit on opposite sides of 0
    (ps0, _), (ps1, _), _ = nf._split_layers(params, layout)
    (q0, _), (q1, _), _ = nf._split_layers(p64, layout)
    y32 = nf._univ_forward(x[:1], nf._hyper(x[:1], ps0), *st[:5])[0]
    y64 = nf._univ_forward(x[:1].double(), nf._hyper(x[:1].double(), q0), *st[:5])[0]
    pre32 = torch.addmm(ps1[1], y32, (ps1[2] * ps1[0]).T)
    pre64 = torch.addmm(q1[1], y64, (q1[2] * q1[0]).T)
    assert ((pre32 > 0) != (pre64 > 0)).any()
    near = torch.zeros(1, dtype=torch.bool)
    ift._made_near(y32, [(M * W, b) for W, b, M in zip(*[iter(ps1)] * 3)], near)
    assert near.item()
    want = _ift_loss_grads(ift._ift_bwd_math, z.double(), x.double(), p64, needs, layout, *st)
    got = _ift_loss_grads(ift._ift_bwd_math, z, x, params, needs, layout, *st)
    assert _max_relative(got, want) <= TOL
    _float32_sides(monkeypatch)
    got = _ift_loss_grads(ift._ift_bwd_math, z, x, params, needs, layout, *st)
    assert _max_relative(got, want) > 1e-2


def _conditional_nsf():
    torch.manual_seed(0)
    flow = zt.NSF(3, 2, transforms=2, device="cpu")
    params, layout, cfg = nf._flatten_flow(flow)
    st = nf._statics(cfg, 3)
    params = [p.detach() for p in params]
    zc = torch.randn(20, 5)
    with torch.no_grad():
        x = nf._sample_math(zc, params, layout, *st)
    return ift._ift_bwd_math, zc, x, params, [i % 3 != 2 for i in range(len(params))], (
        layout, *st)


def _conditional_naf(**kwargs):
    def make():
        torch.manual_seed(0)
        flow = zt.NAF(3, 2, transforms=2, signal=4, network={"hidden_features": (8, 8)},
                      device="cpu", **kwargs)
        params, layout, F, S = naf_fused._flatten_naf(flow)
        params = [p.detach() for p in params]
        zc = torch.randn(20, 5)
        with torch.no_grad():
            x = naf_fused._naf_sample_math(zc, params, layout, F, S)
        return ift._naf_ift_bwd_math, zc, x, params, [True] * len(params), (layout, F, S)
    return make


@pytest.mark.parametrize("make", [_conditional_nsf, _conditional_naf(),
                                  _conditional_naf(hidden_features=())],
                         ids=["nsf", "naf", "naf_without_hidden_layers"])
def test_float64_sides_change_nothing_away_from_a_kink(make, monkeypatch):
    """The rows near a kink, or every row, marched in float64 for their
    ReLUs' sides (conditional flows: the context too, both tiers) give the
    float32 backward with every side from its own march bit for bit, where
    no row is near a kink; and it stays within 1e-4 of the float64
    backward."""
    bwd, zc, x, params, needs, statics = make()
    lbar = torch.rand(x.shape[0])
    xbar = torch.randn(x.shape)
    want = bwd(zc.double(), x.double(), xbar.double(), lbar.double(),
               [p.double() for p in params], needs, *statics)
    got = [bwd(zc, x, xbar, lbar, params, needs, *statics)]
    monkeypatch.setattr(ift, "_KINK_RTOL", float("inf"))  # every row
    got.append(bwd(zc, x, xbar, lbar, params, needs, *statics))
    _float32_sides(monkeypatch)
    got.append(bwd(zc, x, xbar, lbar, params, needs, *statics))
    assert [a is None for a in got[0][1]] == [b is None for b in want[1]]
    for other in got[1:]:
        assert torch.equal(got[0][0], other[0])
        assert all(torch.equal(a, b) for a, b in zip(got[0][1], other[1]) if a is not None)
    assert _max_relative(got[0][1], want[1]) <= TOL


def _recorded_sides(monkeypatch, bwd, *args):
    """The sides each MADE of the backward ``bwd(*args)`` applied, stage by
    stage: its own ReLUs' (``z > 0``), but at the rows it was handed sides
    for, those."""
    made, seen = ift._made_sided, []

    def recording(xc, linears, kinks):
        sides = ift._made_and_sides(xc.detach(), [(W.detach(), b.detach())
                                                  for W, b in linears])[1]
        if kinks is not None:
            sides = [s.index_put((kinks[0],), k) for s, k in zip(sides, kinks[1])]
        seen.append(sides)
        return made(xc, linears, kinks)

    monkeypatch.setattr(ift, "_made_sided", recording)
    bwd(*args)
    monkeypatch.undo()
    return seen


@pytest.mark.parametrize("make", [_bpf_at_a_kink, _conditional_naf()], ids=["bpf", "naf"])
def test_float32_backward_takes_the_float64_backwards_sides(make, monkeypatch):
    """Both tiers: the float32 backward applies, at every MADE of every
    stage, the ReLU sides that the float64 backward at the same root takes
    from its own march (the BPF's kink row included, where the float32
    march's sides differ: it is near a kink, and every other row's sides
    agree)."""
    bwd, zc, x, params, needs, statics = make()
    xbar, lbar = torch.randn(x.shape), torch.rand(x.shape[0])
    want = _recorded_sides(monkeypatch, bwd, zc.double(), x.double(), xbar.double(),
                           lbar.double(), [p.double() for p in params], needs, *statics)
    got = _recorded_sides(monkeypatch, bwd, zc, x, xbar, lbar, params, needs, *statics)
    assert len(got) == len(want) > 0
    assert all(torch.equal(a, b) for g, w in zip(got, want) for a, b in zip(g, w))


@pytest.mark.parametrize("family", ["bpf", "nsf"])
def test_float32_march_stays_within_the_kink_margin(family):
    """At 2,048 draws of the BPF and NSF flagships, the float32 march from a
    root keeps every hidden pre-activation of every MADE within a quarter
    of ``_KINK_RTOL`` of its scale ``|b| + |M ⊙ W| |a|`` of the float64
    march's: a row the float32 march puts on the other side of a kink is one
    the backward marches in float64."""
    flow = getattr(zt, family.upper())(6, 0, transforms=3, device="cpu")
    zt.load_params(flow, Path(__file__).resolve().parents[1] / "zuko_tpu_torch" / "assets"
                   / f"{family}_flagship.npz")
    params, layout, cfg = nf._flatten_flow(flow)
    params, st = [p.detach() for p in params], nf._statics(cfg, 6)
    p64 = [p.double() for p in params]
    with torch.no_grad():
        x32 = nf._sample_math(torch.randn(2048, 6, generator=torch.Generator().manual_seed(0)),
                              params, layout, *st)
        x64, worst = x32.double(), 0.0
        for (ps, _), (qs, _) in zip(nf._split_layers(params, layout),
                                    nf._split_layers(p64, layout)):
            h32, h64 = x32, x64
            for i in range(len(ps) // 3 - 1):
                W32, W64 = ps[3 * i + 2] * ps[3 * i], qs[3 * i + 2] * qs[3 * i]
                z32 = torch.addmm(ps[3 * i + 1], h32, W32.T)
                z64 = torch.addmm(qs[3 * i + 1], h64, W64.T)
                scale = torch.addmm(qs[3 * i + 1].abs(), h64.abs(), W64.abs().T)
                worst = max(worst, ((z32.double() - z64).abs() / scale).max().item())
                h32, h64 = torch.relu(z32), torch.relu(z64)
            x32 = nf._univ_forward(x32, nf._hyper(x32, ps), *st[:5])[0]
            x64 = nf._univ_forward(x64, nf._hyper(x64, qs), *st[:5])[0]
    assert worst < ift._KINK_RTOL / 4
