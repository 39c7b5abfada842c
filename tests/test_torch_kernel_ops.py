"""The kernels' launch operators on fake tensors (no card needed).

`kernels/attention/kernel.py::flash_attention_fwd` and
`kernels/backproject/kernel.py::backproject_dual_launch` are PyTorch
operators whose fake implementations give the output's shape and dtype,
and whose FLOPs `torch.utils.flop_counter` counts by the kernels' own
formulas. The wrappers take them for fake CUDA tensors, and for fake CPU
tensors inside `device.fake_card()` (the dry run's); neither touches the
library, and the registry's launch counters count real launches only. Real
CPU tensors still run the plain versions.
"""
import math

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.device import fake_card, on_card
from repro_torch.kernels.attention import kernel as fak
from repro_torch.kernels.backproject import kernel as bpk
from repro_torch.obs import trace
from repro_torch.obs.metrics import default_registry

BH, GROUP, S, D = 8, 4, 96, 32


def attention_flops_by_pairs(bh, sq, sk, d, causal, window):
    """4 D operations per (query, visible key) pair, counted pair by
    pair: the formula's definition, independent of its closed form."""
    pairs = 0
    for i in range(sq):
        if not causal:
            pairs += sk
        else:
            lo = 0 if window is None else max(0, i - window + 1)
            pairs += i + 1 - lo
    return 4 * d * pairs * bh


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("window", [None, 40])
def test_attention_operator_on_fake_tensors(device, dtype, window):
    """Shape, dtype and device of the output; the registered count, in
    FlopCounterMode's total, equal to the pair-by-pair count; no launch
    counted; the library never loaded."""
    reg = default_registry()
    counts = lambda: (reg.value(fak.LAUNCHES), reg.value(fak.WINDOW_LAUNCHES))
    before = (counts(), fak.LIBRARY._lib)
    with FakeTensorMode(), fake_card():
        q = torch.empty(BH, S, D, dtype=dtype, device=device)
        kv = torch.empty(BH // GROUP, S, D, dtype=dtype, device=device)
        with FlopCounterMode(display=False) as fc:
            out = fak.flash_attention_bhsd(q, kv, kv, window=window)
    assert out.shape == q.shape and out.dtype == dtype
    assert out.device.type == device
    want = attention_flops_by_pairs(BH, S, S, D, True, window)
    assert fc.get_total_flops() == want
    assert fak.attention_flops(BH, S, S, D, True, window) == want
    assert (counts(), fak.LIBRARY._lib) == before


def test_attention_formula_matches_the_smoke_script():
    """The causal count is the smoke script's causal_attention_flops
    (4 D S (S + 1) / 2 per row), the windowed one its windowed_flops
    (4 D (W (W + 1) / 2 + (S - W) W)), and the unmasked 4 D Sq Sk."""
    b, h, s, d, w = 2, 3, 70, 16, 9
    assert fak.attention_flops(b * h, s, s, d) == 4 * d * s * (s + 1) / 2 \
        * b * h
    assert fak.attention_flops(b * h, s, s, d, window=w) == \
        4 * d * (w * (w + 1) // 2 + (s - w) * w) * b * h
    assert fak.attention_flops(b * h, s, 50, d, causal=False) == \
        attention_flops_by_pairs(b * h, s, 50, d, False, None)


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.float8_e4m3fn])
def test_backprojection_operator_on_fake_tensors(device, dtype):
    """The dual-slab volume's shape in f32; the registered count (every
    mirrored pair counted as touching the detector); under a traced
    fence, `tile_pairs` counted and no direct pair (a fake launch has no
    count to read); `launches` and the library untouched."""
    n_p, nu, nv, nx, ny, nz = 6, 40, 24, 16, 12, 20
    reg = default_registry()
    names = (bpk.LAUNCHES, bpk.TILE_PAIRS, bpk.DIRECT_PAIRS, bpk.RING_WAITS)
    before = [reg.value(n) for n in names]
    bound = bpk._BOUND
    tracer = trace.Tracer(enabled=True)
    prev = trace.set_tracer(tracer)
    try:
        with tracer.span("dry") as sp, FakeTensorMode(), fake_card():
            params = torch.empty(n_p, 13, device=device)
            qt = torch.empty(n_p, nu, nv, dtype=dtype, device=device)
            with FlopCounterMode(display=False) as fc:
                vol = bpk.backproject_dual(params, qt, nx, ny, nz,
                                           tile=(16, 8, 64))
            sp.fence(None)
    finally:
        trace.set_tracer(prev)
    assert vol.shape == (nx, ny, 2, nz // 2) and vol.dtype == torch.float32
    assert vol.device.type == device
    want = n_p * nx * ny * (21 + 35 * (nz // 2))
    assert bpk.backproject_ops(n_p, nx, ny, nz) == want
    assert fc.get_total_flops() == want
    pairs = n_p * math.ceil(nx / 16) * math.ceil(ny / 8) \
        * math.ceil(nz // 2 / 64)
    assert [reg.value(n) - b for n, b in zip(names, before)] == \
        [0, pairs, 0, 0]
    assert bpk._BOUND is bound
    assert sp.args["tile_pairs"] == pairs and "direct_pairs" not in sp.args
    assert "ring_waits" not in sp.args


@pytest.mark.parametrize("traced", [True, False])
def test_backprojection_counts_reach_the_fence(monkeypatch, traced):
    """The launch's 2-element count (directly gathered pairs, ring waits),
    here made up for a launch that never runs: under a traced fence it
    becomes the span's `direct_pairs` and `ring_waits` args beside
    `tile_pairs`, and advances the registry's counters by the same; with
    the tracer off nothing is read or counted."""
    n_p, nu, nv, nx, ny, nz = 5, 40, 24, 16, 12, 20
    counts = torch.tensor([3, 41], dtype=torch.int64)

    def launch(params, qt, nx_, ny_, nz_, tile_index, stage_bytes):
        assert (tile_index, stage_bytes) == (0, -1)
        return torch.zeros((nx_, ny_, 2, nz_ // 2)), counts

    monkeypatch.setattr(bpk, "on_card", lambda x: True)
    monkeypatch.setattr(bpk, "backproject_dual_launch", launch)
    reg = default_registry()
    names = (bpk.TILE_PAIRS, bpk.DIRECT_PAIRS, bpk.RING_WAITS)
    before = [reg.value(n) for n in names]
    tracer = trace.Tracer(enabled=traced)
    prev = trace.set_tracer(tracer)
    try:
        with tracer.span("launch") as sp:
            vol = bpk.backproject_dual(torch.zeros(n_p, 13),
                                       torch.zeros(n_p, nu, nv), nx, ny, nz)
            sp.fence(vol)
    finally:
        trace.set_tracer(prev)
    pairs = n_p * math.prod(-(-n // d) for n, d in
                            zip((nx, ny, nz // 2), bpk.DEFAULT_TILE))
    moved = [reg.value(n) - b for n, b in zip(names, before)]
    if traced:
        assert (sp.args["tile_pairs"], sp.args["direct_pairs"],
                sp.args["ring_waits"]) == (pairs, 3, 41)
        assert moved == [pairs, 3, 41]
    else:
        assert moved == [0, 0, 0]


def test_real_cpu_tensors_run_the_plain_versions():
    """Outside a dry run, and for real tensors inside one, the wrappers
    run the plain versions; the operators have no CPU kernel."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(4, 10, 8, generator=g)
    kv = torch.randn(2, 10, 8, generator=g)
    with fake_card():
        assert not on_card(q)
        got = fak.flash_attention_bhsd(q, kv, kv)
    torch.testing.assert_close(
        got, fak.flash_attention_bhsd_torch(q, kv, kv), rtol=0, atol=0)
    with pytest.raises(NotImplementedError):
        fak.flash_attention_fwd(q, kv, kv, True, 0)
    with FakeTensorMode():
        fake = torch.empty(3)
    assert not on_card(fake)
    with fake_card():
        assert on_card(fake)
    assert not on_card(fake)


def test_raise_under_autograd_stays():
    """On the card's branch the raw wrapper still refuses operands that
    require grad (its output is written outside autograd)."""
    with FakeTensorMode(), fake_card():
        q = torch.empty(4, 8, 16, requires_grad=True)
        kv = torch.empty(2, 8, 16)
        with pytest.raises(RuntimeError, match="flash_attention_trainable"):
            fak.flash_attention_bhsd(q, kv, kv)
