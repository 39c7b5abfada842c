#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`src/repro_torch`).

Run from the root of a checkout on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. Device: the card's name and power limit (nvidia-smi), its torch name and
   the device count.
2. Build: both hand-written kernels from the checkout's sources, one library
   after the other; build seconds and the -Xptxas -v reports (registers,
   static shared memory and spill bytes of each kernel).
3. Back-projection kernel vs plain version: the kernel against its plain
   torch version on the same encoded stream, for all five codecs, at the
   full 512^3 width on the first 32 RabbitCT projections and at
   default_geometry(64). Max |kernel - plain| / max |plain| <= 1e-5: both
   read identical wire bytes and scales; only nvcc's FMA contraction
   separates them, and bilinear interpolation is continuous across pixel
   edges, so a flipped floor() costs round-off only.
4. Reconstruction path: ReconstructionPlan(geometry=RabbitCT,
   impl="kernel", precision=...).build()(proj) for fp32 and fp16 on
   projections from the port's forward_project. Per run: seconds, GUPS,
   peak device memory, kernel launches (> 0), interior RMSE vs the phantom
   (< 0.17); and fp16 within Precision("fp16").rmse_tol() of fp32. The
   share of (tile, projection) pairs whose footprint boxes exceeded the
   kernel's staging buffer and were gathered from global memory.
5. Back-projection kernel time at that path's shapes (CUDA events over 10
   launches after a warm-up), beside the bound; the same kernel with a
   staging budget of 0, so that every projection is gathered from global
   memory (the design without staged taps); the plain version's time, and
   the kernel's beside it, on the 32-projection subset.
6. Attention kernel vs plain version at the serving shapes (4 requests x 12
   heads over 2 KV heads, S = 2048, D = 128, inputs from numpy): f32 causal
   and non-causal within rtol = atol = 2e-5 (the reference kernel's test
   bound), bf16 causal within a max abs difference of 0.02 (its bf16
   bound), and a ragged S = 2000 in both dtypes.
7. Serving path: greedy_generate on full-width Qwen2-1.5B (28 layers,
   random weights from a seeded generator) for 4 requests x 2048-token
   prompts and 32 greedy steps, s_max = 2080. Prefill seconds, decode ms per
   step, tokens/s, peak device memory, attention-kernel launches (exactly
   28 per prefill); a traced run for where the time goes. Checks: the
   kernel path against the plain attention step on the card (bf16 and f32
   prefill logits), and decode_step's logits at position 2048 against a
   prefill over the prompt plus that token (see `serving`).
8. Attention kernel time at the serving shape (CUDA events over 20 launches
   after a warm-up) for bf16 and f32, beside the bound, the plain version's
   time and torch's scaled_dot_product_attention on the same tensors (the
   library yardstick; the port never calls it).
9. The `kernels` JSON line (each kernel with the PR of its design), the
   card's name and power limit, and last `{"ok": true, "device": {...}}`.

The RabbitCT geometry is the public back-projection benchmark's size (496
projections of 1248 x 960 pixels into 512^3; Rohkohl et al., Med. Phys.
36(9), 2009) with default_geometry's source and detector distances. It
exits non-zero, printing no result, without a CUDA device or outside a
checkout. It imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

REL_TOL = 1e-5          # kernel vs plain version, relative to max |plain|
RMSE_BOUND = 0.17       # interior RMSE vs the phantom (JAX suite at 24^3)
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_F32_OPS_PER_S = 67e12   # H100 SXM f32, outside the tensor cores
PEAK_BF16_OPS_PER_S = 989e12  # H100 SXM bf16, dense tensor cores
# f32 operations the back-projection needs (a multiply-add counts 2), for
# the operations bound. Per voxel column (i, j) and projection, the
# Theorem 2/3 invariants: x0, y0, z (4 each), 1/z, u = x0/z, w = s/z^2 (2),
# floor(u), its fraction and complement (3), and v(k) = a + b k's a = y0/z
# and b = p6/z (1 each): 21. Per mirrored pair (i, j, k < nz/2) whose
# gathers touch the detector: v(k) (2), the mirror v~ (1), two 4-tap
# gathers at 14 (floor(v), fraction, complement, 4 tap weights, 4 tap
# products, 3 sums) and two weighted accumulates (2 each): 35. The kernel
# itself recomputes the column terms in every thread; that is its cost,
# not the function's.
COLUMN_OPS = 21
PAIR_OPS = 35
# The change that made each kernel's design.
DESIGN = {"bp_dual_kernel<float>": "PR 13", "bp_dual_kernel<__half>": "PR 13",
          "fa_fwd_bf16_kernel": "PR 13", "fa_fwd_f32_kernel": "PR 12"}
TIMED_LAUNCHES = 10
PLAIN_RUNS = 3
CODECS = ("fp32", "bf16", "fp16", "fp8_e4m3", "fp8_e5m2")
MAIN_PATH_CODECS = ("fp32", "fp16")
SUBSET = 32             # RabbitCT projections in the kernel-vs-plain check

# Serving: Qwen2-1.5B at full width, 4 requests x 2048-token prompts.
SEED = 0
BATCH, PROMPT, STEPS, S_MAX = 4, 2048, 32, 2080
RAGGED = 2000           # a prompt length that is not a multiple of a tile
ATTN_F32_TOL = 2e-5     # rtol = atol, the reference kernel's f32 test bound
ATTN_BF16_MAX_ABS = 0.02  # the reference kernel's bf16 test bound
# f32 prefill, kernel path vs plain path: last-position logits' relative
# RMSE. Only the attention sums' order differs (~1e-7 relative per output);
# 28 layers of random weights amplify that, but not by 10^4.
F32_LOGITS_REL = 1e-3
ATTN_RUNS = 20


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip()


def rabbitct_geometry(CBCTGeometry):
    return CBCTGeometry(n_proj=496, n_u=1248, n_v=960,
                        d_u=4.8 / 1248, d_v=4.8 / 1248, d=4.0, dsd=8.0,
                        n_x=512, n_y=512, n_z=512,
                        d_x=2 / 512, d_y=2 / 512, d_z=2 / 512)


def interior_rmse(vol, ph) -> float:
    m = vol.shape[0] // 5
    it = (slice(m, vol.shape[0] - m),) * 3
    return float(((vol[it] - ph[it]) ** 2).mean().sqrt())


def detector_pairs(g, pmats, device) -> int:
    """Mirrored voxel pairs (i, j, k < nz/2) times projections whose
    gathers touch the detector: u in (-1, N_u) and v in (-1, N_v). Front
    and mirror gather touch it together, as v~ = (N_v - 1) - v lies in
    (-1, N_v) exactly when v does. Counted per column from v(k) = a + b k,
    in float64."""
    import torch

    i = torch.arange(g.n_x, dtype=torch.float64, device=device)[:, None]
    j = torch.arange(g.n_y, dtype=torch.float64, device=device)[None, :]
    nzh = g.n_z // 2
    total = torch.zeros((), dtype=torch.float64, device=device)
    for pm in pmats:
        p = pm.reshape(12).astype("float64").tolist()
        z = p[8] * i + p[9] * j + p[11]
        u = (p[0] * i + p[1] * j + p[3]) / z
        a = (p[4] * i + p[5] * j + p[7]) / z
        if p[6] == 0.0:
            n = torch.where((a > -1) & (a < g.n_v), float(nzh), 0.0)
        else:
            t1 = (-1 - a) * z / p[6]   # v(k) crosses -1 and N_v here
            t2 = (g.n_v - a) * z / p[6]
            k_lo = (torch.floor(torch.minimum(t1, t2)) + 1).clamp(min=0)
            k_hi = (torch.ceil(torch.maximum(t1, t2)) - 1).clamp(max=nzh - 1)
            n = (k_hi - k_lo + 1).clamp(min=0)
        total += torch.where((u > -1) & (u < g.n_u), n, 0.0).sum()
    return int(total)


def event_ms(fn, runs: int) -> float:
    """Mean ms of `fn` over `runs` calls after one warm-up, by CUDA events."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / runs


def reconstruction(dev) -> list:
    """Phases 3-5 on the RabbitCT cell; returns the back-projection kernel's
    entries of the `kernels` line."""
    import torch

    from repro_torch.core.filtering import make_filter
    from repro_torch.core.fdk import gups
    from repro_torch.core.geometry import (
        CBCTGeometry, default_geometry, projection_matrices)
    from repro_torch.core.phantom import forward_project, shepp_logan_volume
    from repro_torch.core.plan import ReconstructionPlan
    from repro_torch.core.precision import CODECS as CODEC_TABLE, Precision
    from repro_torch.kernels.attention import kernel as fak
    from repro_torch.kernels.backproject import kernel as bpk
    from repro_torch.kernels.backproject.ops import kernel_operands

    sync = torch.cuda.synchronize
    # Inputs shared by phases 3-5: the RabbitCT projections.
    g = rabbitct_geometry(CBCTGeometry)
    t0 = time.perf_counter()
    proj = forward_project(g, device=dev)
    phantom = shepp_logan_volume(g, device=dev)
    sync()
    print(f"[inputs] RabbitCT {g.proj_shape()} -> {g.volume_shape()}: "
          f"projections + phantom in {time.perf_counter() - t0:.2f} s")
    if not torch.isfinite(proj).all():
        fail("forward_project gave non-finite projections")

    def kernel_inputs(geom, raw, codec):
        """The (params13, Q^T) the reconstruction path hands the kernel."""
        filt = make_filter(geom, "ramlak", out_dtype=torch.float32,
                           device=dev)(raw)
        data, scales = CODEC_TABLE[codec].encode(filt)
        return kernel_operands(projection_matrices(geom)[:raw.shape[0]],
                               data, scales)

    # 3. Back-projection kernel vs plain version ---------------------------
    max_abs = {}
    g64 = default_geometry(64)
    cases = [("RabbitCT[:32]", g, proj[:SUBSET]),
             ("default_geometry(64)", g64, forward_project(g64, device=dev))]
    for label, geom, raw in cases:
        for codec in CODECS:
            params, qt = kernel_inputs(geom, raw, codec)
            shape = (geom.n_x, geom.n_y, geom.n_z)
            got = bpk.backproject_dual(params, qt, *shape)
            want = bpk.backproject_dual_torch(params, qt, *shape)
            sync()
            err = float((got - want).abs().max())
            rel = err / float(want.abs().max())
            print(f"[bp-check] {label} {codec}: max|kernel-plain| {err:.3e}, "
                  f"relative {rel:.3e} (bound {REL_TOL:.0e})")
            if not (rel <= REL_TOL):
                fail(f"kernel disagrees with its plain version: {label} "
                     f"{codec} relative {rel:.3e} > {REL_TOL:.0e}")
            max_abs[codec] = max(max_abs.get(codec, 0.0), err)
            del got, want, params, qt

    # 4. Reconstruction path ----------------------------------------------
    volumes, launches = {}, {}
    for codec in MAIN_PATH_CODECS:
        fn = ReconstructionPlan(geometry=g, impl="kernel",
                                precision=codec).build()
        fn(proj)  # warm-up
        sync()
        torch.cuda.reset_peak_memory_stats()
        bpk.launches = fak.launches = 0
        t0 = time.perf_counter()
        vol = fn(proj)
        sync()
        dt = time.perf_counter() - t0
        launches[codec] = bpk.launches
        direct = int(bpk.direct_pairs)
        peak = torch.cuda.max_memory_allocated()
        if tuple(vol.shape) != g.volume_shape() or not torch.isfinite(vol).all():
            fail(f"reconstruction {codec}: bad volume {tuple(vol.shape)}")
        rmse = interior_rmse(vol, phantom)
        print(f"[recon] {codec}: {dt:.4f} s, {gups(g, dt):.2f} GUPS, peak "
              f"{peak / 2**30:.2f} GiB, kernel launches {launches[codec]}, "
              f"interior RMSE vs phantom {rmse:.4f} (bound {RMSE_BOUND}); "
              f"direct-gather (tile, projection) pairs {direct} of "
              f"{bpk.tile_pairs} ({direct / bpk.tile_pairs:.4%})")
        if launches[codec] < 1:
            fail(f"reconstruction {codec} did not launch the kernel")
        if not rmse < RMSE_BOUND:
            fail(f"reconstruction {codec}: RMSE {rmse:.4f} >= {RMSE_BOUND}")
        volumes[codec] = vol
    ref = volumes["fp32"]
    fp16_rel = float(((volumes["fp16"] - ref) ** 2).mean().sqrt()
                     / ref.abs().max())
    tol = Precision("fp16").rmse_tol()
    print(f"[recon] fp16 vs fp32 relative RMSE {fp16_rel:.3e} "
          f"(bound {tol:.3e})")
    if not fp16_rel < tol:
        fail(f"fp16 reconstruction off fp32 by {fp16_rel:.3e} > {tol:.3e}")
    del volumes, ref

    # Where the path's time goes: one traced fp32 run.
    fn = ReconstructionPlan(geometry=g, impl="kernel",
                            precision="fp32").build()
    profile(lambda: fn(proj), "fp32 reconstruction", top=8)

    # 5. Back-projection kernel time at the path's shapes ------------------
    entries = []
    shape = (g.n_x, g.n_y, g.n_z)
    pairs = detector_pairs(g, projection_matrices(g), dev)
    all_pairs = g.n_x * g.n_y * (g.n_z // 2) * g.n_proj
    n_ops = PAIR_OPS * pairs + COLUMN_OPS * g.n_x * g.n_y * g.n_proj
    ops_ms = n_ops / PEAK_F32_OPS_PER_S * 1e3
    print(f"[bp-time] operations the back-projection needs: {pairs} of "
          f"{all_pairs} pair-projections touch the detector "
          f"({pairs / all_pairs:.2%}); {n_ops:.4e} operations, "
          f"{n_ops / (2 * all_pairs):.3f} per voxel update")
    for codec in MAIN_PATH_CODECS:
        name = "bp_dual_kernel<%s>" % {"fp32": "float", "fp16": "__half"}[codec]
        params, qt = kernel_inputs(g, proj, codec)
        ms = event_ms(lambda: bpk.backproject_dual(params, qt, *shape),
                      TIMED_LAUNCHES)
        sync()
        direct_share = int(bpk.direct_pairs) / bpk.tile_pairs
        unstaged_ms = event_ms(
            lambda: bpk.backproject_dual(params, qt, *shape, stage_bytes=0),
            TIMED_LAUNCHES)
        n_bytes = (params.numel() * 4 + qt.numel() * qt.element_size()
                   + g.n_x * g.n_y * g.n_z * 4)
        bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        del params, qt
        # The plain version runs only on the subset (one launch per
        # projection and ~40 elementwise passes each).
        params, qt = kernel_inputs(g, proj[:SUBSET], codec)
        sub_ms = event_ms(lambda: bpk.backproject_dual(params, qt, *shape),
                          TIMED_LAUNCHES)
        plain_ms = event_ms(
            lambda: bpk.backproject_dual_torch(params, qt, *shape),
            PLAIN_RUNS)
        del params, qt
        print(f"[bp-time] {codec}: kernel {ms:.3f} ms ({gups(g, ms / 1e3):.1f} "
              f"GUPS), bound {bound_ms:.3f} ms (bytes {bytes_ms:.3f} ms, "
              f"operations {ops_ms:.3f} ms), {bound_ms / ms:.1%} of bound, "
              f"{direct_share:.4%} of (tile, projection) pairs "
              f"gathered directly; staging budget 0 (every pair gathered "
              f"directly) {unstaged_ms:.3f} ms; on {SUBSET} projections: "
              f"kernel {sub_ms:.3f} ms, plain {plain_ms:.1f} ms; "
              "library_ms null: no single PyTorch call computes a weighted "
              "back-projection")
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/backproject/csrc/backproject.cu",
            "replaces": "src/repro/kernels/backproject/kernel.py:72",
            "launches": launches[codec],
            "max_abs_err": max_abs[codec],
            "ms": ms,
            "plain_ms": plain_ms,
            "plain_n_proj": SUBSET,    # plain_ms is on the subset ...
            "ms_at_plain_n_proj": sub_ms,  # ... as is this kernel time
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
            "design": DESIGN[name],
        })

    return entries


def rel_rmse(got, want) -> float:
    """RMS(got - want) / RMS(want), in f32."""
    got, want = got.float(), want.float()
    return float(((got - want) ** 2).mean().sqrt() / (want ** 2).mean().sqrt())


def profile(fn, label: str, top: int) -> None:
    """One traced run of `fn`: wall time, the device's busy share and the
    device time of the `top` largest kernels by name."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in rows)
    print(f"[profile] {label}: wall {wall_us / 1e3:.1f} ms, device busy "
          f"{busy_us / 1e3:.1f} ms ({busy_us / wall_us:.1%}), by kernel:")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"[profile]   {e.self_device_time_total / 1e3:9.2f} ms "
              f"x{e.count:<5d} {e.key[:110]}")
    host = [e for e in prof.key_averages() if e.key.startswith("aten::")]
    print(f"[profile] {label}: host time by operator (self):")
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:5]:
        print(f"[profile]   {e.self_cpu_time_total / 1e3:9.2f} ms "
              f"x{e.count:<5d} {e.key}")


def attention_operands(cfg, s: int, dtype, dev, seed: int):
    """Folded (B*H, S, D) q and (B*K, S, D) k, v at the serving widths, from
    numpy's standard normal."""
    import torch

    rng = np.random.default_rng(seed)
    d = cfg.resolved_head_dim
    return tuple(
        torch.from_numpy(rng.standard_normal((BATCH * n, s, d),
                                             dtype=np.float32))
        .to(device=dev, dtype=dtype)
        for n in (cfg.num_heads, cfg.num_kv_heads, cfg.num_kv_heads))


def attention_checks(cfg, dev) -> dict:
    """Phase 6; returns the max |kernel - plain| per dtype."""
    import torch

    from repro_torch.kernels.attention import kernel as fak

    max_abs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    cases = [(torch.float32, True, PROMPT), (torch.float32, False, PROMPT),
             (torch.bfloat16, True, PROMPT), (torch.float32, True, RAGGED),
             (torch.bfloat16, True, RAGGED)]
    for i, (dtype, causal, s) in enumerate(cases):
        q, k, v = attention_operands(cfg, s, dtype, dev, seed=SEED + i)
        got = fak.flash_attention_bhsd(q, k, v, causal=causal)
        want = fak.flash_attention_bhsd_torch(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        worst = float(err.max())
        max_abs[dtype] = max(max_abs[dtype], worst)
        if dtype == torch.float32:
            # assert_close's rule: |got - want| <= atol + rtol |want|
            excess = float((err - ATTN_F32_TOL * want.abs()).max())
            ok = excess <= ATTN_F32_TOL
            bound = f"rtol = atol = {ATTN_F32_TOL:.0e}"
        else:
            ok = worst < ATTN_BF16_MAX_ABS
            bound = f"max abs < {ATTN_BF16_MAX_ABS}"
        label = (f"{tuple(q.shape)} q, {tuple(k.shape)} k/v, {dtype}, "
                 f"{'causal' if causal else 'non-causal'}")
        print(f"[attn-check] {label}: max|kernel-plain| {worst:.3e} "
              f"({bound})")
        if not ok:
            fail(f"attention kernel disagrees with its plain version: "
                 f"{label}: max abs {worst:.3e}")
    return max_abs


@contextlib.contextmanager
def plain_attention_step(layers):
    """The plain (reference) attention step in prefill on the card, for a
    comparison; the port's own path always takes the kernel there."""
    kernel_step = layers.prefill_attention
    layers.prefill_attention = layers.prefill_attention_plain
    try:
        yield
    finally:
        layers.prefill_attention = kernel_step


def serving(cfg, dev) -> dict:
    """Phase 7; returns the attention kernel's launches per dtype on the
    serving path (bf16: greedy_generate; f32: the f32 prefill)."""
    import torch

    from repro_torch.kernels.attention import kernel as fak
    from repro_torch.kernels.backproject import kernel as bpk
    from repro_torch.models import transformer as T
    from repro_torch.serving import greedy_generate, make_prefill

    sync = torch.cuda.synchronize
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=SEED)
    sync()
    n_params = T.param_count(params)
    print(f"[serve] {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
          f"{cfg.resolved_head_dim}, {n_params} parameters ({cfg.param_dtype}"
          f", {n_params * 4 / 1e9:.2f} GB) drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (BATCH, PROMPT))).to(dev)
    prompt = {"tokens": tokens}
    prefill = make_prefill(cfg)
    prefill(params, prompt)   # warm-up: cuBLAS handles, the allocator
    sync()

    # The serving path, with the counts at 0 just before it.
    torch.cuda.reset_peak_memory_stats()
    bpk.launches = fak.launches = 0
    t0 = time.perf_counter()
    ids = greedy_generate(cfg, params, prompt, steps=STEPS, s_max=S_MAX)
    sync()
    total_s = time.perf_counter() - t0
    launches = {torch.bfloat16: fak.launches}
    peak = torch.cuda.max_memory_allocated()
    if tuple(ids.shape) != (BATCH, STEPS + 1) or not (
            0 <= int(ids.min()) and int(ids.max()) < cfg.vocab_size):
        fail(f"greedy_generate gave ids of shape {tuple(ids.shape)} outside "
             f"[0, {cfg.vocab_size})")
    if launches[torch.bfloat16] != cfg.num_layers:
        fail(f"one prefill launched the attention kernel "
             f"{launches[torch.bfloat16]} times, not {cfg.num_layers}")
    t0 = time.perf_counter()
    logits_k, cache = prefill(params, prompt)
    sync()
    prefill_s = time.perf_counter() - t0
    decode_ms = (total_s - prefill_s) / STEPS * 1e3
    print(f"[serve] greedy_generate {BATCH} x {PROMPT}-token prompts, "
          f"{STEPS} steps, s_max {S_MAX}: {total_s:.4f} s, "
          f"{BATCH * (STEPS + 1) / total_s:.1f} generated tokens/s; prefill "
          f"{prefill_s:.4f} s ({BATCH * PROMPT / prefill_s:.0f} prompt "
          f"tokens/s); decode {decode_ms:.3f} ms/step "
          f"({BATCH * 1e3 / decode_ms:.1f} tokens/s); peak "
          f"{peak / 2**30:.2f} GiB; attention-kernel launches "
          f"{launches[torch.bfloat16]} (one prefill of {cfg.num_layers} "
          f"layers)")
    print(f"[serve] first request's ids: {ids[0, :12].tolist()} ...")
    if not torch.isfinite(logits_k.float()).all():
        fail("prefill gave non-finite logits")

    # Where the time goes: the prefill alone, then the whole path.
    profile(lambda: prefill(params, prompt), "bf16 prefill", top=10)
    profile(lambda: greedy_generate(cfg, params, prompt, steps=STEPS,
                                    s_max=S_MAX),
            f"bf16 greedy_generate ({STEPS} steps)", top=10)
    launches[torch.float32] = logit_checks(cfg, params, tokens, logits_k,
                                           cache)
    return launches


def logit_checks(cfg, params, tokens, logits_k, cache) -> int:
    """The serving checks on the card, from the bf16 prefill's last-position
    logits and cache; returns the f32 prefill's kernel launches."""
    import torch

    from repro_torch.kernels.attention import kernel as fak
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    sync = torch.cuda.synchronize
    prompt = {"tokens": tokens}

    # The kernel path against the plain attention step, on the card. In
    # bf16 the plain step rounds the scores to bf16 and the kernel keeps
    # them in f32, so they differ by bf16 rounding: the bound is twice the
    # plain path's own distance from the f32 model (the triangle
    # inequality, if the kernel path is no further from f32 than the plain
    # one). In f32 only the summation order differs.
    cfg32 = cfg.scaled(dtype="float32")
    before = fak.launches
    with plain_attention_step(L):
        logits_p, _ = T.prefill(params, cfg, prompt)
        logits_32p, _ = T.prefill(params, cfg32, prompt)
    sync()
    if fak.launches != before:
        fail("the plain attention step launched the kernel")
    fak.launches = 0
    logits_32k, _ = T.prefill(params, cfg32, prompt)
    sync()
    f32_launches = fak.launches
    if f32_launches != cfg.num_layers:
        fail(f"the f32 prefill launched the kernel {f32_launches} times")
    e_plain = rel_rmse(logits_p, logits_32p)
    bf16_bound = 2 * e_plain
    d_bf16 = rel_rmse(logits_k, logits_p)
    d_f32 = rel_rmse(logits_32k, logits_32p)
    print(f"[serve-check] last-position logits, relative RMSE: bf16 kernel "
          f"path vs bf16 plain path {d_bf16:.3e} (bound {bf16_bound:.3e} = "
          f"2 x bf16 plain vs f32 plain {e_plain:.3e}); bf16 kernel path vs "
          f"f32 plain {rel_rmse(logits_k, logits_32p):.3e}; f32 kernel path "
          f"vs f32 plain path {d_f32:.3e} (bound {F32_LOGITS_REL:.0e})")
    if not d_bf16 <= bf16_bound:
        fail(f"bf16 kernel path off the plain path by {d_bf16:.3e}")
    if not d_f32 <= F32_LOGITS_REL:
        fail(f"f32 kernel path off the plain path by {d_f32:.3e}")
    del logits_p, logits_32p, logits_32k

    # Decode self-consistency: decode_step at position PROMPT against a
    # prefill over the prompt plus that token (S = PROMPT + 1, a ragged
    # tail for the kernel). Decode runs the plain step on a bf16 cache,
    # the prefill the kernel: the same bf16 bound.
    nxt = logits_k.argmax(-1)[:, None]
    full = T.init_cache(cfg, BATCH, PROMPT + 1)
    for big, small in ((full.attn_k, cache.attn_k),
                       (full.attn_v, cache.attn_v)):
        for key in small:
            big[key][:, :, :PROMPT] = small[key]
    dec, _ = T.decode_step(params, cfg, full, nxt, PROMPT)
    ref, _ = T.prefill(params, cfg,
                       {"tokens": torch.cat([tokens, nxt], dim=1)})
    d_dec = rel_rmse(dec, ref)
    print(f"[serve-check] decode_step at {PROMPT} vs prefill over "
          f"{PROMPT + 1} tokens: relative RMSE {d_dec:.3e} (bound "
          f"{bf16_bound:.3e}); argmax agrees for "
          f"{int((dec.argmax(-1) == ref.argmax(-1)).sum())}/{BATCH}")
    if not d_dec <= bf16_bound:
        fail(f"decode_step off prefill by {d_dec:.3e}")
    return f32_launches


def attention_timing(cfg, dev, launches: dict, max_abs: dict) -> list:
    """Phase 8; returns the attention kernel's entries of the `kernels`
    line."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.attention import kernel as fak

    h, kh, d, s = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, PROMPT
    # causal: query i meets keys 0..i, 2 D operations each for q.k and p.v
    flops = 4 * d * s * (s + 1) / 2 * BATCH * h
    entries = []
    for dtype, name, peak in ((torch.bfloat16, "fa_fwd_bf16_kernel",
                               PEAK_BF16_OPS_PER_S),
                              (torch.float32, "fa_fwd_f32_kernel",
                               PEAK_F32_OPS_PER_S)):
        q, k, v = attention_operands(cfg, s, dtype, dev, seed=SEED)
        ms = event_ms(lambda: fak.flash_attention_bhsd(q, k, v), ATTN_RUNS)
        plain_ms = event_ms(lambda: fak.flash_attention_bhsd_torch(q, k, v),
                            PLAIN_RUNS)
        # The library yardstick on the same tensors, KV heads repeated to
        # the query heads outside the timed calls.
        q4 = q.view(BATCH, h, s, d)
        k4 = k.view(BATCH, kh, s, d).repeat_interleave(h // kh, dim=1)
        v4 = v.view(BATCH, kh, s, d).repeat_interleave(h // kh, dim=1)
        lib_ms = event_ms(
            lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                   is_causal=True),
            ATTN_RUNS)
        n_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
        ops_ms = flops / peak * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        print(f"[attn-time] {dtype} {name}: kernel {ms:.3f} ms "
              f"({flops / ms / 1e9:.2f} TFLOP/s), bound {bound_ms:.4f} ms "
              f"(operations {ops_ms:.4f} ms, bytes {bytes_ms:.4f} ms), "
              f"{bound_ms / ms:.2%} of bound; plain {plain_ms:.3f} ms; "
              f"scaled_dot_product_attention {lib_ms:.3f} ms")
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/attention/csrc/attention.cu",
            "replaces": "src/repro/kernels/attention/kernel.py:33",
            "launches": launches[dtype],
            "max_abs_err": max_abs[dtype],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": lib_ms,
            "design": DESIGN[name],
        })
        del q, k, v, q4, k4, v4
    return entries


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from the root "
              "of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.configs import get_config
    from repro_torch.kernels.attention import kernel as fak
    from repro_torch.kernels.backproject import kernel as bpk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. Device ------------------------------------------------------------
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"[device] nvidia-smi: {smi}")
    print(f"[device] torch: {kind}, count {count}, torch {torch.__version__},"
          f" CUDA {torch.version.cuda}")

    # 2. Build, one library after the other ---------------------------------
    for lib in (bpk.LIBRARY, fak.LIBRARY):
        t0 = time.perf_counter()
        lib.build()
        print(f"[build] {lib.path.name}: nvcc {lib.build_seconds} s (None = "
              f"already built); {time.perf_counter() - t0:.2f} s wall")
        print("[build] " + lib.ptxas_report().replace("\n", "\n[build] "))

    # 3-5. Reconstruction ----------------------------------------------------
    entries = reconstruction(dev)
    torch.cuda.empty_cache()

    # 6-8. Serving -----------------------------------------------------------
    cfg = get_config("qwen2_1_5b")
    max_abs = attention_checks(cfg, dev)
    launches = serving(cfg, dev)
    torch.cuda.empty_cache()
    entries += attention_timing(cfg, dev, launches, max_abs)

    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith(("jax.", "repro."))
                    or m == "repro")
    if leaked:
        fail(f"the port imported {leaked}")

    # 9. Result ------------------------------------------------------------
    print(json.dumps({"kernels": entries}))
    print(f"[device] {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
