#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`src/repro_torch`).

Run from the root of a checkout on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. Device: the card's name and power limit (nvidia-smi), its torch name and
   the device count.
2. Build: the hand-written kernel from the checkout's sources; build
   seconds and the -Xptxas -v report.
3. Kernel vs plain version: the back-projection kernel against its plain
   torch version on the same encoded stream, for all five codecs, at the
   full 512^3 width on the first 32 RabbitCT projections and at
   default_geometry(64). Max |kernel - plain| / max |plain| <= 1e-5: both
   read identical wire bytes and scales; only nvcc's FMA contraction
   separates them, and bilinear interpolation is continuous across pixel
   edges, so a flipped floor() costs round-off only.
4. Main path: ReconstructionPlan(geometry=RabbitCT, impl="kernel",
   precision=...).build()(proj) for fp32 and fp16 on projections from the
   port's forward_project. Per run: seconds, GUPS, peak device memory,
   kernel launches (> 0), interior RMSE vs the phantom (< 0.17); and fp16
   within Precision("fp16").rmse_tol() of fp32.
5. Kernel time at the main path's shapes (CUDA events over 10 launches
   after a warm-up), beside the bound; the plain version's time, and the
   kernel's beside it, on the 32-projection subset.
6. The `kernels` JSON line, the card's name and power limit, and last
   `{"ok": true, "device": {...}}`.

The RabbitCT geometry is the public back-projection benchmark's size (496
projections of 1248 x 960 pixels into 512^3; Rohkohl et al., Med. Phys.
36(9), 2009) with default_geometry's source and detector distances. It
exits non-zero, printing no result, without a CUDA device or outside a
checkout. It imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

REL_TOL = 1e-5          # kernel vs plain version, relative to max |plain|
RMSE_BOUND = 0.17       # interior RMSE vs the phantom (JAX suite at 24^3)
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_F32_OPS_PER_S = 67e12   # H100 SXM f32, outside the tensor cores
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
TIMED_LAUNCHES = 10
PLAIN_RUNS = 3
CODECS = ("fp32", "bf16", "fp16", "fp8_e4m3", "fp8_e5m2")
MAIN_PATH_CODECS = ("fp32", "fp16")
SUBSET = 32             # RabbitCT projections in the kernel-vs-plain check


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
    from repro_torch.core.filtering import make_filter
    from repro_torch.core.fdk import gups
    from repro_torch.core.geometry import (
        CBCTGeometry, default_geometry, projection_matrices)
    from repro_torch.core.phantom import forward_project, shepp_logan_volume
    from repro_torch.core.plan import ReconstructionPlan
    from repro_torch.core.precision import CODECS as CODEC_TABLE, Precision
    from repro_torch.kernels.backproject import kernel as bpk
    from repro_torch.kernels.backproject.ops import kernel_operands

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    sync = torch.cuda.synchronize

    # 1. Device ------------------------------------------------------------
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"[device] nvidia-smi: {smi}")
    print(f"[device] torch: {kind}, count {count}, torch {torch.__version__},"
          f" CUDA {torch.version.cuda}")

    # 2. Build -------------------------------------------------------------
    t0 = time.perf_counter()
    bpk.LIBRARY.build()
    print(f"[build] {bpk.LIBRARY.path.name}: nvcc "
          f"{bpk.LIBRARY.build_seconds} s (None = already built); "
          f"{time.perf_counter() - t0:.2f} s wall")
    print("[build] " + bpk.LIBRARY.ptxas_report().replace("\n", "\n[build] "))

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
        """The (params13, Q^T) the main path hands the kernel for `raw`."""
        filt = make_filter(geom, "ramlak", out_dtype=torch.float32,
                           device=dev)(raw)
        data, scales = CODEC_TABLE[codec].encode(filt)
        return kernel_operands(projection_matrices(geom)[:raw.shape[0]],
                               data, scales)

    # 3. Kernel vs plain version -------------------------------------------
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
            print(f"[check] {label} {codec}: max|kernel-plain| {err:.3e}, "
                  f"relative {rel:.3e} (bound {REL_TOL:.0e})")
            if not (rel <= REL_TOL):
                fail(f"kernel disagrees with its plain version: {label} "
                     f"{codec} relative {rel:.3e} > {REL_TOL:.0e}")
            max_abs[codec] = max(max_abs.get(codec, 0.0), err)
            del got, want, params, qt

    # 4. Main path ---------------------------------------------------------
    volumes, launches = {}, {}
    for codec in MAIN_PATH_CODECS:
        fn = ReconstructionPlan(geometry=g, impl="kernel",
                                precision=codec).build()
        fn(proj)  # warm-up
        sync()
        torch.cuda.reset_peak_memory_stats()
        bpk.launches = 0
        t0 = time.perf_counter()
        vol = fn(proj)
        sync()
        dt = time.perf_counter() - t0
        launches[codec] = bpk.launches
        peak = torch.cuda.max_memory_allocated()
        if tuple(vol.shape) != g.volume_shape() or not torch.isfinite(vol).all():
            fail(f"main path {codec}: bad volume {tuple(vol.shape)}")
        rmse = interior_rmse(vol, phantom)
        print(f"[main] {codec}: {dt:.4f} s, {gups(g, dt):.2f} GUPS, peak "
              f"{peak / 2**30:.2f} GiB, kernel launches {launches[codec]}, "
              f"interior RMSE vs phantom {rmse:.4f} (bound {RMSE_BOUND})")
        if launches[codec] < 1:
            fail(f"main path {codec} did not launch the kernel")
        if not rmse < RMSE_BOUND:
            fail(f"main path {codec}: RMSE {rmse:.4f} >= {RMSE_BOUND}")
        volumes[codec] = vol
    ref = volumes["fp32"]
    rel_rmse = float(((volumes["fp16"] - ref) ** 2).mean().sqrt()
                     / ref.abs().max())
    tol = Precision("fp16").rmse_tol()
    print(f"[main] fp16 vs fp32 relative RMSE {rel_rmse:.3e} "
          f"(bound {tol:.3e})")
    if not rel_rmse < tol:
        fail(f"fp16 main path off fp32 by {rel_rmse:.3e} > {tol:.3e}")
    del volumes, ref

    # Where the main path's time goes: one traced fp32 run, device time by
    # kernel name, and the share of the run the device was busy.
    fn = ReconstructionPlan(geometry=g, impl="kernel",
                            precision="fp32").build()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn(proj)
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in rows)
    print(f"[profile] fp32 main path: wall {wall_us / 1e3:.1f} ms, device "
          f"busy {busy_us / 1e3:.1f} ms ({busy_us / wall_us:.1%}), "
          "by kernel:")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[profile]   {e.self_device_time_total / 1e3:9.2f} ms "
              f"x{e.count:<4d} {e.key[:90]}")

    # 5. Kernel time at the main path's shapes -----------------------------
    entries = []
    shape = (g.n_x, g.n_y, g.n_z)
    pairs = detector_pairs(g, projection_matrices(g), dev)
    all_pairs = g.n_x * g.n_y * (g.n_z // 2) * g.n_proj
    n_ops = PAIR_OPS * pairs + COLUMN_OPS * g.n_x * g.n_y * g.n_proj
    ops_ms = n_ops / PEAK_F32_OPS_PER_S * 1e3
    print(f"[time] operations the back-projection needs: {pairs} of "
          f"{all_pairs} pair-projections touch the detector "
          f"({pairs / all_pairs:.2%}); {n_ops:.4e} operations, "
          f"{n_ops / (2 * all_pairs):.3f} per voxel update")
    for codec in MAIN_PATH_CODECS:
        params, qt = kernel_inputs(g, proj, codec)
        ms = event_ms(lambda: bpk.backproject_dual(params, qt, *shape),
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
        print(f"[time] {codec}: kernel {ms:.3f} ms ({gups(g, ms / 1e3):.1f} "
              f"GUPS), bound {bound_ms:.3f} ms (bytes {bytes_ms:.3f} ms, "
              f"operations {ops_ms:.3f} ms), {bound_ms / ms:.1%} of bound; "
              f"on {SUBSET} projections: kernel {sub_ms:.3f} ms, plain "
              f"{plain_ms:.1f} ms; library_ms null: no single PyTorch call "
              "computes a weighted back-projection")
        dtype_name = {"fp32": "float", "fp16": "__half"}[codec]
        entries.append({
            "name": f"bp_dual_kernel<{dtype_name}>",
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
        })

    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith(("jax.", "repro."))
                    or m == "repro")
    if leaked:
        fail(f"the port imported {leaked}")

    # 6. Result ------------------------------------------------------------
    print(json.dumps({"kernels": entries}))
    print(f"[device] {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
