"""The rate `mma.sync` m16n8k8 TF32 reaches alone on the card.

    PYTHONPATH=src python tools/mma_tf32_rate.py

Builds `tools/mma_tf32_rate.cu` with the port's nvcc settings and times
its kernel by CUDA events over one and two blocks per SM, 128 and 256
threads, 8 and 16 independent chains a warp. Each `m16n8k8` product is
16 x 8 x 8 multiply-adds, 2048 operations. The best rate divided by 3 is
the ceiling of a 3xTF32 kernel on `mma.sync` (PERF.md, PR 16). Needs a
CUDA card and nvcc; imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaLibrary

SOURCE = Path(__file__).resolve().with_suffix(".cu")
ITERS = 4096
RUNS = 20
OPS_PER_MMA = 2 * 16 * 8 * 8


def main() -> int:
    if not torch.cuda.is_available():
        print("mma_tf32_rate: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[device] {smi}")
    lib = CudaLibrary("mma_tf32_rate", [SOURCE]).load()
    lib.mma_tf32_rate_launch.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(2 * sms * 256, device="cuda")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = 0.0
    for threads in (128, 256):
        for chains in (8, 16):
            for blocks in (sms, 2 * sms):
                def run():
                    rc = lib.mma_tf32_rate_launch(out.data_ptr(), blocks,
                                                  threads, ITERS, chains)
                    if rc:
                        raise RuntimeError(f"launch failed: cudaError {rc}")
                run()
                start.record()
                for _ in range(RUNS):
                    run()
                end.record()
                torch.cuda.synchronize()
                ms = start.elapsed_time(end) / RUNS
                mmas = blocks * threads // 32 * ITERS * chains
                rate = mmas * OPS_PER_MMA / ms / 1e9
                best = max(best, rate)
                print(f"[mma] m16n8k8 tf32, {blocks} blocks x {threads} "
                      f"threads, {chains} chains a warp: {ms:.4f} ms, "
                      f"{rate:.1f} TFLOP/s")
    print(f"[mma] best {best:.1f} TFLOP/s; 3xTF32 ceiling {best / 3:.1f} "
          "TFLOP/s of the function's operations")
    return 0


if __name__ == "__main__":
    sys.exit(main())
