"""`chip_smoke.py`'s `[launch]` and `[lm-mesh]` (with `[lm-ckpt]`) alone,
after the card tests: the quick check of those phases on the card.

    python3 tools/chip_phases.py  # one H100, about 15 minutes

Builds the three kernel libraries (one nvcc each, at once), runs the card
tests (`pytest --noconftest -m gpu tests/test_torch_gpu.py`), then
`chip_smoke.launch_phase` and `chip_smoke.lm_mesh` on full-width
Qwen2-1.5B and Qwen2-MoE-A2.7B, and joins the production cells that
`[launch]` starts. Any gate that fails exits non-zero, as in
`chip_smoke.py`. Imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import concurrent.futures
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.attention import kernel as fak  # noqa: E402
from repro_torch.kernels.backproject import kernel as bpk  # noqa: E402
from repro_torch.kernels.filter import kernel as rfk  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_phases: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    print(f"[check] {C.nvidia_smi_line()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    libs = (bpk.LIBRARY, fak.LIBRARY, rfk.LIBRARY)
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        for fut in [pool.submit(lib.build) for lib in libs]:
            fut.result()
    work = tempfile.mkdtemp(prefix="chip-phases-")
    os.environ["REPRO_TUNE_CACHE"] = os.path.join(work, "tune.json")
    os.environ["REPRO_CALIB_CACHE"] = os.path.join(work, "calib.json")
    tests = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q", "-m", "gpu",
         "-p", "no:cacheprovider", "tests/test_torch_gpu.py"], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        capture_output=True, text=True)
    print(f"[check] card tests exit {tests.returncode}: "
          f"{tests.stdout.strip().splitlines()[-1]}", flush=True)
    dev = torch.device("cuda")
    cfg = get_config("qwen2_1_5b")
    production, launched = C.launch_phase(cfg, dev, work)
    meshed = C.lm_mesh(cfg, get_config("qwen2_moe_a2_7b"), dev, work)
    C.finish_production_cells(production)
    print(f"[check] attention launches: [launch] {launched}, [lm-mesh] "
          f"{meshed}; {time.perf_counter() - t0:.1f} s", flush=True)
    return tests.returncode


if __name__ == "__main__":
    sys.exit(main())
