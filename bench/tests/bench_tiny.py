"""A copy of the benchmark at test sizes, for the CPU tests: the same
BENCHMARK.json, files and harness, with every configuration's geometry cut
to a 16^3 volume from 32 projections of 24 x 20."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = dict(n_proj=32, n_u=24, n_v=20, d_u=4.8 / 24, d_v=4.8 / 24,
            n_x=16, n_y=16, n_z=16, d_x=2 / 16, d_y=2 / 16, d_z=2 / 16)


def make_tree(dest: Path) -> Path:
    """The benchmark copied under `dest` at test sizes; returns `dest`."""
    shutil.copytree(ROOT / "bench", dest / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg["geometry"].update(TINY)
        (dest / c["file"]).write_text(json.dumps(cfg))
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    return dest


def quiet(_msg: str) -> None:
    pass
