"""One dry-run cell's per-rank peak memory and counts, with whatever torch
this machine has.

    PYTHONPATH=src python tools/dryrun_rank_peak.py [LAYERS]

Dry-runs Qwen2-1.5B x train_4k (256 x 4096 tokens, 8 micro-batches) on
the (32, 8) production mesh with its depth cut to LAYERS (default 2), and
prints the torch version and the row's peak memory, traced FLOPs and
collectives by group. Run on the CPU here and on the card's machine, it
shows whether both torch versions count the same rank (the dry run must
leave DTensor's global-shape sharding propagation out of its memory
tracker). Imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402


def main() -> None:
    layers = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    print(f"torch {torch.__version__}")
    cfg = dataclasses.replace(get_config("qwen2_1_5b"), num_layers=layers)
    dryrun.run_cell("qwen2_1_5b", "train_4k", False, cfg=cfg,
                    shape_info=dict(kind="train", seq=4096, batch=256),
                    microbatches=8)


if __name__ == "__main__":
    main()
