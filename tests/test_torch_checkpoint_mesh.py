"""Port sharded checkpoints across ranks: four gloo ranks of
`tests/_torch_mesh_rank.py` (mode checkpoint-save) reconstruct on a
(pod, data, model) = (1, 2, 2) mesh and save their parts as one checkpoint
(x-slabs over `model`, replicated over `data`; and the scatter layout, y
also over `data`), each rank writing only its own shards, and load it back
on the same mesh, each its own part bit-equal. This process then loads the
checkpoint with mesh=None (bit-equal to the assembled volumes), and two
ranks (mode checkpoint-load) restore it on a (1, 1, 2) mesh — an elastic
restart onto fewer ranks — each getting exactly its slice. Every process
group has a 60 s timeout and every rank a deadline.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import phantom as jph
from repro.core.geometry import default_geometry as jdefault_geometry
from repro_torch.checkpoint import load_checkpoint
from repro_torch.io import shard_store

torch.set_num_threads(1)

DEADLINE_S = 120
HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
LEAVES = ("slab", "scattered")


def spawn(world, work, mode):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               OMP_NUM_THREADS="1")
    init = work / f"pg_{mode}"
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_mesh_rank.py"), str(r),
         str(world), str(init), str(work), mode],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=DEADLINE_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"{mode} rank {r} exited {p.returncode}:" \
            f"\n{log[-3000:]}"


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    work = tmp_path_factory.mktemp("ckpt122")
    g = jdefault_geometry(16, n_proj=32)
    rng = np.random.default_rng(18)
    proj = np.asarray(jph.forward_project(g))
    np.save(work / "proj.npy", (proj + 0.01 * rng.standard_normal(
        proj.shape)).astype(np.float32))
    spawn(4, work, "checkpoint-save")
    spawn(2, work, "checkpoint-load")
    return work, dict(np.load(work / "assembled.npz"))


def _json(path):
    with open(path) as f:
        return json.load(f)


def test_each_rank_reads_back_its_own_part(ckpt):
    work, _ = ckpt
    for r in range(4):
        rep = _json(work / f"save_rank{r}.json")
        assert rep["equal"] and rep["cursor"] == 3, r
        # one shard file per leaf: the scalar, the slab and one
        # (slab, y-half) block
        assert rep["opened"] == 3, r


def test_each_rank_wrote_only_its_shards(ckpt):
    work, _ = ckpt
    step = work / "ckpt" / "step_00000001"
    assert (step / ".COMMITTED").exists()
    man = _json(step / "MANIFEST.json")
    assert [e["spec"] for e in man["leaves"]] == [None, ["model", "data"],
                                                  ["model"]]
    assert [e["key"] for e in man["leaves"]] == [
        "['cursor']", "['scattered']", "['slab']"]
    # the slab is replicated over data: 2 distinct shards, not 4
    counts = [len(os.listdir(step / "leaves" / e["name"] / "shards"))
              for e in man["leaves"]]
    assert counts == [1, 4, 2]


def test_whole_load_is_the_assembled_volume(ckpt):
    work, assembled = ckpt
    like = {"cursor": np.int64(0),
            **{k: torch.empty(assembled[k].shape, device="meta")
               for k in LEAVES}}
    shard_store.reset_open_count()
    out = load_checkpoint(str(work / "ckpt"), 1, like, device="cpu")
    assert shard_store.open_count() == 1 + 4 + 2
    assert int(out["cursor"]) == 3
    for k in LEAVES:
        assert np.array_equal(out[k].numpy(), assembled[k]), k


def test_elastic_restore_on_two_ranks(ckpt):
    """(1, 1, 2): the x-halves over model; data has one rank, so the
    scatter leaf's y is whole there."""
    work, assembled = ckpt
    for r in range(2):
        meta = _json(work / f"load_rank{r}.json")
        m = meta["coord"][2]
        got = dict(np.load(work / f"load_rank{r}.npz"))
        assert int(got["cursor"]) == 3
        for k in LEAVES:
            n = assembled[k].shape[0] // 2
            assert np.array_equal(got[k], assembled[k][m * n:(m + 1) * n]), \
                (r, k)
        # the scalar; slab: its model half (1 file); scattered: the 2
        # y-halves of it
        assert meta["opened"] == 1 + 1 + 2, r
