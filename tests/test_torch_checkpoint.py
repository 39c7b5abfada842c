"""Port parity for `repro_torch.checkpoint`: the reference's
tests/test_checkpoint.py checkpoint cases on the port, the corruption kinds
as parametrized cases (one fresh directory each), and byte compatibility
both ways: a checkpoint written by `repro.checkpoint` loads in the port,
and one written by the port loads in `repro.checkpoint`, leaves bit-equal
and keys equal. The leaf keys are JAX's `keystr` strings for every
container the port flattens. Specs on a mesh: a (1, 1) gloo mesh over a
world of one in this process; several ranks are
tests/test_torch_checkpoint_mesh.py.
"""
import collections
import datetime
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import checkpoint as jckpt
from repro.compat import tree_flatten_with_path
from repro_torch.checkpoint import (
    CheckpointManager, StoreError, committed_steps, latest_step,
    load_checkpoint, save_checkpoint,
)
from repro_torch.checkpoint.io import _flatten
from repro_torch.io import shard_store
from repro_torch.parallel.mesh import single_device_mesh

torch.set_num_threads(1)

CPU = "cpu"
KINDS = ("truncated_shard", "missing_manifest_entry", "missing_commit")
Pair = collections.namedtuple("Pair", "lo hi")


def _tree():
    return {
        "w": torch.arange(12.0).reshape(3, 4),
        "nested": {"b": torch.ones((5,), dtype=torch.float32),
                   "step": np.int64(7)},
    }


def _manifest(path):
    with open(os.path.join(path, "MANIFEST.json")) as f:
        return json.load(f)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """A (1, 1) (data, model) mesh over a gloo world of one."""
    init = tmp_path_factory.mktemp("pg") / "init"
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield single_device_mesh(CPU)
    finally:
        dist.destroy_process_group()


class TestCheckpointIO:
    def test_roundtrip(self, tmp_path):
        t = _tree()
        save_checkpoint(str(tmp_path), 3, t)
        assert latest_step(str(tmp_path)) == 3
        out = load_checkpoint(str(tmp_path), 3, t, device=CPU)
        assert torch.equal(out["w"], t["w"])
        assert torch.equal(out["nested"]["b"], t["nested"]["b"])
        assert int(out["nested"]["step"]) == 7

    def test_commit_marker_required(self, tmp_path):
        t = _tree()
        p = save_checkpoint(str(tmp_path), 1, t)
        os.remove(os.path.join(p, ".COMMITTED"))
        assert latest_step(str(tmp_path)) is None  # uncommitted is invisible

    def test_shape_mismatch_rejected(self, tmp_path):
        t = _tree()
        save_checkpoint(str(tmp_path), 1, t)
        bad = dict(t)
        bad["w"] = torch.zeros((2, 2))
        with pytest.raises(ValueError):
            load_checkpoint(str(tmp_path), 1, bad, device=CPU)

    def test_manager_retention_and_async(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, _tree(), blocking=False)
        mgr.wait()
        mgr._gc()
        steps = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path)
                       if n.startswith("step_"))
        assert steps == [3, 4]
        s, tree = mgr.restore_latest(_tree(), device=CPU)
        assert s == 4 and tree is not None

    def test_manager_snapshot_is_taken_before_save_returns(self, tmp_path):
        """The caller may overwrite its tensors as soon as save returns:
        the background writer stores the values of the call."""
        t = _tree()
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, t, blocking=False)
        t["w"].fill_(-1.0)
        mgr.wait()
        _, out = mgr.restore_latest(_tree(), device=CPU)
        assert torch.equal(out["w"], _tree()["w"])

    def test_load_defaults_to_the_card(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("this host has a CUDA device")
        save_checkpoint(str(tmp_path), 1, _tree())
        with pytest.raises(RuntimeError, match='device="cpu"'):
            load_checkpoint(str(tmp_path), 1, _tree())


class TestSpecRecording:
    """None ("no spec recorded": a tensor saved without a mesh) and []
    (a real, fully replicated layout on a mesh) are distinct in the
    manifest and on restore."""

    def test_manifest_distinguishes_none_from_empty_spec(self, tmp_path,
                                                         mesh):
        t = {
            "host": np.arange(6.0, dtype=np.float32).reshape(2, 3),
            "default": torch.ones((4,)),
            "replicated": shard_store.snapshot(torch.ones((4,)), mesh, []),
            "sharded": shard_store.snapshot(torch.ones((4, 2)), mesh,
                                            ["model"]),
        }
        p = save_checkpoint(str(tmp_path), 1, t)
        specs = {e["key"]: e["spec"] for e in _manifest(p)["leaves"]}
        by = {k.strip("[']"): v for k, v in specs.items()}
        assert by["host"] is None
        assert by["default"] is None
        assert by["replicated"] == []        # real spec, recorded
        assert by["sharded"] == ["model"]

    def test_restore_applies_spec_only_where_recorded(self, tmp_path, mesh):
        """A leaf with a spec comes back as this rank's region of it (the
        whole array on a mesh of one); a leaf without one comes back whole
        without consulting the mesh."""
        t = {
            "host": np.arange(3.0, dtype=np.float32),
            "replicated": shard_store.snapshot(torch.ones((4,)), mesh, []),
            "sharded": shard_store.snapshot(torch.arange(8.0).reshape(4, 2),
                                            mesh, ["model"]),
        }
        save_checkpoint(str(tmp_path), 1, t)
        out = load_checkpoint(str(tmp_path), 1, t, mesh=mesh, device=CPU)
        np.testing.assert_array_equal(out["host"].numpy(), t["host"])
        assert torch.equal(out["replicated"], torch.ones((4,)))
        assert torch.equal(out["sharded"], torch.arange(8.0).reshape(4, 2))

    def test_async_manager_snapshot_keeps_spec(self, tmp_path, mesh):
        t = {"w": shard_store.snapshot(torch.arange(8.0).reshape(4, 2), mesh,
                                       ["model"])}
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, t, blocking=False)
        mgr.wait()
        p = os.path.join(str(tmp_path), "step_00000001")
        assert [e["spec"] for e in _manifest(p)["leaves"]] == [["model"]]
        step, out = mgr.restore_latest(t, mesh=mesh, device=CPU)
        assert step == 1
        assert torch.equal(out["w"], torch.arange(8.0).reshape(4, 2))

    def test_mesh_region_rejects_an_axis_the_mesh_lacks(self, mesh):
        with pytest.raises(ValueError, match="lacks"):
            shard_store.mesh_region((4, 2), mesh, ["pod"])


class TestOrphanedTmpSweep:
    def _seed_tmp(self, directory, step=5):
        tmp = os.path.join(directory, f"step_{step:08d}.tmp")
        os.makedirs(os.path.join(tmp, "leaves", "leaf_99999"))
        with open(os.path.join(tmp, "leaves", "leaf_99999", "junk.bin"),
                  "w") as f:
            f.write("crashed writer leftovers")
        return tmp

    def test_manager_init_sweeps_orphans(self, tmp_path):
        tmp = self._seed_tmp(str(tmp_path))
        CheckpointManager(str(tmp_path))
        assert not os.path.exists(tmp)

    def test_gc_sweeps_orphans(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2)
        tmp = self._seed_tmp(str(tmp_path), step=9)
        mgr.save(1, _tree(), blocking=True)
        assert not os.path.exists(tmp)
        assert latest_step(str(tmp_path)) == 1

    def test_stale_tmp_does_not_shadow_later_save(self, tmp_path):
        self._seed_tmp(str(tmp_path), step=5)
        save_checkpoint(str(tmp_path), 5, _tree())
        leaves = os.listdir(
            os.path.join(str(tmp_path), "step_00000005", "leaves"))
        assert "leaf_99999" not in leaves
        out = load_checkpoint(str(tmp_path), 5, _tree(), device=CPU)
        assert torch.equal(out["w"], _tree()["w"])


def _corrupt(directory, step, kind):
    path = os.path.join(directory, f"step_{step:08d}")
    if kind == "truncated_shard":
        shard = os.path.join(path, "leaves", "leaf_00000", "shards",
                             "shard_00000.bin")
        with open(shard, "r+b") as f:
            f.truncate(3)
    elif kind == "missing_manifest_entry":
        mpath = os.path.join(path, "leaves", "leaf_00000", "MANIFEST.json")
        with open(mpath) as f:
            m = json.load(f)
        m["shards"] = []
        with open(mpath, "w") as f:
            json.dump(m, f)
    elif kind == "missing_commit":
        os.remove(os.path.join(path, ".COMMITTED"))
    else:
        raise AssertionError(kind)


class TestCorruptionHandling:
    """Truncated shard, gutted manifest and missing commit marker each fail
    loudly, and restore_latest falls back to the newest committed step that
    still loads."""

    @pytest.mark.parametrize("kind", KINDS)
    def test_corruption_raises_and_restore_falls_back(self, tmp_path, kind):
        d = str(tmp_path)
        mgr = CheckpointManager(d)
        mgr.save(1, _tree(), blocking=True)
        mgr.save(2, _tree(), blocking=True)
        _corrupt(d, 2, kind)
        if kind == "missing_commit":
            assert latest_step(d) == 1       # uncommitted is invisible
        else:
            assert latest_step(d) == 2       # committed but unreadable
        with pytest.raises(StoreError):
            load_checkpoint(d, 2, _tree(), device=CPU)
        step, tree = mgr.restore_latest(_tree(), device=CPU)
        assert step == 1 and tree is not None
        assert torch.equal(tree["w"], _tree()["w"])

    def test_error_messages_name_the_problem(self, tmp_path):
        d = str(tmp_path)
        save_checkpoint(d, 1, _tree())
        _corrupt(d, 1, "truncated_shard")
        with pytest.raises(StoreError, match="truncated"):
            load_checkpoint(d, 1, _tree(), device=CPU)
        save_checkpoint(d, 2, _tree())
        _corrupt(d, 2, "missing_commit")
        with pytest.raises(StoreError, match="uncommitted"):
            load_checkpoint(d, 2, _tree(), device=CPU)

    def test_nothing_loadable_returns_none_with_warning(self, tmp_path):
        d = str(tmp_path)
        mgr = CheckpointManager(d)
        mgr.save(1, _tree(), blocking=True)
        _corrupt(d, 1, "truncated_shard")
        with pytest.warns(RuntimeWarning, match="no committed checkpoint"):
            step, tree = mgr.restore_latest(_tree(), device=CPU)
        assert step is None and tree is None

    def test_committed_steps_lists_only_committed(self, tmp_path):
        d = str(tmp_path)
        save_checkpoint(d, 1, _tree())
        save_checkpoint(d, 3, _tree())
        _corrupt(d, 3, "missing_commit")
        assert committed_steps(d) == [1]


# ---------------------------------------------------------------------------
# across packages

def _mixed(lib):
    """The same tree in either package's leaves: dicts (sorted), a list, a
    tuple with a None, a namedtuple, scalars, f32/bf16/int leaves."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    h = rng.standard_normal((6,)).astype(np.float32)
    if lib == "jax":
        arr, bf = jnp.asarray, jnp.asarray(h, jnp.bfloat16)
    else:
        arr, bf = torch.as_tensor, torch.as_tensor(h).to(torch.bfloat16)
    return {"w": arr(w), "opt": [arr(w * 2.0), (bf, None)],
            "pair": Pair(arr(np.arange(4, dtype=np.int32)), np.float32(1.5)),
            "cursor": np.int64(9)}


def test_keys_are_jax_keystrs():
    want = [jax.tree_util.keystr(kp)
            for kp, _ in tree_flatten_with_path(_mixed("jax"))[0]]
    assert [k for k, _ in _flatten(_mixed("torch"))[0]] == want


def test_a_jax_checkpoint_loads_in_the_port(tmp_path):
    jckpt.save_checkpoint(str(tmp_path), 4, _mixed("jax"))
    out = load_checkpoint(str(tmp_path), 4, _mixed("torch"), device=CPU)
    want = [leaf for _, leaf in tree_flatten_with_path(_mixed("jax"))[0]]
    got = [leaf for _, leaf in _flatten(out)[0]]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert shard_store.dtype_name(a.dtype) == str(b.dtype)
        if a.dtype == torch.bfloat16:
            a, b = a.float(), b.astype(np.float32)
        np.testing.assert_array_equal(a.numpy(), b)
    assert isinstance(out["pair"], Pair) and out["opt"][1][1] is None


def test_a_port_checkpoint_loads_in_jax(tmp_path):
    p = save_checkpoint(str(tmp_path), 4, _mixed("torch"))
    out = jckpt.load_checkpoint(str(tmp_path), 4, _mixed("jax"))
    want = [leaf for _, leaf in _flatten(_mixed("torch"))[0]]
    got = [leaf for _, leaf in tree_flatten_with_path(out)[0]]
    for a, b in zip(got, want):
        a = np.asarray(a)
        if isinstance(b, torch.Tensor) and b.dtype == torch.bfloat16:
            a, b = a.astype(np.float32), b.float()
        np.testing.assert_array_equal(a, _np(b))
    jkeys = [jax.tree_util.keystr(kp)
             for kp, _ in tree_flatten_with_path(_mixed("jax"))[0]]
    assert [e["key"] for e in _manifest(p)["leaves"]] == jkeys


def test_manifests_agree_across_packages(tmp_path):
    """Everything but the informational treedef string is equal."""
    pj = jckpt.save_checkpoint(str(tmp_path / "jax"), 2, _mixed("jax"))
    pt = save_checkpoint(str(tmp_path / "torch"), 2, _mixed("torch"))
    mj, mt = _manifest(pj), _manifest(pt)
    mj.pop("treedef"), mt.pop("treedef")
    assert mj == mt
    for e in mj["leaves"]:
        assert (_manifest(os.path.join(pj, "leaves", e["name"]))
                == _manifest(os.path.join(pt, "leaves", e["name"])))
