"""Checkpoints of sharded LM state: `repro_torch.checkpoint` with DTensor
leaves on 4 gloo ranks of a (data 2, model 2) CPU mesh, and across
packages with `repro.checkpoint` on 4 virtual JAX devices.

The test writes the f32 smoke TrainState of Qwen2-1.5B (the reference's
init, first and second moments drawn from numpy, step 3) and a batch.
Then, at once, the 4 port ranks (`_torch_launch_rank.py ... checkpoint`)
save it under `ShardingRules(mesh)`, restore it onto (2, 2) with the live
DTensors as `like`, onto (1, 4) and (4, 1) meshes of the same ranks and
whole, take one train step from the restored state and one from the live
state, and restore the reference's checkpoint; and the reference
(`_jax_ckpt_lm.py`) saves the same state laid out by its
`state_shardings` and restores the port's. Every comparison is exact:
restoring moves bytes, it computes nothing.

The manifests of both packages agree leaf by leaf on a mesh whose axes
all exceed 1, but for the optimizer's step: the port keeps it a plain
tensor (no spec recorded), the reference a replicated array (spec []).
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch.parallel.sharding import (
    AbstractMesh, Sharding, ShardingRules, placements_for, spec_of)
from repro_torch.training.train_step import make_abstract_state, \
    state_shardings
from torch.distributed.tensor import Partial, Replicate, Shard

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.abspath(os.path.join(HERE, "..", "src"))
DEADLINE_S = 180
SEP = "/"


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in _flat(tree[key], f"{prefix}{SEP}{key}").items()}
    return {prefix: np.asarray(tree)}


def _finish(name, proc, timeout):
    try:
        log = proc.communicate(timeout=timeout)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, f"{name} exited {proc.returncode}:\n" \
        f"{log[-3000:]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("ckpt_sharded")
    cfg = get_smoke_config("qwen2_1_5b").scaled(dtype="float32")
    params = _flat(jax.tree.map(np.asarray, JT.init_params(
        cfg, jax.random.PRNGKey(0))), "params")
    rng = np.random.default_rng(23)
    state = dict(params)
    for k, v in params.items():
        name = k[len("params"):]
        state["mu" + name] = rng.standard_normal(v.shape).astype(np.float32)
        state["nu" + name] = rng.uniform(0, 1, v.shape).astype(np.float32)
    state["tokens"] = rng.integers(0, cfg.vocab_size, (4, 16)).astype(
        np.int32)
    np.savez(work / "state.npz", **state)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [("reference", subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_jax_ckpt_lm.py"), str(work)],
        env=dict(env, JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True))]
    procs += [(f"port rank {r}", subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_launch_rank.py"), str(r),
         "4", str(work / "pg"), str(work), "checkpoint"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for r in range(4)]
    for name, proc in procs:
        _finish(name, proc, DEADLINE_S)
    return work


def _npz(path):
    with np.load(path) as f:
        return dict(f)


def _assert_trees_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _reports(runs):
    return [json.loads((runs / f"ckpt_{r}.json").read_text())
            for r in range(4)]


def _state(runs):
    """The saved state, keyed as the port's gathered dumps are."""
    src = _npz(runs / "state.npz")
    out = {f"/params{k[len('params'):]}": v for k, v in src.items()
           if k.startswith("params/")}
    for m in ("mu", "nu"):
        out.update({f"/opt/{m}{k[len(m):]}": v for k, v in src.items()
                    if k.startswith(m + "/")})
    out["/opt/step"] = np.asarray(3, np.int32)
    return out


def test_restore_onto_the_same_mesh_is_bit_equal(runs):
    """Every rank's restored local parts are its saved ones, as DTensors;
    what was saved is the state the ranks were given."""
    for rep in _reports(runs):
        assert rep["dtensor_leaves"] and rep["restored_2x2_bit_equal"]
    _assert_trees_equal(_npz(runs / "port_saved.npz"), _state(runs))


@pytest.mark.parametrize("target", ["1x4", "4x1", "whole"])
def test_restore_onto_another_layout_equals_the_saved_state(runs, target):
    """A state written on (data 2, model 2) restored onto (data 1, model
    4), (data 4, model 1) or whole (no mesh): every leaf, gathered, equal
    to the saved one."""
    name = "whole" if target == "whole" else f"restored_{target}"
    _assert_trees_equal(_npz(runs / f"port_{name}.npz"), _state(runs))
    rep = _reports(runs)[0]
    if target == "whole":
        assert rep["whole_is_plain"]
    else:
        assert rep[f"placements_{target}"] != rep[
            "placements_" + ("4x1" if target == "1x4" else "1x4")]


def test_a_resumed_step_is_bit_equal_to_the_live_one(runs):
    for rep in _reports(runs):
        assert rep["resumed_step_bit_equal"]


def test_reference_checkpoint_restores_in_the_port(runs):
    _assert_trees_equal(_npz(runs / "port_from_jax.npz"), _state(runs))


def test_port_checkpoint_restores_in_the_reference(runs):
    _assert_trees_equal(_npz(runs / "jax_from_port.npz"), _state(runs))


def test_manifests_of_both_packages_agree(runs):
    """Leaf names, keys, shapes, dtypes and specs; the step's spec is the
    one difference (plain in the port, replicated in the reference)."""
    port = json.loads((runs / "port_ckpt" / "step_00000001" /
                       "MANIFEST.json").read_text())
    ref = json.loads((runs / "jax_ckpt" / "step_00000001" /
                      "MANIFEST.json").read_text())
    assert len(port["leaves"]) == len(ref["leaves"])
    assert port["format"] == ref["format"] == "shard-store-v1"
    for p, r in zip(port["leaves"], ref["leaves"]):
        assert (p["name"], p["key"], p["shape"], p["dtype"]) == \
            (r["name"], r["key"], r["shape"], r["dtype"])
        if p["key"] == ".opt.step":
            assert (p["spec"], r["spec"]) == (None, [])
        else:
            assert p["spec"] == r["spec"], p["key"]
    assert any(p["spec"] and "model" in json.dumps(p["spec"])
               for p in port["leaves"])


@pytest.mark.parametrize("leaf", ["partial", "uneven"])
def test_partial_and_uneven_leaves_raise(runs, leaf):
    """A Partial() leaf holds partial sums, not a layout; an uneven one
    has local parts of different sizes, which the store cannot name."""
    want = {"partial": "partial sums", "uneven": "uneven"}[leaf]
    for rep in _reports(runs):
        assert rep[f"{leaf}_raises"] and want in rep[f"{leaf}_raises"]


def _flat_leaves(tree):
    if isinstance(tree, Sharding):
        return [tree]
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat_leaves(tree[k])]
    return [tree]


@pytest.mark.parametrize("arch", ["qwen2_1_5b", "qwen2_moe_a2_7b",
                                  "jamba_1_5_large"])
@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 8), (1, 4),
                                        (2, 16, 16)])
def test_spec_of_inverts_placements_for(arch, mesh_shape):
    """For every leaf of the full config's train state: the spec read back
    from its placements is the rules' spec with the mesh axes of size 1
    dropped, and laying it out again gives the same placements."""
    axes = ("pod", "data", "model")[-len(mesh_shape):]
    mesh = AbstractMesh(mesh_shape, axes)
    cfg = tconfigs.get_config(arch)
    rules = ShardingRules(mesh=mesh)
    sizes = dict(zip(axes, mesh_shape))
    state = _flat_leaves(make_abstract_state(cfg))
    shardings = _flat_leaves(state_shardings(cfg, rules))
    assert len(state) == len(shardings)
    for leaf, sh in zip(state, shardings):
        spec = spec_of(mesh, sh.placements, leaf.shape)
        assert placements_for(mesh, spec) == sh.placements
        for entry in spec:
            names = (entry,) if isinstance(entry, str) else entry or ()
            assert all(sizes[n] > 1 for n in names), spec


def test_spec_of_refuses_partial_and_uneven_layouts():
    mesh = AbstractMesh((2, 2), ("data", "model"))
    with pytest.raises(ValueError, match="partial sums"):
        spec_of(mesh, (Partial(), Replicate()), (4, 4))
    with pytest.raises(ValueError, match="uneven"):
        spec_of(mesh, (Shard(0), Replicate()), (5, 4))
    assert spec_of(mesh, (Shard(0), Shard(0)), (8, 4)) == \
        (("data", "model"), None)
