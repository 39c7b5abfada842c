"""Port parity for the sharded LM substrate: `repro_torch` on 4 gloo ranks
of a (data 2, model 2) CPU mesh against `repro` on a (data 2, model 2)
mesh of 4 virtual CPU devices, both under `ShardingRules(mesh)`.

The test writes each config's weights (the reference's init with the
stacked block weights rescaled to 1 / sqrt(fan_in), as in
test_torch_window.py) and a batch to a work directory. Then, at once,
reference subprocesses (`_jax_mesh_lm.py`, one config each and the
collectives with the last, everything jitted) and the 4 port ranks
(`_torch_mesh_rank.py ... lm`) run the f32 smoke configs of Qwen2-1.5B
(dense, GQA 4/2: each rank attends with 2 query heads and their 1 KV head)
and Mamba-2 (the SSM mixer on each rank's rows), test_torch_parallel_moe.py
Qwen2-MoE's and test_torch_parallel_kv.py Qwen2-1.5B's on a (data 1, model
4) mesh, where the KV heads are replicated: prefill's last logits and every
cache leaf, the prefill again without FSDP, two decode steps, loss_fn's
loss, ce and aux, its gradient with respect to every parameter, and one
train step of 2 micro-batches at the full learning rate (warmup 1) from
zero first moments and second moments of 1 (metrics, every updated
parameter and every first moment). The port gathers each output whole. Both
sides also run `hierarchical_psum`, `hierarchical_psum_scatter` and
`psum_tree` on a (pod 2, data 2) mesh, block by block.

Tolerance: MODEL_TOL 2e-5 of the largest |value| (`close`), as in
test_torch_serving.py: f32 on both sides, differing in summation order
and in where the collectives cut the sums. Gradients, first moments and
updates are held leaf by leaf against the leaf's own largest |value|
(`leaf_close`), so that a leaf whose values are small is not hidden under
the scale of 1. The step's first moment is 0.1 x the clipped gradient
(the micro-batches' mean): it is held like the gradients. The update
(the trained leaf less the leaf it started from) is lr (g / sqrt(19 + g^2)
+ weight decay x p) for the clipped gradient g: smooth in g, where a step
from zero second moments would move each element by lr x its sign and
flip wherever g sits near AdamW's eps. It is held within UPDATE_TOL 1e-3
of the leaf's largest update, plus twice the f32 spacing of the leaf's
largest |weight|, the resolution of a difference of two weights.
`test_checks_reject_a_wrong_step` shows that each check fails on a step
that is wrong in its way. Mamba-2's gradient
norm and gradients are held at test_torch_ssm.py's gradient bound, 1e-4
(SSM_GRAD_TOL): the reference's SSD segment sums cancel in f32 (ROADMAP.md
Queue 3), which moves its gradients' norm by 2.3e-5 relative on these
inputs, where the port's sharded and unsharded steps agree within 1e-6.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from test_torch_models import close
from test_torch_window import fan_in_params

torch.set_num_threads(1)

ARCHS = ["qwen2_1_5b", "mamba2_130m"]
REFERENCE_GROUPS = [["qwen2_1_5b"], ["mamba2_130m", "collectives"]]
MODEL_TOL = 2e-5
SSM_GRAD_TOL = 1e-4
UPDATE_TOL = 1e-3
B, S, STEPS = 4, 16, 2
DEADLINE_S = 180
HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.abspath(os.path.join(HERE, "..", "src"))
COLLECTIVES = ("psum", "psum_no_pod", "psum_scatter", "psum_tree")


def _flat(tree, prefix):
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in _flat(tree[key], f"{prefix}/{key}").items()}
    return {prefix: np.asarray(tree)}


def _write_inputs(work, archs, mesh):
    """Each arch's weights (NAME@CF: NAME's) and batch, the collectives'
    input, and the (data, model) mesh shape and the archs both sides
    run."""
    rng = np.random.default_rng(22)
    for arch in archs:
        params = jax.tree.map(np.asarray, fan_in_params(
            arch.partition("@")[0]))
        vocab = int(params["embed"].shape[0])
        tokens = rng.integers(0, vocab, (B, S)).astype(np.int32)
        np.savez(work / f"inputs_{arch}.npz", **_flat(params, "params"),
                 tokens=tokens, labels=np.roll(tokens, -1, axis=1),
                 decode=rng.integers(0, vocab, (B, STEPS)).astype(np.int32))
    np.save(work / "collectives_in.npy",
            rng.standard_normal((4 * 3, 8)).astype(np.float32))
    (work / "lm.json").write_text(json.dumps({"mesh": list(mesh),
                                              "archs": archs}))


def _finish(name, proc, timeout):
    try:
        log = proc.communicate(timeout=timeout)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, f"{name} exited {proc.returncode}:\n" \
        f"{log[-3000:]}"


def mesh_runs(work, archs, groups, mesh=(2, 2)):
    """Writes the inputs under `work`, then runs the reference's `groups`
    (one subprocess each) and the 4 port ranks at once, both on a (data,
    model) mesh of shape `mesh`; returns `work`."""
    _write_inputs(work, archs, mesh)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [(f"reference {group}", subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_jax_mesh_lm.py"), str(work),
         *group], env=dict(env, JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for group in groups]
    procs += [(f"port rank {r}", subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_mesh_rank.py"), str(r),
         "4", str(work / "pg_lm"), str(work), "lm"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for r in range(4)]
    try:
        for name, p in procs:
            _finish(name, p, DEADLINE_S)
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return work


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return mesh_runs(tmp_path_factory.mktemp("lm_mesh"), ARCHS,
                     REFERENCE_GROUPS)


def _pair(work, arch):
    return (dict(np.load(work / f"port_{arch}.npz")),
            dict(np.load(work / f"ref_{arch}.npz")))


LOGITS = ["prefill_logits", "nofsdp_prefill_logits", "decode_logits_0",
          "decode_logits_1"]


def leaf_close(got, want, tol, floor=0.0):
    """max |got - want| <= tol * max |want| + floor: the leaf's own
    scale."""
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    bound = tol * float(np.abs(want).max()) + floor
    err = float(np.abs(got - want).max())
    assert err <= bound, (err, bound)


def check_logits(work, arch, what):
    got, want = _pair(work, arch)
    close(got[what], want[what], MODEL_TOL)


def check_caches(work, arch):
    got, want = _pair(work, arch)
    keys = sorted(k for k in want if k.startswith("cache/"))
    assert keys and keys == sorted(k for k in got if k.startswith("cache/"))
    for k in keys:
        close(got[k], want[k], MODEL_TOL)


def check_loss(work, arch):
    got, want = _pair(work, arch)
    for k in ("loss", "ce", "aux"):
        close(got[k], want[k], MODEL_TOL)


def _grad_tol(arch):
    return SSM_GRAD_TOL if arch.startswith("mamba2") else MODEL_TOL


def grads_agree(got, want, arch):
    """Every leaf of loss_fn's gradient, each against its own scale."""
    keys = sorted(k for k in want if k.startswith("grads/"))
    assert keys and keys == sorted(k for k in got if k.startswith("grads/"))
    for k in keys:
        leaf_close(got[k], want[k], _grad_tol(arch))


def step_agrees(got, want, params, arch):
    """The step's metrics; each leaf's first moment and its update
    (trained - params), each against its own scale."""
    for k in ("metric_loss", "metric_grad_norm", "metric_lr_scale"):
        close(got[k], want[k], _grad_tol(arch)
              if k == "metric_grad_norm" else MODEL_TOL)
    keys = sorted(k for k in want if k.startswith("trained/"))
    assert keys and keys == sorted(k for k in got if k.startswith("trained/"))
    for k in keys:
        name = k.partition("/")[2]
        leaf_close(got["mu/" + name], want["mu/" + name], _grad_tol(arch))
        start = params["params/" + name]
        leaf_close(got[k] - start, want[k] - start, UPDATE_TOL,
                   2 * float(np.spacing(np.abs(start).max())))


def _params_of(work, arch):
    return {k: v for k, v in np.load(work / f"inputs_{arch}.npz").items()
            if k.startswith("params/")}


def check_grads(work, arch):
    got, want = _pair(work, arch)
    grads_agree(got, want, arch)


def check_train_step(work, arch):
    got, want = _pair(work, arch)
    step_agrees(got, want, _params_of(work, arch), arch)


WRONG = ("unchanged", "one_leaf_unchanged", "one_update_flipped",
         "one_gradient_halved")


def wrong_step(work, arch, name):
    """The check of the port's outputs made wrong in the way `name` says
    (one of WRONG), as a function that must fail."""
    got, want = _pair(work, arch)
    params = _params_of(work, arch)
    trained = sorted(k for k in got if k.startswith("trained/"))
    grads = sorted(k for k in got if k.startswith("grads/"))
    small = min(trained, key=lambda k: got[k].size)   # a bias or a scale

    def unchanged():
        bad = dict(got, **{k: params["params/" + k.partition("/")[2]]
                           for k in trained})
        step_agrees(bad, want, params, arch)

    def one_leaf_unchanged():
        bad = dict(got)
        bad[small] = params["params/" + small.partition("/")[2]]
        step_agrees(bad, want, params, arch)

    def one_update_flipped():
        bad = dict(got)
        start = params["params/" + small.partition("/")[2]]
        bad[small] = 2 * start - got[small]
        step_agrees(bad, want, params, arch)

    def one_gradient_halved():
        bad = dict(got)
        leaf = min(grads, key=lambda k: got[k].size)
        bad[leaf] = got[leaf] / 2
        grads_agree(bad, want, arch)

    return {"unchanged": unchanged, "one_leaf_unchanged": one_leaf_unchanged,
            "one_update_flipped": one_update_flipped,
            "one_gradient_halved": one_gradient_halved}[name]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("what", LOGITS)
def test_logits_match_the_reference(runs, arch, what):
    check_logits(runs, arch, what)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_caches_match_the_reference(runs, arch):
    """Every KV cache leaf (repeats, B, S, K, hd) and SSM conv tail and
    state, whole."""
    check_caches(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_the_reference(runs, arch):
    check_loss(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_the_reference(runs, arch):
    """loss_fn's gradient with respect to every parameter, sharded (the
    partial sums of the gathered weights reduced onto each param's
    layout), against the reference's jax.grad under the same rules."""
    check_grads(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_the_reference(runs, arch):
    """One AdamW step of 2 micro-batches from zero moments: the loss, the
    global gradient norm over the sharded tree, and every leaf's update."""
    check_train_step(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("wrong", WRONG)
def test_checks_reject_a_wrong_step(runs, arch, wrong):
    """The controls: the port's own outputs with every leaf left as it
    was, one small leaf (a bias or a norm scale) left as it was or moved
    the other way, or its gradient halved, each fail the checks above."""
    with pytest.raises(AssertionError):
        wrong_step(runs, arch, wrong)()


@pytest.mark.parametrize("name", COLLECTIVES)
def test_collectives_match_the_reference(runs, name):
    """Each rank's block of the (pod 2, data 2) collectives against the
    reference's shard_map block of the same device."""
    want = np.split(np.load(runs / "ref_collectives.npz")[name], 4)
    for r in range(4):
        got = np.load(runs / f"port_collectives_{r}.npz")[name]
        close(got, want[r], MODEL_TOL)


def test_weights_sharded_and_checkpoint_refused(runs):
    """Each rank holds a quarter of the embedding (vocab over model, d
    over data), and a checkpoint of the sharded state names item 23."""
    for r in range(4):
        report = json.loads((runs / f"lm_{r}.json").read_text())
        for arch in ARCHS:
            assert "item 23" in report[arch]["checkpoint"]
        assert report["qwen2_1_5b"]["local_embed"] == [128, 32]


def test_rules_leave_the_collectives_alone(runs):
    """Sharding rules on a CPU DeviceMesh install nothing: DTensor's
    collectives keep their own path (only a CUDA mesh over gloo reroutes
    them, `parallel.mesh.make_mesh`)."""
    for r in range(4):
        report = json.loads((runs / f"lm_{r}.json").read_text())
        assert report["rerouted"] is False
