"""The reference side of tests/test_torch_parallel_lm.py: `repro`'s LM
substrate under sharding rules on a (data, model) mesh of 4 virtual CPU
devices, of the shape WORK_DIR/lm.json names ("mesh": (2, 2) or (1, 4)).

    PYTHONPATH=src python tests/_jax_mesh_lm.py WORK_DIR ARCH [ARCH]

ARCH is a smoke config's name, or NAME@CF for its MoE at capacity
factor CF (`lm_config`; the port's ranks read ARCH the same way).

Reads WORK_DIR/inputs_<ARCH>.npz (the weights and the batch the test wrote)
and writes WORK_DIR/ref_<ARCH>.npz: the prefill's last logits and every
cache leaf, two decode steps' logits, loss_fn's loss, ce and aux and its
gradient with respect to every param (`jax.grad`), and one train step's
metrics, updated params and first moments, each jitted under
`ShardingRules(mesh)`; the prefill also under `ShardingRules(mesh,
fsdp=False)`. The train step starts from zero first moments and second
moments of 1, so that its update is smooth in the gradient (lr (g / sqrt(19
+ g^2) + weight decay x p) at step 1, not lr x the sign of g), and runs
with warmup 1, at the full learning rate. With ARCH "collectives" it writes
WORK_DIR/ref_collectives.npz instead: `hierarchical_psum`,
`hierarchical_psum_scatter` and `psum_tree` under shard_map on a (pod 2,
data 2) mesh, each device's block.

The mesh is built with `devices=`: jax 0.9's default `jax.make_mesh`
gives Explicit axes, on which the rules' `with_sharding_constraint`
raises (ROADMAP.md Queue 3).
"""
import dataclasses
import json
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro.optim import OptState  # noqa: E402
from repro.parallel.mesh import make_mesh  # noqa: E402
from repro.parallel.sharding import ShardingRules  # noqa: E402
from repro.training.train_step import TrainState, make_train_step  # noqa

SEP = "/"
WARMUP = 1   # the train step's learning rate scale at step 1 is 1


def unflatten(flat, prefix):
    out = {}
    for key, v in flat.items():
        if not key.startswith(prefix + SEP):
            continue
        *path, name = key[len(prefix) + 1:].split(SEP)
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[name] = jnp.asarray(v)
    return out


def flatten(tree, prefix):
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in flatten(tree[key], f"{prefix}{SEP}{key}").items()}
    return {prefix: np.asarray(tree)}


def lm_config(get_smoke_config, arch: str):
    """The f32 smoke config ARCH names: NAME, or NAME@CF (its MoE at
    capacity factor CF)."""
    name, _, cf = arch.partition("@")
    cfg = get_smoke_config(name).scaled(dtype="float32")
    if cf:
        cfg = cfg.scaled(moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cf)))
    return cfg


def lm(work: str, arch: str, mesh) -> None:
    cfg = lm_config(configs.get_smoke_config, arch)
    inputs = dict(np.load(os.path.join(work, f"inputs_{arch}.npz")))
    params = unflatten(inputs, "params")
    tokens = jnp.asarray(inputs["tokens"])
    out = {}
    for name, rules in (("", ShardingRules(mesh=mesh)),
                        ("nofsdp_", ShardingRules(mesh=mesh, fsdp=False))):
        logits, cache = jax.jit(lambda p, t: T.prefill(
            p, cfg, {"tokens": t}, rules))(params, tokens)
        out[f"{name}prefill_logits"] = np.asarray(logits)
        if name:
            continue
        out.update(flatten(cache, "cache"))
        b, s0 = tokens.shape
        s_max = s0 + inputs["decode"].shape[1]
        full = T.init_cache(cfg, b, s_max)

        def place(big, small):
            if small.ndim >= 3 and small.shape[2] == s0 \
                    and big.shape[2] == s_max:
                return jax.lax.dynamic_update_slice_in_dim(
                    big, small.astype(big.dtype), 0, axis=2)
            return small.astype(big.dtype)
        cache = jax.tree.map(place, full, cache)
        step = jax.jit(lambda p, c, t, n: T.decode_step(p, cfg, c, t, n,
                                                        rules))
        for i in range(inputs["decode"].shape[1]):
            tok = jnp.asarray(inputs["decode"][:, i:i + 1])
            logits, cache = step(params, cache, tok, jnp.int32(s0 + i))
            out[f"decode_logits_{i}"] = np.asarray(logits)
        batch = {"tokens": tokens, "labels": jnp.asarray(inputs["labels"])}
        loss, parts = jax.jit(lambda p, bt: T.loss_fn(p, cfg, bt, rules))(
            params, batch)
        out["loss"] = np.asarray(loss)
        out["ce"], out["aux"] = np.asarray(parts["ce"]), np.asarray(
            parts["aux"])
        grads = jax.jit(jax.grad(lambda p, bt: T.loss_fn(p, cfg, bt,
                                                         rules)[0]))(
            params, batch)
        out.update(flatten(grads, "grads"))
        zeros = jax.tree.map(jnp.zeros_like, params)
        ones = jax.tree.map(jnp.ones_like, params)
        state = TrainState(params, OptState(jnp.zeros((), jnp.int32), zeros,
                                            ones))
        train = jax.jit(make_train_step(cfg, rules=rules, microbatches=2,
                                        warmup=WARMUP))
        new, metrics = train(state, batch)
        for k, v in metrics.items():
            out[f"metric_{k}"] = np.asarray(v)
        out.update(flatten(new.params, "trained"))
        out.update(flatten(new.opt.mu, "mu"))
    np.savez(os.path.join(work, f"ref_{arch}.npz"), **out)


def collectives(work: str) -> None:
    from repro.compat import shard_map
    from jax.sharding import PartitionSpec as P
    from repro.parallel import collectives as C

    mesh = make_mesh((2, 2), ("pod", "data"), devices=jax.devices()[:4])
    x = jnp.asarray(np.load(os.path.join(work, "collectives_in.npy")))
    spec = P(("pod", "data"))

    def run(fn):
        return np.asarray(jax.jit(shard_map(
            fn, mesh=mesh, in_specs=spec, out_specs=spec))(x))

    out = {
        "psum": run(lambda b: C.hierarchical_psum(b, scatter_dim=1)),
        "psum_no_pod": run(lambda b: C.hierarchical_psum(
            b, scatter_dim=1, have_pod=False)),
        "psum_scatter": run(lambda b: C.hierarchical_psum_scatter(
            b, scatter_dim=1)),
        "psum_tree": run(lambda b: C.psum_tree({"g": b}, ("pod",))["g"]),
    }
    np.savez(os.path.join(work, "ref_collectives.npz"), **out)


def main() -> None:
    work, archs = sys.argv[1], sys.argv[2:]
    with open(os.path.join(work, "lm.json")) as f:
        shape = tuple(json.load(f)["mesh"])
    mesh = make_mesh(shape, ("data", "model"), devices=jax.devices()[:4])
    for arch in archs:
        if arch == "collectives":
            collectives(work)
        else:
            lm(work, arch, mesh)


if __name__ == "__main__":
    main()
