"""The reference side of tests/test_torch_checkpoint_sharded.py: `repro`'s
sharded TrainState checkpoints on a (data 2, model 2) mesh of 4 virtual
CPU devices.

    PYTHONPATH=src python tests/_jax_ckpt_lm.py WORK_DIR

Builds the f32 smoke TrainState of Qwen2-1.5B from WORK_DIR/state.npz
(step 3), lays it out by the reference's `state_shardings` under
`ShardingRules(mesh)` and saves it to WORK_DIR/jax_ckpt. Then waits for
the port's checkpoint WORK_DIR/port_ckpt, restores it onto the same mesh
with the reference's `load_checkpoint` and writes every leaf, gathered,
to WORK_DIR/jax_from_port.npz.

The mesh is built with `devices=` (see tests/_jax_mesh_lm.py).
"""
import os
import sys
import time

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs  # noqa: E402
from repro.checkpoint import (  # noqa: E402
    committed_steps, load_checkpoint, save_checkpoint)
from repro.optim import OptState  # noqa: E402
from repro.parallel.mesh import make_mesh  # noqa: E402
from repro.parallel.sharding import ShardingRules  # noqa: E402
from repro.training.train_step import (  # noqa: E402
    TrainState, state_shardings)

SEP = "/"
DEADLINE_S = 120


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


def flatten(tree, prefix=""):
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in flatten(tree[key], f"{prefix}{SEP}{key}").items()}
    return {prefix: np.asarray(tree)}


def main() -> None:
    work = sys.argv[1]
    cfg = configs.get_smoke_config("qwen2_1_5b").scaled(dtype="float32")
    mesh = make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4])
    rules = ShardingRules(mesh=mesh)
    flat = dict(np.load(os.path.join(work, "state.npz")))
    state = TrainState(unflatten(flat, "params"), OptState(
        jnp.int32(3), unflatten(flat, "mu"), unflatten(flat, "nu")))
    state = jax.device_put(state, state_shardings(cfg, rules))
    save_checkpoint(os.path.join(work, "jax_ckpt"), 1, state)

    port_ckpt = os.path.join(work, "port_ckpt")
    deadline = time.monotonic() + DEADLINE_S
    while not committed_steps(port_ckpt):
        if time.monotonic() > deadline:
            raise TimeoutError("the port's checkpoint did not appear")
        time.sleep(0.2)
    back = load_checkpoint(port_ckpt, 1, state, mesh=mesh)
    np.savez(os.path.join(work, "jax_from_port.npz"), **flatten(back))


if __name__ == "__main__":
    main()
