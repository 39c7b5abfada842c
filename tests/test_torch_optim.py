"""Port parity for `repro_torch.optim` against `repro.optim`: the cosine
schedule in f32, and AdamW over three steps on identical numpy params,
gradients and moments, unclipped and clipped."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.optim.schedule import cosine_schedule as j_cosine
from repro_torch import optim as topt
from repro_torch.optim import cosine_schedule

torch.set_num_threads(1)

REL = 1e-6
SHAPES = {"a": (7, 5), "b": {"c": (3,), "d": (2, 4, 3)}}


@pytest.mark.parametrize("warmup,total", [(100, 10_000), (2, 16), (0, 5),
                                          (10, 10)])
def test_cosine_schedule_matches_the_reference(warmup, total):
    """Against the reference evaluated op by op (vmapped, not jitted):
    under jit XLA turns the division by the constant into a product with
    its reciprocal, which moves the f32 result by up to 3 ulps (1.8e-7 at
    warmup 100, total 10 000)."""
    steps = np.arange(0, 2 * total + 1)
    want = np.asarray(jax.vmap(lambda s: j_cosine(s, warmup, total))(
        jnp.asarray(steps)))
    got = torch.stack([cosine_schedule(torch.tensor(int(s), dtype=torch.int32),
                                       warmup, total) for s in steps])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)
    assert float(cosine_schedule(3, warmup, total)) == pytest.approx(
        float(want[3]), abs=1e-7)


def _tree(rng, scale=1.0):
    def draw(shape):
        if isinstance(shape, dict):
            return {k: draw(v) for k, v in shape.items()}
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return draw(SHAPES)


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], prefix + (k,)))
        return out
    return {prefix: np.asarray(tree.detach() if isinstance(tree, torch.Tensor)
                               else tree)}


def _close(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=REL,
                                   atol=REL * np.abs(want[k]).max(),
                                   err_msg=str(k))


@pytest.mark.parametrize("grad_clip", [1e3, 0.5])
def test_adamw_update_matches_the_reference(grad_clip):
    """grad_clip 1e3 leaves the gradients alone; 0.5 is below every step's
    global norm, so every step clips."""
    rng = np.random.default_rng(0)
    cfg_j = jopt.AdamWConfig(grad_clip=grad_clip)
    cfg_t = topt.AdamWConfig(grad_clip=grad_clip)
    params = _tree(rng)
    mu, nu = _tree(rng, 0.1), _map(np.abs, _tree(rng, 0.01))
    j_state = jopt.OptState(jnp.int32(4), _map(jnp.asarray, mu),
                            _map(jnp.asarray, nu))
    j_params = _map(jnp.asarray, params)
    t_state = topt.OptState(torch.tensor(4, dtype=torch.int32),
                            _map(torch.tensor, mu), _map(torch.tensor, nu))
    t_params = _map(torch.tensor, params)
    update = jax.jit(jopt.adamw_update, static_argnums=0)
    for i in range(3):
        grads = _tree(rng, 3.0)
        lr_scale = 0.5 + 0.25 * i
        j_params, j_state, jm = update(cfg_j, _map(jnp.asarray, grads),
                                       j_state, j_params, lr_scale)
        same = t_params
        t_params, t_state, tm = topt.adamw_update(
            cfg_t, _map(torch.tensor, grads), t_state, t_params,
            torch.tensor(lr_scale))
        assert t_params is same
        gnorm = float(jm["grad_norm"])
        assert (gnorm > grad_clip) == (grad_clip < 1)
        np.testing.assert_allclose(float(tm["grad_norm"]), gnorm, rtol=REL)
        assert t_state.step.dtype == torch.int32
        assert int(t_state.step) == int(j_state.step) == 5 + i
        _close(t_params, j_params)
        _close(t_state.mu, j_state.mu)
        _close(t_state.nu, j_state.nu)


def test_global_norm_matches_the_reference():
    tree = _tree(np.random.default_rng(1))
    want = float(jopt.adamw.global_norm(_map(jnp.asarray, tree)))
    got = topt.global_norm(_map(torch.tensor, tree))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=REL)


def test_adamw_init():
    params = {"w": torch.ones((2, 3), dtype=torch.bfloat16),
              "b": {"c": torch.ones(4)}}
    state = topt.adamw_init(params)
    assert state.step.dtype == torch.int32 and int(state.step) == 0
    for tree in (state.mu, state.nu):
        assert tree["w"].dtype == torch.float32 and not tree["w"].any()
        assert tree["b"]["c"].shape == (4,)
    assert state.mu["w"] is not state.nu["w"]


def test_adamw_keeps_the_param_dtype():
    p = {"w": torch.ones((3,), dtype=torch.bfloat16)}
    state = topt.adamw_init(p)
    out, state, _ = topt.adamw_update(
        topt.AdamWConfig(lr=0.1), {"w": torch.full((3,), 0.5)}, state, p)
    assert out["w"].dtype == torch.bfloat16
    assert state.mu["w"].dtype == torch.float32
    assert float(out["w"][0]) < 1.0
