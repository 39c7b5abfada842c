"""Port parity for the Mamba-2 (SSD) block: `repro_torch.models.ssm`
against `repro.models.ssm` on the CPU, on the same numpy inputs and
weights.

The weights are the reference's init with every leaf it draws as zeros
(conv bias, A, D, dt bias, the gated norm's scale) given random values
instead, so that each enters the comparison. The block runs in f32 at the
Mamba-2 smoke width (d 64, 4 heads of 32, d_state 16, chunk 16) in its
three modes: chunked over 13 and 40 tokens (a padded tail), the prefill's
`return_cache` handoff, and 12 one-step decodes; then its gradients with
respect to u and every weight against jax.grad. Outputs and caches agree
within 1e-5 of the largest |value| (`close`): the packages differ only by
summation order. Gradients are held within 1e-4 of it, the training
suite's gradient bound: a_log's gradient sums every (token, channel,
state) term with cancellation, and the reference's own f32 gradient sits
8.3e-6 of its max from its f64 one there (the port's 1.5e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import ssm as JS
from repro_torch.models import ssm as TS
from repro_torch.parallel.sharding import ShardingRules, full, shard_tensor
from test_torch_models import as_np, cfgs, close, one_rank_mesh

torch.set_num_threads(1)

TOL = 1e-5
GRAD_TOL = 1e-4
B = 2


def _block(dtype="float32", seed=0):
    jc, tc = cfgs("mamba2_130m", dtype=dtype)
    defs = JS.ssm_defs(jc)
    jp = jax.tree.map(np.asarray, jax.jit(
        lambda key: JL.init_tree(key, defs))(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)
    lo, hi = jc.ssm.a_init_range
    jp["a_log"] = np.log(rng.uniform(lo, hi, jp["a_log"].shape)
                         ).astype(np.float32)
    for name in ("conv_b", "d_skip", "dt_bias", "norm"):
        jp[name] = (0.5 * rng.standard_normal(jp[name].shape)
                    ).astype(np.float32)
    tp = {k: torch.from_numpy(v.copy()) for k, v in jp.items()}
    return jc, {k: jnp.asarray(v) for k, v in jp.items()}, tc, tp


def _u(d, l, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, l, d), dtype=np.float32)


_ref_chunked = jax.jit(JS.ssm_block, static_argnums=(1, 3, 5))
_ref_decode = jax.jit(lambda p, c, u, cache: JS.ssm_block(p, c, u,
                                                           cache=cache),
                      static_argnums=1)


@pytest.mark.parametrize("length", [13, 40])
def test_chunked_matches_the_reference(length):
    """13 tokens: one chunk, 3 padded rows; 40: three chunks of 16, the
    last padded by 8."""
    jc, jp, tc, tp = _block()
    u = _u(jc.d_model, length)
    want, _ = _ref_chunked(jp, jc, jnp.asarray(u), None, None, False)
    got, cache = TS.ssm_block(tp, tc, torch.from_numpy(u))
    assert cache is None and got.dtype == torch.float32
    close(as_np(got), want, TOL)


def test_return_cache_hands_off_to_decode():
    """The prefill over 12 tokens returns the final state and the last
    d_conv - 1 pre-conv inputs; decoding token 13 from it matches the
    reference's decode from its own cache."""
    jc, jp, tc, tp = _block()
    u = _u(jc.d_model, 13, seed=2)
    want, jcache = _ref_chunked(jp, jc, jnp.asarray(u[:, :12]), None, None,
                                True)
    got, cache = TS.ssm_block(tp, tc, torch.from_numpy(u[:, :12]),
                              return_cache=True)
    close(as_np(got), want, TOL)
    assert cache.conv.shape == jcache.conv.shape
    assert cache.state.dtype == torch.float32
    close(as_np(cache.conv), jcache.conv, TOL)
    close(as_np(cache.state), jcache.state, TOL)
    want, jnext = _ref_decode(jp, jc, jnp.asarray(u[:, 12:]), jcache)
    got, nxt = TS.ssm_block(tp, tc, torch.from_numpy(u[:, 12:].copy()),
                            cache=cache)
    close(as_np(got), want, TOL)
    close(as_np(nxt.state), jnext.state, TOL)
    close(as_np(nxt.conv), jnext.conv, TOL)


def test_twelve_decodes_match_the_reference():
    """From a zeroed cache (`ssm_cache_defs`), 12 one-step decodes: every
    output and the final cache; the decoded stream also continues the
    chunked one (the reference's own SSM bound, rtol 1e-4 / atol 1e-5)."""
    jc, jp, tc, tp = _block()
    u = _u(jc.d_model, 12, seed=3)
    cache = TS.ssm_cache_defs(tc, B, device="cpu")
    assert cache.conv.dtype == torch.float32 and not cache.state.any()
    jcache = JS.SSMCache(jnp.zeros(cache.conv.shape, jnp.float32),
                         jnp.zeros(cache.state.shape, jnp.float32))
    outs = []
    for t in range(12):
        want, jcache = _ref_decode(jp, jc, jnp.asarray(u[:, t:t + 1]), jcache)
        got, cache = TS.ssm_block(tp, tc, torch.from_numpy(u[:, t:t + 1]
                                                           .copy()),
                                  cache=cache)
        close(as_np(got), want, TOL)
        outs.append(got)
    close(as_np(cache.state), jcache.state, TOL)
    close(as_np(cache.conv), jcache.conv, TOL)
    full, _ = TS.ssm_block(tp, tc, torch.from_numpy(u))
    np.testing.assert_allclose(as_np(torch.cat(outs, 1)), as_np(full),
                               rtol=1e-4, atol=1e-5)


def test_gradients_match_jax_grad():
    """d(sum(out * g)) with respect to u and every weight, over 40 tokens
    (three chunks, a padded tail): finite, and within 1e-4 of the largest
    |gradient| of the reference's."""
    jc, jp, tc, tp = _block()
    u = _u(jc.d_model, 40, seed=4)
    g = np.random.default_rng(5).standard_normal(u.shape, dtype=np.float32)

    def ref_loss(p, x):
        return jnp.sum(JS.ssm_block(p, jc, x)[0] * g)
    want_p, want_u = jax.jit(jax.grad(ref_loss, argnums=(0, 1)))(
        jp, jnp.asarray(u))
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    ut = torch.from_numpy(u).requires_grad_()
    out, _ = TS.ssm_block(leaves, tc, ut)
    grads = torch.autograd.grad(torch.sum(out * torch.from_numpy(g)),
                                [ut, *leaves.values()])
    for name, got, want in zip(["u", *leaves], grads,
                               [want_u, *(want_p[k] for k in leaves)]):
        assert torch.isfinite(got).all(), name
        close(as_np(got), want, GRAD_TOL)


def test_bf16_within_the_reference_bf16_distance():
    """cfg.dtype bf16: the projections and the gated norm in bf16, the SSD
    in f32. The port's output is no farther from the f32 reference than
    twice the reference's own bf16 output is."""
    jc32, jp, tc32, tp = _block()
    jc, tc = jc32.scaled(dtype="bfloat16"), tc32.scaled(dtype="bfloat16")
    u = np.asarray(jnp.asarray(_u(jc.d_model, 40, seed=6), jnp.bfloat16)
                   .astype(jnp.float32))
    f32 = np.asarray(_ref_chunked(jp, jc32, jnp.asarray(u), None, None,
                                  False)[0])
    ref = _ref_chunked(jp, jc, jnp.asarray(u, jnp.bfloat16), None, None,
                       False)[0]
    got, _ = TS.ssm_block(tp, tc, torch.from_numpy(u.copy()).to(
        torch.bfloat16))
    assert got.dtype == torch.bfloat16
    ref_err = np.abs(np.asarray(ref, np.float32) - f32).max()
    assert np.abs(as_np(got) - f32).max() <= 2 * ref_err


def test_defs_dims_and_rules(tmp_path):
    """The defs match the reference's; under sharding rules on a one-rank
    mesh the block takes its DTensor path (`_ssm_block_local`: weights
    gathered with partial-sum gradients, the cache's rows) and gives the
    plain block's prefill, cache, decode step and gradients."""
    jc, _, tc, tp = _block()
    assert TS.ssm_dims(tc) == JS.ssm_dims(jc)
    defs = TS.ssm_defs(tc)
    flat = {k: (d.shape, d.spec, d.scale, d.dtype, d.fan_in)
            for k, d in defs.items()}
    assert flat == {k: (d.shape, d.spec, d.scale, d.dtype, d.fan_in)
                    for k, d in JS.ssm_defs(jc).items()}
    rng = np.random.default_rng(3)
    u = torch.from_numpy(rng.standard_normal((B, 20, tc.d_model),
                                             dtype=np.float32))
    u1 = torch.from_numpy(rng.standard_normal((B, 1, tc.d_model),
                                              dtype=np.float32))
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    want, want_cache = TS.ssm_block(leaves, tc, u, return_cache=True)
    want_grads = torch.autograd.grad(want.square().sum(),
                                     list(leaves.values()))
    want_step, _ = TS.ssm_block(tp, tc, u1, cache=want_cache)
    with one_rank_mesh(tmp_path) as mesh:
        rules = ShardingRules(mesh=mesh)
        sp = {k: shard_tensor(tp[k], rules.sharding_for_shape(
            defs[k].shape, *defs[k].spec)).requires_grad_() for k in tp}
        rows = rules.sharding_for_shape(u.shape, "dp", None, None)
        got, cache = TS.ssm_block(sp, tc, shard_tensor(u, rows), rules,
                                  return_cache=True)
        grads = torch.autograd.grad(got.square().sum(), list(sp.values()))
        step, _ = TS.ssm_block(sp, tc, shard_tensor(u1, rows), rules,
                               cache=cache)
        got, step = full(got), full(step)
        cache = [full(t) for t in cache]
        grads = [full(g) for g in grads]
    close(as_np(got), as_np(want), TOL)
    close(as_np(step), as_np(want_step), TOL)
    for g, w in zip(cache, want_cache):
        close(as_np(g), as_np(w), TOL)
    for g, w in zip(grads, want_grads):
        close(as_np(g), as_np(w), TOL)
