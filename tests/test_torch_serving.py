"""Port parity for the LM serving slice as a whole: `repro_torch`'s
prefill, decode_step and greedy_generate against `repro`'s, on the CPU,
for the qwen2_1_5b and yi_6b smoke configs.

The reference's weights are carried across with `params_from_reference`;
prompts come from numpy. The reference's prefill and decode_step run under
jax.jit (compiled once; the engine looks them up on the module at each
call). On the CPU every prefill attention step runs the reference's own
code, so in f32 the packages differ only by summation order.

Tolerances. f32: logits and caches within 2e-5 of the largest |value|
(the smoke models' stacked weights have std 1/sqrt(2), so activations are
large; measured up to ~2e-6). Greedy ids are compared exactly. bf16: the
two frameworks round at other places (XLA may keep an elementwise chain
in f32 where torch rounds each op), so logits are held within 0.1 and
caches within 0.05 of the largest |value|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro.serving import engine as jengine
from repro_torch.models import transformer as TT
from repro_torch.serving import engine as tengine
from test_torch_models import as_np, cfgs, close, ref_params

torch.set_num_threads(1)

ARCHS = ["qwen2_1_5b", "yi_6b"]
MODEL_TOL = 2e-5
BF16_LOGITS = 0.1
BF16_CACHE = 0.05

ref_prefill = jax.jit(JT.prefill, static_argnums=1)
ref_decode_step = jax.jit(JT.decode_step, static_argnums=1)


def _params(jc, tc, seed=0):
    jp = ref_params(jc, seed)
    tp = TT.params_from_reference(jax.tree.map(np.asarray, jp), tc,
                                  device="cpu")
    return jp, tp


def _tokens(cfg, b=2, s=12, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference(arch):
    jc, tc = cfgs(arch)
    jp, tp = _params(jc, tc)
    toks = _tokens(jc)
    jl, jcache = ref_prefill(jp, jc, {"tokens": jnp.asarray(toks)})
    tl, tcache = TT.prefill(tp, tc, {"tokens": torch.from_numpy(toks)})
    close(as_np(tl), jl, MODEL_TOL)
    for side in ("attn_k", "attn_v"):
        want = getattr(jcache, side)["sub_0"]
        got = getattr(tcache, side)["sub_0"]
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        close(as_np(got), want, MODEL_TOL)

    # one decode step at position 12 against a 16-deep cache
    s_max = 16
    jfull = jax.tree.map(lambda big, small: big.at[:, :, :12].set(small),
                         JT.init_cache(jc, 2, s_max), jcache)
    tfull = TT.init_cache(tc, 2, s_max, device="cpu")
    for side in ("attn_k", "attn_v"):
        getattr(tfull, side)["sub_0"][:, :, :12] = \
            getattr(tcache, side)["sub_0"]
    nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    jl2, jc2 = ref_decode_step(jp, jc, jfull, jnp.asarray(nxt),
                               jnp.int32(12))
    tl2, tc2 = TT.decode_step(tp, tc, tfull, torch.from_numpy(nxt), 12)
    close(as_np(tl2), jl2, MODEL_TOL)
    close(as_np(tc2.attn_k["sub_0"]), jc2.attn_k["sub_0"], MODEL_TOL)
    close(as_np(tc2.attn_v["sub_0"]), jc2.attn_v["sub_0"], MODEL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_the_reference(arch, monkeypatch):
    monkeypatch.setattr(JT, "prefill", ref_prefill)
    monkeypatch.setattr(JT, "decode_step", ref_decode_step)
    jc, tc = cfgs(arch)
    jp, tp = _params(jc, tc, seed=1)
    toks = _tokens(jc, seed=1)
    want = np.asarray(jengine.greedy_generate(
        jc, jp, {"tokens": jnp.asarray(toks)}, steps=6, s_max=20))
    got = tengine.greedy_generate(tc, tp, {"tokens": torch.from_numpy(toks)},
                                  steps=6, s_max=20)
    assert got.shape == (2, 7)
    np.testing.assert_array_equal(got.numpy(), want)


def test_prefill_bf16_within_the_looser_bound():
    jc, tc = cfgs("qwen2_1_5b", dtype="bfloat16")
    jp, tp = _params(jc, tc)
    toks = _tokens(jc)
    jl, jcache = ref_prefill(jp, jc, {"tokens": jnp.asarray(toks)})
    tl, tcache = TT.prefill(tp, tc, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.bfloat16
    assert tcache.attn_k["sub_0"].dtype == torch.bfloat16
    close(as_np(tl), np.asarray(jl, dtype=np.float32), BF16_LOGITS)
    close(as_np(tcache.attn_v["sub_0"]),
          np.asarray(jcache.attn_v["sub_0"], dtype=np.float32), BF16_CACHE)


def test_make_prefill_and_decode_step_wrap_the_model():
    _, tc = cfgs("yi_6b")
    tp = TT.init_params(tc, seed=0, device="cpu")
    toks = torch.from_numpy(_tokens(tc))
    logits, _ = tengine.make_prefill(tc)(tp, {"tokens": toks})
    want, _ = TT.prefill(tp, tc, {"tokens": toks})
    torch.testing.assert_close(logits, want, rtol=0, atol=0)
    full = TT.init_cache(tc, 2, 14, device="cpu")
    out, cache = tengine.make_decode_step(tc)(tp, full, toks[:, :1], 0)
    assert out.shape == (2, tc.vocab_size) and cache is full
    assert cache.attn_k["sub_0"][:, :, 0].any()
    assert not cache.attn_k["sub_0"][:, :, 1:].any()
