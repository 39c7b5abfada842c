"""Port parity for the LM serving slice as a whole: `repro_torch`'s
prefill, decode_step and greedy_generate against `repro`'s, on the CPU,
for all ten smoke configs: dense (qwen2_1_5b, deepseek_coder_33b, yi_6b,
internlm2_20b), MoE (qwen2_moe_a2_7b, mixtral_8x7b with its window), SSM
(mamba2_130m), hybrid (jamba_1_5_large), vision (internvl2_26b, with
patch embeddings before the text) and audio (musicgen_large, (B, K, S)
codes).

The reference's weights are carried across with `params_from_reference`;
prompts come from numpy. The reference's prefill and decode_step run under
jax.jit (compiled once; the engine looks them up on the module at each
call). On the CPU every prefill attention step runs the reference's own
code, so in f32 the packages differ only by summation order. The caches
compared are every attention sub-layer's k and v and every SSM
sub-layer's conv tail and state.

Tolerances. f32: logits and caches within 2e-5 of the largest |value|
(the smoke models' stacked weights have std 1/sqrt(2), so activations are
large; measured up to ~2e-6). Greedy ids are compared exactly. bf16: the
two frameworks round at other places (XLA may keep an elementwise chain
in f32 where torch rounds each op), so logits are held within 0.1 and
caches within 0.05 of the largest |value|.

greedy_generate is compared on a text-only prompt for the vision config:
with images the reference decodes over image positions (ROADMAP.md Queue
3), and test_torch_frontends.py holds that case against a full prefill.
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

ARCHS = ["qwen2_1_5b", "deepseek_coder_33b", "yi_6b", "internlm2_20b",
         "qwen2_moe_a2_7b", "mixtral_8x7b", "mamba2_130m", "jamba_1_5_large",
         "internvl2_26b", "musicgen_large"]
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


def _prompt(cfg, s=12, seed=0, images=True):
    """{tokens: (2, s) ids, or (2, K, s) codes for audio} with a vision
    config's patch_embeds (2, n_img, d_frontend) unless `images` is False;
    and the prompt's positions (s, plus n_img)."""
    fe = cfg.frontend
    if fe is not None and fe.modality == "audio":
        toks = np.stack([_tokens(cfg, s=s, seed=seed + i)
                         for i in range(fe.num_positions)], axis=1)
        return {"tokens": toks}, s
    prompt = {"tokens": _tokens(cfg, s=s, seed=seed)}
    if fe is not None and fe.modality == "vision" and images:
        prompt["patch_embeds"] = np.random.default_rng(seed).standard_normal(
            (2, fe.num_positions, fe.d_frontend), dtype=np.float32)
        return prompt, s + fe.num_positions
    return prompt, s


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _cache_leaves(cache):
    """{(field, sub-layer, part): leaf} of either package's DecodeCache."""
    out = {}
    for field in ("attn_k", "attn_v"):
        for key, leaf in getattr(cache, field).items():
            out[field, key, ""] = leaf
    for key, c in cache.ssm.items():
        out["ssm", key, "conv"] = c.conv
        out["ssm", key, "state"] = c.state
    return out


def _close_caches(got, want, tol):
    """Every leaf of the port's cache against the reference's: the same
    keys and shapes, f32, within `tol` of the largest |value|."""
    got, want = _cache_leaves(got), _cache_leaves(want)
    assert set(got) == set(want) and got
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape, path
        assert got[path].dtype == torch.float32, path
        close(as_np(got[path]), w, tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference(arch):
    jc, tc = cfgs(arch)
    jp, tp = _params(jc, tc)
    prompt, n = _prompt(jc)
    jl, jcache = ref_prefill(jp, jc, _jax(prompt))
    tl, tcache = TT.prefill(tp, tc, _torch(prompt))
    close(as_np(tl), jl, MODEL_TOL)
    _close_caches(tcache, jcache, MODEL_TOL)

    # one decode step at position n (12, or 20 after a vision prompt's 8
    # image positions) against an (n + 4)-deep KV cache; the SSM caches
    # carry over as they are, as the engine carries them
    s_max = n + 4
    jfull = JT.init_cache(jc, 2, s_max)
    jfull = jfull._replace(ssm=jcache.ssm, **{
        f: jax.tree.map(lambda big, small: big.at[:, :, :n].set(small),
                        getattr(jfull, f), getattr(jcache, f))
        for f in ("attn_k", "attn_v")})
    tfull = TT.extend_cache(tc, tcache, s_max)
    nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)[..., None]
    jl2, jc2 = ref_decode_step(jp, jc, jfull, jnp.asarray(nxt),
                               jnp.int32(n))
    tl2, tc2 = TT.decode_step(tp, tc, tfull, torch.from_numpy(nxt), n)
    close(as_np(tl2), jl2, MODEL_TOL)
    assert tc2 is tfull
    _close_caches(tc2, jc2, MODEL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_the_reference(arch, monkeypatch):
    monkeypatch.setattr(JT, "prefill", ref_prefill)
    monkeypatch.setattr(JT, "decode_step", ref_decode_step)
    jc, tc = cfgs(arch)
    jp, tp = _params(jc, tc, seed=1)
    prompt, _ = _prompt(jc, seed=1, images=False)
    want = np.asarray(jengine.greedy_generate(
        jc, jp, _jax(prompt), steps=6, s_max=20))
    got = tengine.greedy_generate(tc, tp, _torch(prompt), steps=6, s_max=20)
    assert got.shape == prompt["tokens"].shape[:-1] + (7,)
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


@pytest.mark.parametrize("arch", ["qwen2_moe_a2_7b", "mamba2_130m",
                                  "jamba_1_5_large"])
def test_prefill_bf16_within_twice_the_reference_bf16_distance(arch):
    """bf16 logits, KV caches and SSM conv tails (the SSD state stays f32):
    each no farther from the reference's f32 prefill than twice the
    reference's own bf16 prefill is. A fixed bound does not fit these
    stacks: Jamba's smoke model is 8 sub-layers of one repeat, whose
    stacked weights draw at std 1, so its bf16 caches reach |25| and
    round at 1/8."""
    jc, tc = cfgs(arch, dtype="bfloat16")
    jp, tp = _params(jc, tc)
    toks = {"tokens": _tokens(jc)}
    f32_logits, f32_cache = ref_prefill(jp, jc.scaled(dtype="float32"),
                                        toks)
    ref_logits, ref_cache = ref_prefill(jp, jc, toks)
    tl, tcache = TT.prefill(tp, tc, {"tokens": torch.from_numpy(
        toks["tokens"])})
    assert tl.dtype == torch.bfloat16
    got = {"logits": tl, **_cache_leaves(tcache)}
    ref = {"logits": ref_logits, **_cache_leaves(ref_cache)}
    f32 = {"logits": f32_logits, **_cache_leaves(f32_cache)}
    for path, want in f32.items():
        want = np.asarray(want, dtype=np.float32)
        assert got[path].dtype == (torch.float32 if path[-1] == "state"
                                   else torch.bfloat16), path
        ref_err = np.abs(np.asarray(ref[path], np.float32) - want).max()
        got_err = np.abs(as_np(got[path]) - want).max()
        assert got_err <= 2 * ref_err, (path, got_err, ref_err)


@pytest.mark.parametrize("arch", ["qwen2_1_5b", "mamba2_130m",
                                  "jamba_1_5_large"])
def test_extend_cache_grows_kv_and_carries_ssm_state(arch):
    _, tc = cfgs(arch)
    tp = TT.init_params(tc, seed=0, device="cpu")
    _, small = TT.prefill(tp, tc, {"tokens": torch.from_numpy(_tokens(tc))})
    big = TT.extend_cache(tc, small, 20)
    want = TT.init_cache(tc, 2, 20, device="cpu")
    for field in ("attn_k", "attn_v"):
        got_tree, small_tree = getattr(big, field), getattr(small, field)
        assert got_tree.keys() == getattr(want, field).keys()
        for key, leaf in got_tree.items():
            assert leaf.shape == getattr(want, field)[key].shape
            assert leaf.dtype == small_tree[key].dtype
            assert torch.equal(leaf[:, :, :12], small_tree[key])
            assert not leaf[:, :, 12:].any()
    assert big.ssm.keys() == want.ssm.keys()
    for key, c in big.ssm.items():
        assert c.conv is small.ssm[key].conv
        assert c.state is small.ssm[key].state


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
