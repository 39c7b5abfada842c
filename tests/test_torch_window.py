"""Port parity for sliding-window attention (Mixtral): the windowed
flash-attention kernel's plain version, the prefill step that calls it,
Mixtral's smoke model, and windowed decode, against `repro` on the CPU.

The kernel's plain version (`flash_attention_bhsd_torch(window=)`, what
the wrapper runs on CPU tensors) is held against the reference model's
plain attention step (`_sdpa` under `_mask_bias(..., window)`) on the same
numpy inputs. Both compute in f32 and differ by summation order only:
within 1e-5 of the largest |value| (`LAYER_TOL`).

Decode is held against the reference's full prefill of the same tokens,
not against its `greedy_generate`: the reference keeps the prefill's s0
slots as the ring when the window is shorter than s_max, so with s0 <
window its decode overwrites positions the window still covers
(ROADMAP.md Queue 3).
`test_reference_decode_forgets_tokens_inside_its_window` records that
gap. The smoke models' stacked weights draw at std 1/sqrt(2), where a MoE
stack turns f32 summation order into up to 2e-5 of the max at 40 tokens;
the decode and prefill cases here rescale the block weights to
1/sqrt(fan_in), as tests/test_torch_training.py does, and hold f32
logits within 2e-5 of the largest |value| (`MODEL_TOL`; the port's
decode measured within 1.2e-6 of the reference's prefill).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serving import engine as jengine
from repro_torch.kernels.attention import (attention_ref, flash_attention,
                                           flash_attention_trainable)
from repro_torch.kernels.attention import kernel as fak
from repro_torch.kernels.attention.ref import (attention_f64,
                                               within_plain_rounding)
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.serving import engine as tengine
from test_torch_models import LAYER_TOL, as_np, cfgs, close, ref_params

torch.set_num_threads(1)

ARCH = "mixtral_8x7b"          # smoke config: window 32
MODEL_TOL = 2e-5

ref_sdpa = jax.jit(JL._sdpa, static_argnums=4)
ref_prefill = jax.jit(JT.prefill, static_argnums=1)
ref_decode_step = jax.jit(JT.decode_step, static_argnums=1)


def _qkv(b, s, h, kh, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape, dtype=np.float32)
                 for shape in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d)))


def _ref_windowed(q, k, v, window):
    """The reference model's plain attention step, (B, S, H, D) layout."""
    s = q.shape[1]
    pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (q.shape[0], s))
    bias = JL._mask_bias(pos, pos, window)
    return np.asarray(ref_sdpa(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), bias,
                               q.shape[2] // k.shape[2]))


def _fold(t):
    """(B, S, H, D) numpy -> folded (B*H, S, D) torch."""
    b, s, h, d = t.shape
    return torch.from_numpy(np.ascontiguousarray(
        t.transpose(0, 2, 1, 3).reshape(b * h, s, d)))


def _unfold(t, b):
    bh, s, d = t.shape
    return as_np(t).reshape(b, bh // b, s, d).transpose(0, 2, 1, 3)


# -- the kernel's plain version and the oracles --------------------------------

# Windows shorter than, equal to and longer than S = 150 (ragged for 128-
# row blocks); group 4 and MHA; a window of 1 (the diagonal alone).
@pytest.mark.parametrize("window", [1, 17, 64, 150, 400])
@pytest.mark.parametrize("heads", [(8, 2), (4, 4)])
def test_windowed_plain_version_matches_the_reference_step(window, heads):
    h, kh = heads
    q, k, v = _qkv(2, 150, h, kh, 16, seed=window)
    want = _ref_windowed(q, k, v, window)
    got = fak.flash_attention_bhsd_torch(_fold(q), _fold(k), _fold(v),
                                         bq=64, bk=32, window=window)
    close(_unfold(got, 2), want, LAYER_TOL)


@pytest.mark.parametrize("window", [5, 40, 90])
def test_windowed_oracles_match_the_reference_step(window):
    """attention_ref (B, S, H, D) and attention_f64 (folded) take the
    same window."""
    q, k, v = _qkv(2, 90, 8, 2, 16, seed=window)
    want = _ref_windowed(q, k, v, window)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    close(as_np(attention_ref(tq, tk, tv, window=window)), want, LAYER_TOL)
    exact = attention_f64(_fold(q), _fold(k), _fold(v), window=window)
    close(_unfold(exact.float(), 2), want, LAYER_TOL)


def test_window_wider_than_s_is_the_causal_function():
    q, k, v = (_fold(x) for x in _qkv(1, 70, 4, 2, 16, seed=3))
    torch.testing.assert_close(
        fak.flash_attention_bhsd_torch(q, k, v, bk=16, window=70),
        fak.flash_attention_bhsd_torch(q, k, v, bk=16), rtol=0, atol=0)


def test_window_argument_is_checked():
    q, k, v = (_fold(x) for x in _qkv(1, 8, 2, 2, 8))
    for bad in ({"window": 0}, {"window": 4, "causal": False}):
        with pytest.raises(ValueError, match="sliding window"):
            fak.flash_attention_bhsd(q, k, v, **bad)
    with pytest.raises(ValueError, match="sliding window"):
        fak.flash_attention_bhsd(q, k[:, :6], v[:, :6], window=4)


@functools.lru_cache(maxsize=None)
def _bf16_window_case(s=2048, window=1024):
    """bf16 operands at group 4 with the plain version and the f64
    function on them."""
    q, k, v = (_fold(x).to(torch.bfloat16)
               for x in _qkv(1, s, 4, 1, 128, seed=11))
    return (q, k, v, fak.flash_attention_bhsd_torch(q, k, v, window=window),
            attention_f64(q, k, v, window=window))


# (bk, window shift, within): the kernel's own 64-key tiles sum in another
# order and pass; one key too many or too few at the lower edge fails.
@pytest.mark.parametrize("bk,shift,within", [(64, 0, True), (128, 1, False),
                                             (128, -1, False)])
def test_bf16_window_bound_sees_an_edge_key(bk, shift, within):
    """`within_plain_rounding`, the card's bound on the bf16 windowed
    kernel, against stand-ins for the kernel computed by the plain version
    at another key tile, or with the window one key wider or narrower."""
    q, k, v, plain, exact = _bf16_window_case()
    got = fak.flash_attention_bhsd_torch(q, k, v, bq=64, bk=bk,
                                         window=1024 + shift)
    assert within_plain_rounding(got, plain, exact) is within


def test_trainable_window_takes_the_oracles_gradient():
    """flash_attention_trainable(window=): the forward is the kernel's
    (here its plain version), the backward the windowed oracle's gradient,
    bit-equal."""
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _qkv(2, 40, 8, 2, 16, seed=7))
    d_out = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 40, 8, 16), dtype=np.float32))
    got = flash_attention_trainable(q, k, v, window=13)
    want = attention_ref(q, k, v, window=13)
    close(as_np(got), as_np(want), LAYER_TOL)
    for g, w in zip(torch.autograd.grad(got, (q, k, v), d_out),
                    torch.autograd.grad(want, (q, k, v), d_out)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# -- the model's prefill step ---------------------------------------------------

@pytest.mark.parametrize("s", [20, 32, 45])
def test_prefill_step_kernel_path_matches_the_plain_step(s):
    """The card's step, `flash_attention(..., window=kernel_window(cfg, S))`,
    run here through the kernel's plain version, against the port's plain
    step: causal alone up to the window (32), the window beyond it."""
    _, tc = cfgs(ARCH)
    assert TL.kernel_window(tc, s) == (32 if s > 32 else None)
    q, k, v = (torch.from_numpy(x) for x in _qkv(
        2, s, tc.num_heads, tc.num_kv_heads, tc.resolved_head_dim, seed=s))
    pos = torch.arange(s, dtype=torch.int32).expand(2, s)
    want = TL.prefill_attention_plain(tc, q, k, v, pos)
    got = flash_attention(q, k, v, causal=True, bq=16, bk=16,
                          window=TL.kernel_window(tc, s))
    close(as_np(got), as_np(want), LAYER_TOL)


# -- Mixtral's smoke model ------------------------------------------------------

def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], prefix + (k,)))
        return out
    return {prefix: tree}


@functools.lru_cache(maxsize=None)
def fan_in_params(arch, seed=0):
    """The reference's init_params for `arch`'s f32 smoke config as numpy,
    each stacked block weight rescaled to 1 / sqrt(fan_in) (see the
    module's docstring)."""
    jc, _ = cfgs(arch)
    tree = jax.tree.map(np.asarray, ref_params(jc, seed))
    for i, sub in enumerate(jc.pattern):
        block = tree["blocks"][f"sub_{i}"]
        for path, d in _flat(JT._sublayer_defs(jc, sub)).items():
            *keys, name = path
            leaf = functools.reduce(dict.__getitem__, keys, block)
            leaf[name] = (leaf[name] * np.sqrt(jc.repeats
                                               / (d.fan_in or d.shape[0]))
                          ).astype(np.float32)
    return tree


def _params(arch, seed=0):
    jc, tc = cfgs(arch)
    tree = fan_in_params(arch, seed)
    return (jc, jax.tree.map(jnp.asarray, tree), tc,
            TT.params_from_reference(tree, tc, device="cpu"))


def _tokens(vocab, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("s", [24, 45])
def test_mixtral_prefill_matches_the_reference(s):
    """Shorter and longer than the window: logits and every KV cache."""
    jc, jp, tc, tp = _params(ARCH)
    toks = _tokens(jc.vocab_size, 2, s, seed=s)
    jl, jcache = ref_prefill(jp, jc, {"tokens": jnp.asarray(toks)})
    tl, tcache = TT.prefill(tp, tc, {"tokens": torch.from_numpy(toks)})
    close(as_np(tl), jl, MODEL_TOL)
    for field in ("attn_k", "attn_v"):
        close(as_np(getattr(tcache, field)["sub_0"]),
              getattr(jcache, field)["sub_0"], MODEL_TOL)


def _recorded_decode(module, monkeypatch, step=None):
    """Every decode step's logits while greedy_generate runs; `step` is
    the decode function to wrap (default the module's own)."""
    inner, logits = step or module.decode_step, []

    def decode_step(*args, **kw):
        out, cache = inner(*args, **kw)
        logits.append(np.asarray(out.detach() if isinstance(
            out, torch.Tensor) else out, dtype=np.float32))
        return out, cache

    monkeypatch.setattr(module, "decode_step", decode_step)
    return logits


def _prefill_logits(prefill, params, cfg, toks, ids, t):
    """Last-position logits of the reference's full prefill over the prompt
    and the first t + 1 generated ids (what decode step t saw)."""
    longer = np.concatenate([toks, ids[:, :t + 1]], axis=1).astype(np.int32)
    out, _ = prefill(params, cfg, {"tokens": jnp.asarray(longer)})
    return np.asarray(out)


# (s0, steps, s_max): s0 < window < s0 + steps (a ring of 32 slots that
# wraps at step 4), s0 > window (the prefill's last 32 positions kept),
# and s_max < window (no ring: the cache grows to s_max).
@pytest.mark.parametrize("s0,steps,s_max", [(28, 8, 36), (41, 6, 47),
                                             (10, 6, 16)])
def test_greedy_generate_decode_matches_a_full_prefill(s0, steps, s_max,
                                                       monkeypatch):
    jc, jp, tc, tp = _params(ARCH)
    toks = _tokens(tc.vocab_size, 2, s0, seed=s0)
    logits = _recorded_decode(TT, monkeypatch)
    ids = tengine.greedy_generate(tc, tp, {"tokens": torch.from_numpy(toks)},
                                  steps=steps, s_max=s_max).numpy()
    assert ids.shape == (2, steps + 1) and len(logits) == steps
    for t, got in enumerate(logits):
        want = _prefill_logits(ref_prefill, jp, jc, toks, ids, t)
        close(got, want, MODEL_TOL)
        np.testing.assert_array_equal(got.argmax(-1), ids[:, t + 1])


def test_extend_cache_rings_the_last_window_positions():
    """s0 = 41 > window 32: positions 9..40 at slot p mod 32."""
    _, tc = cfgs(ARCH)
    tp = TT.init_params(tc, seed=0, device="cpu")
    _, small = TT.prefill(tp, tc, {"tokens": torch.from_numpy(
        _tokens(tc.vocab_size, 2, 41))})
    big = TT.extend_cache(tc, small, 60)
    for field in ("attn_k", "attn_v"):
        got, prompt = getattr(big, field)["sub_0"], getattr(small,
                                                            field)["sub_0"]
        assert got.shape[2] == TT.cache_alloc_len(tc, 60) == 32
        for p in range(9, 41):
            assert torch.equal(got[:, :, p % 32], prompt[:, :, p])


def test_reference_decode_forgets_tokens_inside_its_window(monkeypatch):
    """The reference's own greedy_generate at s0 = 28 < window 32 < s_max =
    36: its decode keeps the prefill's 28 slots as the ring and from step
    0 on writes over position 0 while the window still covers it. Its decode
    logits then sit far from a full prefill of the same tokens (measured
    0.21-0.60 of the max over the 8 steps); the port's, in the test above,
    within 1.2e-6 of the reference's prefill. If the reference is ever
    fixed, this fails: then let the port's test hold it as an oracle."""
    monkeypatch.setattr(JT, "prefill", ref_prefill)
    jc, jp, tc, _ = _params(ARCH)
    toks = _tokens(jc.vocab_size, 2, 28, seed=28)
    logits = _recorded_decode(JT, monkeypatch, ref_decode_step)
    ids = np.asarray(jengine.greedy_generate(
        jc, jp, {"tokens": jnp.asarray(toks)}, steps=8, s_max=36))
    gaps = []
    for t, got in enumerate(logits):
        want = _prefill_logits(ref_prefill, jp, jc, toks, ids, t)
        gaps.append(float(np.abs(got - want).max())
                    / max(1.0, float(np.abs(want).max())))
    assert gaps[0] > 0.05, gaps
