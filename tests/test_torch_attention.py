"""Port parity for the flash-attention kernel module:
`repro_torch.kernels.attention` against `repro.kernels.attention`.

On the CPU the port's wrapper runs the kernel's plain torch version (the
reference kernel's blocked online-softmax recurrence); the reference runs
its Pallas kernel in interpret mode, as its own tests do. Both get the same
numpy inputs. The sweeps are the reference test's (GQA/MHA/MQA x causal,
block shapes, bf16, causality), plus what only the port takes: ragged
lengths, KV heads folded without the repeat, and its argument checks.

Tolerances are the reference test's: rtol = atol = 2e-5 in f32 (both
packages sum in f32, in different orders), and a max abs difference of
0.02 in bf16 (both round the same f32 result to bf16 once; an ulp of bf16
in [2, 4) is 0.0156).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import attention_ref as j_ref
from repro.kernels.attention import flash_attention as j_flash
from repro_torch.kernels.attention import attention_ref as t_ref
from repro_torch.kernels.attention import flash_attention as t_flash
from repro_torch.kernels.attention import kernel as tk

torch.set_num_threads(1)

F32 = dict(rtol=2e-5, atol=2e-5)
BF16_MAX_ABS = 0.02


def _qkv(b, s, h, kh, d, seed=0, sk=None):
    rng = np.random.default_rng(seed)
    sk = s if sk is None else sk
    return (rng.standard_normal((b, s, h, d), dtype=np.float32),
            rng.standard_normal((b, sk, kh, d), dtype=np.float32),
            rng.standard_normal((b, sk, kh, d), dtype=np.float32))


def _jax(arrays, dtype=jnp.float32):
    return [jnp.asarray(a).astype(dtype) for a in arrays]


def _torch(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("b,s,h,kh,d", [
    (2, 128, 4, 2, 32),     # GQA
    (1, 256, 8, 8, 64),     # MHA
    (2, 128, 4, 1, 32),     # MQA
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_reference_f32(b, s, h, kh, d, causal):
    arrays = _qkv(b, s, h, kh, d)
    got = t_flash(*_torch(arrays), causal, bq=64, bk=64).numpy()
    want_kernel = np.asarray(j_flash(*_jax(arrays), causal, bq=64, bk=64))
    want_ref = np.asarray(j_ref(*_jax(arrays), causal))
    np.testing.assert_allclose(got, want_kernel, **F32)
    np.testing.assert_allclose(got, want_ref, **F32)
    np.testing.assert_allclose(t_ref(*_torch(arrays), causal).numpy(),
                               want_ref, **F32)


def test_flash_bf16_tolerance():
    arrays = _qkv(2, 128, 4, 2, 32)
    got = t_flash(*_torch(arrays, torch.bfloat16), True, bq=64, bk=64)
    assert got.dtype == torch.bfloat16
    want = j_ref(*_jax(arrays, jnp.bfloat16), True).astype(jnp.float32)
    assert float(np.abs(got.float().numpy() - np.asarray(want)).max()) \
        < BF16_MAX_ABS


@pytest.mark.parametrize("bq,bk", [(32, 32), (64, 128), (128, 64)])
def test_block_shape_sweep(bq, bk):
    arrays = _qkv(1, 128, 2, 2, 32)
    got = t_flash(*_torch(arrays), True, bq=bq, bk=bk).numpy()
    want = np.asarray(j_flash(*_jax(arrays), True, bq=bq, bk=bk))
    np.testing.assert_allclose(got, want, **F32)


def test_causality_property():
    """Perturbing future keys must not change earlier outputs."""
    q, k, v = _torch(_qkv(1, 128, 2, 2, 32))
    out1 = t_flash(q, k, v, True, bq=64, bk=64)
    k2, v2 = k.clone(), v.clone()
    k2[:, 100:] = 0.0
    v2[:, 100:] = 0.0
    out2 = t_flash(q, k2, v2, True, bq=64, bk=64)
    torch.testing.assert_close(out1[:, :100], out2[:, :100], rtol=0,
                               atol=1e-6)
    assert float((out1[:, 100:] - out2[:, 100:]).abs().max()) > 1e-4


@pytest.mark.parametrize("s,sk,causal", [(100, 100, True), (77, 130, False),
                                         (90, 50, True)])
def test_ragged_lengths_match_the_oracle(s, sk, causal):
    """The reference kernel asserts S % block == 0; the port's does not."""
    arrays = _qkv(1, s, 4, 2, 16, seed=3, sk=sk)
    got = t_flash(*_torch(arrays), causal, bq=32, bk=32).numpy()
    np.testing.assert_allclose(got, np.asarray(j_ref(*_jax(arrays), causal)),
                               **F32)


def test_folded_kv_heads_index_like_the_repeat():
    """Row bh of q reads KV row bh // group: the layout jnp.repeat gives."""
    q, k, v = _torch(_qkv(1, 48, 6, 2, 16, seed=5))
    fold = lambda t: t.transpose(1, 2).reshape(-1, t.shape[1], t.shape[3])
    rep = lambda t: fold(t.repeat_interleave(3, dim=2))
    got = tk.flash_attention_bhsd(fold(q), fold(k), fold(v), 16, 16)
    want = tk.flash_attention_bhsd(fold(q), rep(k), rep(v), 16, 16)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_cpu_tensors_never_launch_the_kernel():
    before = tk.launches
    t_flash(*_torch(_qkv(1, 32, 2, 1, 8)), True)
    assert tk.launches == before


@pytest.mark.parametrize("shapes,dtypes,match", [
    (((4, 8, 8), (3, 8, 8), (3, 8, 8)), (torch.float32,) * 3, "multiple"),
    (((4, 8, 8), (2, 8, 4), (2, 8, 4)), (torch.float32,) * 3, "head dims"),
    (((4, 8, 8), (2, 8, 8), (2, 8, 8)), (torch.float16,) * 3, "dtype"),
    (((4, 8, 8), (2, 8, 8), (2, 8, 8)),
     (torch.float32, torch.bfloat16, torch.float32), "dtype"),
    (((4, 8), (2, 8, 8), (2, 8, 8)), (torch.float32,) * 3, "BH"),
])
def test_wrapper_rejects_bad_operands(shapes, dtypes, match):
    q, k, v = (torch.zeros(s, dtype=t) for s, t in zip(shapes, dtypes))
    with pytest.raises(ValueError, match=match):
        tk.flash_attention_bhsd(q, k, v)


def test_gqa_wrapper_rejects_uneven_groups():
    q, k, v = _torch(_qkv(1, 8, 6, 4, 8))
    with pytest.raises(ValueError, match="not a multiple"):
        t_flash(q, k, v)
