"""Port parity for the flash-attention kernel module:
`repro_torch.kernels.attention` against `repro.kernels.attention`.

On the CPU the port's wrapper runs the kernel's plain torch version (the
reference kernel's blocked online-softmax recurrence); the reference runs
its Pallas kernel in interpret mode, as its own tests do. Both get the same
numpy inputs. The sweeps are the reference test's (GQA/MHA/MQA x causal,
block shapes, bf16, causality), plus what only the port takes: ragged
lengths, KV heads folded without the repeat, and its argument checks.

The card's f32 kernel multiplies on the tensor cores in 3xTF32: each
operand x is split into hi = tf32(x) (rounded to nearest, ties away, as
cvt.rna.tf32.f32 rounds) and lo = x - hi, which the tensor cores read
truncated to TF32, and each product is hi hi + hi lo + lo hi. That
numerical design is emulated here in torch, inside the reference's
blocked recurrence, and held to the same f32 bound, also on a stressed
case (q and k scaled by 3: a peaked softmax that amplifies score errors),
where a single TF32 product is shown to miss it.

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
from repro_torch.kernels.attention.ref import attention_f64
from repro_torch.obs.metrics import default_registry

torch.set_num_threads(1)

F32 = dict(rtol=2e-5, atol=2e-5)
BF16_MAX_ABS = 0.02
STRESS = 3.0  # q and k scaled: scores ~9x wider, softmax peaked


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


REFERENCE_SHAPES = [
    (2, 128, 4, 2, 32),     # GQA
    (1, 256, 8, 8, 64),     # MHA
    (2, 128, 4, 1, 32),     # MQA
]


@pytest.mark.parametrize("b,s,h,kh,d", REFERENCE_SHAPES)
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
    reg = default_registry()
    before = reg.value(tk.LAUNCHES)
    t_flash(*_torch(_qkv(1, 32, 2, 1, 8)), True)
    assert reg.value(tk.LAUNCHES) == before


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


# -- the f32 kernel's 3xTF32 products, emulated --------------------------------

def _tf32_rna(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 rounds: half a TF32 ulp added
    to the bits, the 13 bits below it cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(x):
    """x as the tensor cores read a TF32 operand: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b from TF32 products: hi hi + hi lo + lo hi, lo = x - hi."""
    ah, bh = _tf32_rna(a), _tf32_rna(b)
    al, bl = _tf32_trunc(a - ah), _tf32_trunc(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _mm_tf32(a, b):
    """a @ b from one TF32 product per pair, what a plain TF32 kernel does."""
    return _tf32_rna(a) @ _tf32_rna(b)


def _emulated_flash(q, k, v, causal, mm, block=64):
    """The reference's blocked online-softmax recurrence on (B, S, H, D)
    f32 arrays with both products taken by `mm`; KV heads index as the
    GQA repeat does."""
    q, k, v = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    group = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    s, d = q.shape[2], q.shape[3]
    scale = 1.0 / np.sqrt(d)
    out = torch.empty_like(q)
    for q0 in range(0, s, block):
        qb = q[:, :, q0:q0 + block]
        iq = torch.arange(q0, q0 + qb.shape[2])[:, None]
        m = torch.full(qb.shape[:3], -1e30)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qb)
        for k0 in range(0, s, block):
            if causal and k0 > q0 + block - 1:
                break
            sc = mm(qb, k[:, :, k0:k0 + block].transpose(2, 3)) * scale
            if causal:
                ik = torch.arange(k0, k0 + sc.shape[3])
                sc = torch.where(ik[None, :] <= iq, sc, -1e30)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + mm(p, v[:, :, k0:k0 + block])
            m = m_new
        out[:, :, q0:q0 + block] = acc / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).numpy()


def _stressed(arrays, stress):
    q, k, v = arrays
    return q * np.float32(stress), k * np.float32(stress), v


@pytest.mark.parametrize("b,s,h,kh,d", REFERENCE_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("stress", [1.0, STRESS])
def test_3xtf32_products_meet_the_f32_bound(b, s, h, kh, d, causal, stress):
    """The f32 kernel's numerical design against the reference's Pallas
    kernel (interpret mode) and its oracle, at the reference's f32 bound."""
    arrays = _stressed(_qkv(b, s, h, kh, d, seed=7), stress)
    got = _emulated_flash(*arrays, causal, _mm_3xtf32)
    want_kernel = np.asarray(j_flash(*_jax(arrays), causal, bq=64, bk=64))
    want_ref = np.asarray(j_ref(*_jax(arrays), causal))
    np.testing.assert_allclose(got, want_kernel, **F32)
    np.testing.assert_allclose(got, want_ref, **F32)


@pytest.mark.parametrize("causal", [True, False])
def test_one_tf32_product_misses_the_f32_bound(causal):
    """Dropping the lo terms (one TF32 product per pair) fails the bound on
    the stressed case, so the test above would catch a kernel that did."""
    arrays = _stressed(_qkv(1, 256, 8, 8, 64, seed=7), STRESS)
    want = np.asarray(j_ref(*_jax(arrays), causal))
    one = _emulated_flash(*arrays, causal, _mm_tf32)
    three = _emulated_flash(*arrays, causal, _mm_3xtf32)
    excess = lambda got: float(
        (np.abs(got - want) - F32["rtol"] * np.abs(want)).max())
    assert excess(three) <= F32["atol"]
    assert excess(one) > 10 * F32["atol"]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("stress", [1.0, STRESS])
def test_f64_oracle_matches_the_reference(causal, stress):
    """The f64 evaluation the card tests hold stressed cases to, on folded
    operands with a GQA group of 3, against the reference's dense oracle
    (f32 there)."""
    arrays = _stressed(_qkv(2, 96, 6, 2, 32, seed=9), stress)
    fold = lambda a: torch.from_numpy(a).transpose(1, 2).reshape(
        -1, a.shape[1], a.shape[3])
    got = attention_f64(*map(fold, arrays), causal)
    got = got.reshape(2, 6, 96, 32).transpose(1, 2).numpy()
    want = np.asarray(j_ref(*_jax(arrays), causal))
    np.testing.assert_allclose(got, want, **F32)


def test_tf32_rounding_matches_cvt_rna():
    """Round to nearest on 10 mantissa bits, ties away from zero; the
    split is exact (hi + lo == x) and lo is at most half a TF32 ulp."""
    ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1.0 + ulp / 2, 1.0 + ulp / 2 - 2 ** -23,
                      -(1.0 + ulp / 2), 1.0 + 1.5 * ulp, 3.0e-3],
                     dtype=torch.float32)
    hi = _tf32_rna(x)
    assert hi[:5].tolist() == [1.0, 1.0 + ulp, 1.0, -(1.0 + ulp),
                               1.0 + 2 * ulp]
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.standard_normal(4096, dtype=np.float32) * 50)
    hi = _tf32_rna(y)
    lo = y - hi
    assert torch.equal(hi + lo, y)
    assert bool((lo.abs() <= hi.abs() * 2.0 ** -11).all())
