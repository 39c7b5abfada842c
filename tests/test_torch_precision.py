"""Port parity: `repro_torch.core.precision` (stream codecs) against `repro`.

Encoded bytes and scales must be bit-equal for all five codecs on the same
f32 input, including values at +/- the projection's max (where the fp8
codecs land exactly on the wire format's max), an all-zero projection and
an fp16-overflowing one. The policy numbers (tolerances, eps, wire bytes)
must be equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import precision as jprec
from repro_torch.core import precision as tprec

# Tiny shapes gain nothing from intra-op threads, and the suite runs several
# test workers on one host: one thread each keeps them from contending.
torch.set_num_threads(1)

CODECS = ("fp32", "bf16", "fp16", "fp8_e4m3", "fp8_e5m2")
ALIASES = ("float32", "f32", "bfloat16", "float16", "half", "fp8", "e4m3",
           "float8_e4m3", "float8_e4m3fn", "e5m2", "float8_e5m2")


@pytest.fixture(scope="module")
def stream():
    """(6, 10, 12) f32 filtered-projection-like values: mixed signs and
    magnitudes, +/-amax planted, one all-zero and one fp16-overflowing
    projection."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((6, 10, 12)).astype(np.float32)
    q *= np.float32([1.0, 3e2, 1e-3, 7e4, 1.0, 5e1])[:, None, None]
    q[4] = 0.0
    for p in (0, 1, 2, 3, 5):
        amax = np.abs(q[p]).max()
        q[p, 0, 0], q[p, 1, 1] = amax, -amax
    return q


def _bytes(x):
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


@pytest.mark.parametrize("name", CODECS)
def test_encode_bit_equal(stream, name):
    want = jprec.CODECS[name].encode(jnp.asarray(stream))
    got = tprec.CODECS[name].encode(torch.from_numpy(stream))
    assert got.data.dtype == tprec.Precision(name).storage_dtype
    np.testing.assert_array_equal(_bytes(got.data), _bytes(want.data))
    if want.scales is None:
        assert got.scales is None
    else:
        np.testing.assert_array_equal(got.scales.numpy(),
                                      np.asarray(want.scales))
    assert got.nbytes == want.nbytes
    # decode is the reference inverse, in f32 on both sides
    np.testing.assert_array_equal(
        tprec.CODECS[name].decode(got.data, got.scales).numpy(),
        np.asarray(jprec.CODECS[name].decode(want.data, want.scales)))


@pytest.mark.parametrize("name", CODECS + ALIASES)
def test_policy_numbers_equal(name):
    jp, tp = jprec.Precision(name), tprec.Precision(name)
    assert tp.storage == jp.storage
    assert tp.eps() == jp.eps()
    assert tp.rmse_tol() == jp.rmse_tol()
    assert tp.max_tol() == jp.max_tol()
    assert tp.storage_bytes == jp.storage_bytes
    assert tp.sidecar_bytes(7) == jp.sidecar_bytes(7)
    assert tp.wire_bytes(7, 14, 20) == jp.wire_bytes(7, 14, 20)
    assert tp.allgather_bytes(7, 14, 20) == jp.allgather_bytes(7, 14, 20)
    assert tp.codec.has_scales == jp.codec.has_scales
    assert tp.codec.normalize == jp.codec.normalize
    assert tprec.codec_for(name).name == jprec.codec_for(name).name


def test_defaults_and_resolution():
    assert tprec.default_storage("cuda") == jprec.default_storage("gpu") == "fp16"
    assert tprec.default_storage("cpu") == jprec.default_storage("cpu") == "bf16"
    assert tprec.resolve_precision(None, "cpu") == tprec.Precision("bf16")
    assert tprec.resolve_precision(None, "cuda") == tprec.Precision("fp16")
    assert tprec.resolve_precision("half") == tprec.Precision("fp16")
    p = tprec.Precision("fp8")
    assert tprec.resolve_precision(p) is p
    with pytest.raises(ValueError, match="unknown storage precision"):
        tprec.Precision("int4")
    with pytest.raises(ValueError, match="scale sidecar"):
        tprec.CODECS["fp16"].decode(torch.zeros(1, 2, 2, dtype=torch.float16))


def test_psnr_equal(stream):
    rng = np.random.default_rng(2)
    noisy = stream + 1e-3 * rng.standard_normal(stream.shape).astype(np.float32)
    assert tprec.psnr(torch.from_numpy(noisy), stream) == \
        jprec.psnr(noisy, stream)
    assert tprec.psnr(stream, stream) == float("inf")
