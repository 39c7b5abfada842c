"""Port parity: `repro_torch.core.filtering` against `repro`.

The numpy tables are the reference's own code, so they must be bit-equal.
The FFT convolution runs on torch.fft here and on XLA's FFT there; both are
f32, so the filtered projections are held at rtol 1e-5 / atol 1e-5 of the
max.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import filtering as jfilt
from repro.core import geometry as jgeo
from repro_torch.core import filtering as tfilt
from repro_torch.core import geometry as tgeo

# Tiny shapes gain nothing from intra-op threads, and the suite runs several
# test workers on one host: one thread each keeps them from contending.
torch.set_num_threads(1)

WINDOWS = ("ramlak", "shepp-logan", "hann", "hamming")
# Non-square detector; 36 projections span two of the port's FFT batches.
G = jgeo.CBCTGeometry(
    n_proj=36, n_u=20, n_v=14, d_u=4.8 / 20, d_v=4.8 / 20, d=4.0, dsd=8.0,
    n_x=10, n_y=8, n_z=12, d_x=0.2, d_y=0.25, d_z=2.0 / 12)
TG = tgeo.CBCTGeometry(**dataclasses.asdict(G))


@pytest.fixture(scope="module")
def projections():
    rng = np.random.default_rng(0)
    return rng.standard_normal(G.proj_shape()).astype(np.float32)


def test_tables_bit_equal():
    np.testing.assert_array_equal(tfilt.cosine_weights(TG),
                                  jfilt.cosine_weights(G))
    for n in (8, 16, 64):
        assert tfilt.fft_length(n) == jfilt.fft_length(n)
        np.testing.assert_array_equal(tfilt.ramp_kernel(n, 0.1),
                                      jfilt.ramp_kernel(n, 0.1))
    for w in WINDOWS:
        np.testing.assert_array_equal(
            tfilt.ramp_frequency_response(TG, w),
            jfilt.ramp_frequency_response(G, w))


@pytest.mark.parametrize("window", WINDOWS)
def test_make_filter_matches(projections, window):
    want = np.asarray(jfilt.make_filter(G, window)(jnp.asarray(projections)))
    got = tfilt.make_filter(TG, window, device="cpu")(
        torch.from_numpy(projections)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_out_dtype_and_one_shot_filter(projections):
    """out_dtype sets the emitted storage dtype (the FFT stays f32);
    filter_projections filters on the projections' own device."""
    proj = torch.from_numpy(projections)
    got = tfilt.make_filter(TG, out_dtype=torch.bfloat16, device="cpu")(proj)
    assert got.dtype == torch.bfloat16
    f32 = tfilt.filter_projections(TG, proj)
    assert f32.dtype == torch.float32 and f32.device == proj.device
    torch.testing.assert_close(got, f32.to(torch.bfloat16), rtol=0, atol=0)


def test_unknown_window_raises():
    with pytest.raises(ValueError, match="unknown window"):
        tfilt.ramp_frequency_response(TG, "blackman")


def test_make_filter_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is satisfiable")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tfilt.make_filter(TG)
