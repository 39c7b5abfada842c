"""Port parity: `repro_torch.core.filtering` against `repro`, and the
card's filter kernel (`kernels/filter`) through its torch twin.

The numpy tables are the reference's own code, so they must be bit-equal.
The FFT convolution runs on torch.fft here and on XLA's FFT there; both are
f32, so the filtered projections are held at rtol 1e-5 / atol 1e-5 of the
max.

The kernel runs only on the card; here its algorithm (`filter_rows_torch`:
the real split, the Stockham passes, the folded response table) is held to
the CPU path and to a float64 Toeplitz convolution, its host tables to
numpy in float64, its wrapper's checks and its operator's fake
implementation are exercised, and a CPU tensor is shown to keep taking
`_filter_batch`.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.core import filtering as jfilt
from repro.core import geometry as jgeo
from repro_torch.core import filtering as tfilt
from repro_torch.core import geometry as tgeo
from repro_torch.device import fake_card
from repro_torch.kernels.filter import kernel as rfk
from repro_torch.obs.metrics import default_registry

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


# -- the filter kernel's algorithm, tables and wrapper ------------------------

LOG2_PADS = range(7, 13)


def kernel_geometry(n_u: int, n_v: int = 3) -> tgeo.CBCTGeometry:
    return dataclasses.replace(TG, n_u=n_u, n_v=n_v, d_u=4.8 / n_u)


def kernel_operands(g, window, seed=0, n_proj=2):
    rng = np.random.default_rng(seed)
    proj = torch.from_numpy(
        rng.standard_normal((n_proj, g.n_v, g.n_u)).astype(np.float32))
    pad = tfilt.fft_length(g.n_u)
    hf = tfilt._response(g, window, pad)
    fcos = torch.as_tensor(tfilt.cosine_weights(g))
    return proj, fcos, hf, rfk.filter_tables(hf, g.tau_u, "cpu")


def toeplitz_f64(g, proj, hf) -> np.ndarray:
    """tau_u * sum_m x_w[m] h[(i - m) mod pad], i < N_u, in float64: the
    filter as a matrix, h the windowed kernel (irfft of the response)."""
    pad = 2 * (len(hf) - 1)
    h = np.fft.irfft(hf, n=pad)
    i = np.arange(g.n_u)
    x = proj.double().numpy() * tfilt.cosine_weights(g).astype(np.float64)
    return g.tau_u * x @ h[(i[:, None] - i[None, :]) % pad].T


# Per pad: N_u = pad / 2, an odd N_u just above pad / 4, and a detector of
# one row at N_u = pad / 2.
KERNEL_CASES = [(log2, n_u, n_v) for log2 in LOG2_PADS
                for n_u, n_v in ((1 << log2 - 1, 3), ((1 << log2 - 2) + 1, 3),
                                 (1 << log2 - 1, 1))]


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("log2,n_u,n_v", KERNEL_CASES)
def test_kernel_algorithm_matches_plain_version_and_toeplitz(window, log2,
                                                             n_u, n_v):
    """The twin against `_filter_batch` (two f32 FFT chains: 1e-5 of the
    max, as against the JAX package) and against float64 (its own f32
    round-off; measured below 3e-7 of the max at these pads)."""
    g = kernel_geometry(n_u, n_v)
    assert tfilt.fft_length(n_u) == 1 << log2
    proj, fcos, hf, tables = kernel_operands(g, window)
    got = rfk.filter_rows_torch(proj, fcos, *tables)
    assert got.shape == proj.shape and got.dtype == torch.float32
    chain = tfilt._filter_batch(proj, fcos,
                                torch.as_tensor(hf.astype(np.complex64)),
                                1 << log2, g.tau_u)
    scale = float(chain.abs().max())
    np.testing.assert_allclose(got.numpy(), chain.numpy(), rtol=1e-5,
                               atol=1e-5 * scale)
    exact = toeplitz_f64(g, proj, hf)
    assert np.abs(got.numpy() - exact).max() <= 2e-6 * np.abs(exact).max()


@pytest.mark.parametrize("log2", LOG2_PADS)
def test_twiddle_table_against_numpy(log2):
    """Each pass's block of exp(-2 pi i r k / (Ns R)), numpy float64 rounded
    once, in the order the source reads them; the passes' radices multiply
    to pad / 2 both ways, the inverse's reversed."""
    pad = 1 << log2
    fwd, inv = rfk.radices(pad), rfk.radices(pad, inverse=True)
    assert np.prod(fwd) == pad // 2 and inv == fwd[::-1]
    assert all(r == 16 for r in fwd[1:]) and fwd[0] in (2, 4, 8, 16)
    want = []
    for radices in (fwd, inv):
        ns = 1
        for r in radices:
            for rr in range(1, r if ns > 1 else 1):
                k = np.arange(ns)
                want.append(np.exp(-2j * np.pi * rr * k / (ns * r)))
            ns *= r
    want = np.concatenate(want).astype(np.complex64)
    got = rfk.twiddle_table(pad)
    assert got.shape == (rfk.twiddle_count(pad), 2) == (len(want), 2)
    np.testing.assert_array_equal(got[:, 0], want.real)
    np.testing.assert_array_equal(got[:, 1], want.imag)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("log2", [7, 11])
def test_response_table_folds_split_response_and_scale(window, log2):
    """In float64, P Z[k] + Q conj(Z[M - k]) between a length-M FFT of the
    packed row and an unnormalised inverse is tau * irfft(rfft(x) H) to
    1e-12; the f32 table is that P and Q rounded once."""
    pad = 1 << log2
    m = pad // 2
    g = kernel_geometry(m)
    hf = tfilt._response(g, window, pad)
    p, q = rfk.split_response(hf, g.tau_u)
    x = np.random.default_rng(1).standard_normal((4, pad))
    z = np.fft.fft(x[:, 0::2] + 1j * x[:, 1::2], axis=-1)
    zz = p * z + q * np.conj(z[:, (m - np.arange(m)) % m])
    y = np.fft.ifft(zz, axis=-1) * m
    got = np.stack([y.real, y.imag], -1).reshape(4, pad)
    want = g.tau_u * np.fft.irfft(np.fft.rfft(x) * hf, pad)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    table = rfk.response_table(hf, g.tau_u)
    np.testing.assert_array_equal(
        table, np.stack([p.real, p.imag, q.real, q.imag], 1).astype(
            np.float32))


@pytest.mark.parametrize("case", ["pad 16", "pad 32768", "float64", "int",
                                  "strided", "fcos shape", "twiddles",
                                  "N_u above pad / 2", "rank", "on the CPU"])
def test_kernel_wrapper_checks(case):
    g = kernel_geometry(64)
    proj, fcos, hf, (tw, pq) = kernel_operands(g, "ramlak")
    msg = {"pad 16": "compiled pad", "pad 32768": "compiled pad",
           "float64": "float32", "int": "float32",
           "strided": "contiguous", "fcos shape": "fcos must be",
           "twiddles": "twiddles must be", "N_u above pad / 2": "exceeds",
           "rank": "must be", "on the CPU": "runs on the card"}[case]
    if case == "pad 16":
        pq = pq[:8]
    elif case == "pad 32768":
        pq = torch.zeros((1 << 14, 4))
    elif case == "float64":
        proj = proj.double()
    elif case == "int":
        proj = proj.to(torch.int32)
    elif case == "strided":
        proj = torch.cat([proj, proj], -1)[..., ::2]
    elif case == "fcos shape":
        fcos = fcos[:, :-1]
    elif case == "twiddles":
        tw = tw[1:]
    elif case == "N_u above pad / 2":
        proj = torch.zeros((2, g.n_v, 65))
        fcos = torch.zeros((g.n_v, 65))
    elif case == "rank":
        proj = proj[0]
    with pytest.raises(ValueError, match=msg):
        rfk.filter_rows(proj, fcos, tw, pq)


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_kernel_operator_on_fake_tensors(device):
    """Fake tensors take the kernel's operator: fake CUDA ones through the
    wrapper, a dry run's fake CPU ones inside fake_card through make_filter
    (a real CPU tensor would take _filter_batch). f32 output of the input's
    shape and device, no launch counted, the library never loaded."""
    reg = default_registry()
    before = (reg.value(rfk.LAUNCHES, 0), reg.value(rfk.ROWS, 0),
              rfk.LIBRARY._lib)
    g = kernel_geometry(1248, 8)
    pad = tfilt.fft_length(g.n_u)
    with FakeTensorMode(), fake_card():
        proj = torch.empty((5, g.n_v, g.n_u), device=device)
        if device == "cpu":
            out = tfilt.make_filter(g, device="cpu")(proj)
        else:
            fcos = torch.empty((g.n_v, g.n_u), device=device)
            tw = torch.empty((rfk.twiddle_count(pad), 2), device=device)
            pq = torch.empty((pad // 2, 4), device=device)
            out = rfk.filter_rows(proj, fcos, tw, pq)
        assert out.shape == proj.shape and out.dtype == torch.float32
        assert out.device.type == device
    assert (reg.value(rfk.LAUNCHES, 0), reg.value(rfk.ROWS, 0),
            rfk.LIBRARY._lib) == before


def test_cpu_tensor_keeps_the_fft_chain(monkeypatch):
    """On the CPU make_filter is today's path: _filter_batch in batches of
    _FILTER_BATCH, bit-equal to running it by hand, and never the
    kernel's wrapper."""
    def refuse(*args):
        raise AssertionError("the CPU path reached the kernel's wrapper")

    monkeypatch.setattr(rfk, "filter_rows", refuse)
    proj = torch.from_numpy(np.random.default_rng(2).standard_normal(
        G.proj_shape()).astype(np.float32))
    got = tfilt.make_filter(TG, "hann", device="cpu")(proj)
    pad = tfilt.fft_length(TG.n_u)
    fcos = torch.as_tensor(tfilt.cosine_weights(TG))
    hf = torch.as_tensor(tfilt.ramp_frequency_response(TG, "hann", pad))
    want = torch.cat([tfilt._filter_batch(proj[b:b + tfilt._FILTER_BATCH],
                                          fcos, hf, pad, TG.tau_u)
                      for b in range(0, G.n_proj, tfilt._FILTER_BATCH)])
    assert G.n_proj > tfilt._FILTER_BATCH
    assert torch.equal(got, want)
