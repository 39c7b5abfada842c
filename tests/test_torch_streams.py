"""Port parity for the pipeline's I/O endpoints: `repro_torch.io.streams`
against `repro.io.streams`.

The discovery protocol across packages: `poll`/`iter_deltas` of the port
on a store the JAX writer grows, and of the JAX package on a store the
port's writer grows, raw and fp8-encoded; an early break is not
re-reported. `load_slice` and `load` decode to the codec's round trip,
bit-equal to the JAX package's. `VolumeSink` records and restores the
`y_chunk_major` layout. `SourcePrefetcher` keeps order and hands each
load's error to its own `get`; `AsyncWriteback` copies at submit and
drains in order.
"""
import time

import numpy as np
import pytest
import torch

from repro.core.precision import Precision as JPrecision
from repro.io import streams as jstreams
from repro.io.shard_store import StoreError as JStoreError
from repro_torch.core.precision import Precision
from repro_torch.io import shard_store as ts
from repro_torch.io import streams as tstreams
from repro_torch.obs import metrics as tmetrics

torch.set_num_threads(1)

N_P, N_V, N_U = 16, 6, 10


@pytest.fixture(scope="module")
def proj():
    return np.random.default_rng(11).standard_normal(
        (N_P, N_V, N_U)).astype(np.float32)


PACKAGES = {"jax": jstreams, "torch": tstreams}


def iter_deltas(streams, src):
    if streams is tstreams:
        return [(lo, hi, d.numpy())
                for lo, hi, d in src.iter_deltas(device="cpu")]
    return [(lo, hi, np.asarray(d)) for lo, hi, d in src.iter_deltas()]


@pytest.mark.parametrize("codec", [None, "fp8_e4m3", "fp16"])
@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_poll_and_iter_deltas_across_packages(tmp_path, proj, writer,
                                              reader, codec):
    """A growing store written by one package is discovered, loaded and
    decoded by the other exactly as by its own reader."""
    w = PACKAGES[writer].StreamingProjectionWriter(
        str(tmp_path / "s"), (N_P, N_V, N_U), codec=codec)
    src = PACKAGES[reader].ProjectionSource(str(tmp_path / "s"))
    own = PACKAGES[writer].ProjectionSource(str(tmp_path / "s"))
    assert src.poll() == []
    w.append(proj[:4], 0)
    w.append(proj[8:12], 8)
    assert src.poll() == [(0, 4), (8, 12)]
    assert src.poll() == [(0, 4), (8, 12)]    # read-only until consumed
    got = iter_deltas(PACKAGES[reader], src)
    want = iter_deltas(PACKAGES[writer], own)
    assert [(lo, hi) for lo, hi, _ in got] == [(0, 4), (8, 12)]
    for (_, _, a), (_, _, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert src.poll() == []
    w.append(proj[4:8], 4)
    assert src.poll() == [(4, 8)]
    if codec is not None:
        assert src.codec_name == Precision(codec).storage


def test_iter_deltas_early_break_is_not_rereported(tmp_path, proj):
    w = tstreams.StreamingProjectionWriter(str(tmp_path / "s"),
                                           (N_P, N_V, N_U))
    w.append(proj[:4], 0)
    w.append(proj[8:12], 8)
    src = tstreams.ProjectionSource(str(tmp_path / "s"))
    for lo, hi, delta in src.iter_deltas(device="cpu"):
        assert (lo, hi) == (0, 4)
        np.testing.assert_array_equal(delta.numpy(), proj[:4])
        break
    assert src.poll() == [(8, 12)]
    assert [(lo, hi) for lo, hi, _ in src.iter_deltas(device="cpu")] == \
        [(8, 12)]
    assert src.poll() == []
    assert tstreams.ProjectionSource(str(tmp_path / "nowhere")).poll() == []


def test_a_commit_between_manifest_reads_waits_for_the_next_poll(
        tmp_path, proj, monkeypatch):
    """The scanner commits a delta right after iter_deltas has read the
    manifest: that delta is handed out by the next call, not lost and not
    a KeyError (as when the file map and the ranges came from two reads of
    the manifest; the reference reads it twice, streams.py:233-242)."""
    w = tstreams.StreamingProjectionWriter(str(tmp_path / "s"),
                                           (N_P, N_V, N_U))
    w.append(proj[:4], 0)
    src = tstreams.ProjectionSource(str(tmp_path / "s"))
    real, reads = ts.read_manifest, []

    def racing(path):
        m = real(path)
        reads.append(path)
        if len(reads) == 1:
            w.append(proj[4:8], 4)
        return m
    monkeypatch.setattr(ts, "read_manifest", racing)
    assert [(lo, hi) for lo, hi, _ in src.iter_deltas(device="cpu")] == \
        [(0, 4)]
    monkeypatch.undo()
    assert src.poll() == [(4, 8)]
    (lo, hi, delta), = src.iter_deltas(device="cpu")
    assert (lo, hi) == (4, 8) and torch.equal(delta,
                                              torch.from_numpy(proj[4:8]))


def test_poll_skips_an_entry_whose_bytes_are_short(tmp_path, proj):
    """A committed entry whose file a non-protocol writer truncated is not
    handed out."""
    w = tstreams.StreamingProjectionWriter(str(tmp_path / "s"),
                                           (N_P, N_V, N_U))
    w.append(proj[:4], 0)
    w.append(proj[4:8], 4)
    with open(tmp_path / "s" / "shards" / "shard_00001.bin", "r+b") as f:
        f.truncate(7)
    assert tstreams.ProjectionSource(str(tmp_path / "s")).poll() == [(0, 4)]


@pytest.mark.parametrize("codec", ["fp32", "bf16", "fp16", "fp8_e4m3",
                                   "fp8_e5m2"])
def test_load_slice_is_the_codec_round_trip(tmp_path, proj, codec):
    """load_slice decodes data x scales: bit-equal to decode(encode()) of
    the port's codec and to the JAX package's load_slice of the same
    store."""
    w = tstreams.StreamingProjectionWriter(str(tmp_path / "s"),
                                           (N_P, N_V, N_U), codec=codec)
    w.append(proj[:8], 0)
    w.append(proj[8:], 8)
    c = Precision(codec).codec
    want = c.decode(*c.encode(torch.from_numpy(proj[4:12])))
    got = tstreams.ProjectionSource(str(tmp_path / "s")).load_slice(
        4, 12, device="cpu")
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
    ref = np.asarray(jstreams.ProjectionSource(str(tmp_path / "s"))
                     .load_slice(4, 12))
    np.testing.assert_array_equal(got.numpy(), ref)
    jc = JPrecision(codec).codec
    np.testing.assert_array_equal(
        ref, np.asarray(jc.decode(*jc.encode(proj[4:12]))))


@pytest.mark.parametrize("codec", [None, "fp8_e5m2"])
def test_load_matches_the_reference(tmp_path, proj, codec):
    jstreams.ProjectionSource.write(str(tmp_path / "s"), proj,
                                    chunks=(4, 1, 1), codec=codec)
    src = tstreams.ProjectionSource(str(tmp_path / "s"))
    assert src.shape == (N_P, N_V, N_U)
    assert src.dtype == (torch.float32 if codec is None
                         else Precision(codec).storage_dtype)
    ts.reset_open_count()
    got = src.load(device="cpu")
    assert ts.open_count() == 4 + (4 if codec else 0)
    ref = jstreams.ProjectionSource(str(tmp_path / "s")).load()
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_load_defaults_to_the_card(tmp_path, proj):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is satisfiable")
    src = tstreams.ProjectionSource.write(str(tmp_path / "s"), proj)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        src.load()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        src.load_slice(0, 4)


def test_rank_rows_reject_a_range_that_does_not_divide():
    class Mesh:
        def size(self):
            return 4
    assert tstreams.rank_rows(3, 9, None) == (3, 9)
    with pytest.raises(ValueError, match="must divide over the 4 ranks"):
        tstreams.rank_rows(0, 6, Mesh())


def test_volume_sink_layouts_across_packages(tmp_path):
    vol = np.arange(4 * 8 * 4, dtype=np.float32).reshape(4, 8, 4)
    chunked = vol.reshape(4, 2, 4, 4)       # (N_x, y_chunks, yc, N_z)
    layout = {"kind": "y_chunk_major", "y_chunks": 2}
    t = tstreams.VolumeSink(str(tmp_path / "t"))
    t.write(torch.from_numpy(chunked), layout=layout)
    assert t.layout() == layout
    np.testing.assert_array_equal(t.read().numpy(), vol)
    assert t.nbytes() == vol.nbytes
    j = jstreams.VolumeSink(str(tmp_path / "t"))
    np.testing.assert_array_equal(j.read(), vol)
    jstreams.VolumeSink(str(tmp_path / "j")).write(chunked, layout=layout)
    np.testing.assert_array_equal(
        tstreams.VolumeSink(str(tmp_path / "j")).read().numpy(), vol)
    plain = tstreams.VolumeSink(str(tmp_path / "p"))
    plain.write(vol)
    assert plain.layout() is None
    np.testing.assert_array_equal(plain.read().numpy(), vol)
    odd = tstreams.VolumeSink(str(tmp_path / "z"))
    odd.write(np.zeros((2, 2, 2, 2), np.float32), layout={"kind": "z_order"})
    with pytest.raises(ts.StoreError, match="unknown layout"):
        odd.read()
    jstreams.VolumeSink(str(tmp_path / "jz")).write(
        np.zeros((2, 2, 2, 2), np.float32), layout={"kind": "z_order"})
    with pytest.raises(JStoreError, match="unknown layout"):
        jstreams.VolumeSink(str(tmp_path / "jz")).read()


def test_writer_rejects_a_delta_that_does_not_fit(tmp_path, proj):
    msgs = []
    for streams in (jstreams, tstreams):
        with pytest.raises(ValueError) as e:
            streams.StreamingProjectionWriter(str(tmp_path / "a"), (4, 4))
        msgs.append(str(e.value))
        w = streams.StreamingProjectionWriter(
            str(tmp_path / streams.__name__), (N_P, N_V, N_U))
        with pytest.raises(ValueError) as e:
            w.append(proj[:8], 12)
        msgs.append(str(e.value))
    assert msgs[:2] == msgs[2:]


def test_prefetcher_order_and_errors():
    def boom():
        raise OSError("disk gone")
    pf = tstreams.SourcePrefetcher(
        [lambda: 1, boom, lambda: 3], depth=1)
    assert pf.get() == 1
    with pytest.raises(tstreams.PrefetchError, match="disk gone") as e:
        pf.get()
    assert isinstance(e.value.__cause__, OSError)
    assert pf.get() == 3
    for _ in range(2):             # exhaustion is latched
        with pytest.raises(StopIteration):
            pf.get()
    assert list(tstreams.SourcePrefetcher([lambda i=i: i for i in range(5)],
                                          depth=2)) == list(range(5))


def test_prefetcher_persistent_extend_finish_and_close():
    pf = tstreams.SourcePrefetcher([lambda: "a"], persistent=True)
    assert pf.get() == "a"
    pf.extend([lambda: "b", lambda: "c"])
    assert [pf.get(), pf.get()] == ["b", "c"]
    pf.finish()
    with pytest.raises(StopIteration):
        pf.get()
    with pytest.raises(RuntimeError, match="cannot extend"):
        pf.extend([lambda: "d"])
    # a worker blocked on a full queue is let go by close()
    full = tstreams.SourcePrefetcher([lambda: "x"] * 4, depth=1).start()
    while full._q.qsize() < 1:
        time.sleep(0.01)
    full.close()
    with pytest.raises(StopIteration):
        full.get()
    assert not full._thread.is_alive()


def test_async_writeback_copies_at_submit_and_drains(tmp_path):
    reg = tmetrics.default_registry()
    writes = reg.value("io.writeback.writes")
    wb = tstreams.AsyncWriteback(max_pending=1)
    try:
        vols = [torch.full((2, 3, 4), float(i)) for i in range(3)]
        sinks = [tstreams.VolumeSink(str(tmp_path / f"v{i}"))
                 for i in range(3)]
        for sink, vol in zip(sinks, vols):
            wb.submit(sink, vol)
            vol.fill_(-1.0)        # the caller reuses its buffer at once
        assert wb.drain() >= 1 and wb.pending == 0
        assert reg.value("io.writeback.writes") - writes == 3
        for i, sink in enumerate(sinks):
            assert torch.equal(sink.read(), torch.full((2, 3, 4), float(i)))

        class Broken:
            def write(self, volume, layout=None):
                raise OSError("quota")
        wb.submit(Broken(), torch.zeros(2))
        wb.submit(sinks[0], torch.ones(2, 3, 4))
        with pytest.raises(OSError, match="quota"):
            wb.drain()
        assert torch.equal(sinks[0].read(), torch.ones(2, 3, 4))
    finally:
        wb.close()
    with pytest.raises(ValueError, match="max_pending"):
        tstreams.AsyncWriteback(max_pending=0)
