"""Port parity for the shard store: `repro_torch.io.shard_store` against
`repro.io.shard_store`.

Stores are byte-compatible both ways: a store the JAX package writes is
read by the port bit for bit, and the reverse, for the five wire dtypes
of the projection stream (f32, fp16, bf16, fp8 e4m3, fp8 e5m2), with a
chunked layout, and for an encoded projection store with its scale
sidecar; the manifests carry the same keys and values. Scatter reads open
only the shards they overlap, and every corruption kind raises StoreError
with the reference's message (a parametrized test: the reference's own
corruption test runs hypothesis over a function-scoped tmp_path and fails
for that reason alone).
"""
import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.io import shard_store as js
from repro.io import streams as jstreams
from repro_torch.io import shard_store as ts
from repro_torch.io import streams as tstreams

torch.set_num_threads(1)

# manifest dtype name -> (numpy dtype of the JAX side, torch dtype)
DTYPES = {
    "float32": (np.float32, torch.float32),
    "float16": (np.float16, torch.float16),
    "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16),
    "float8_e4m3fn": (ml_dtypes.float8_e4m3fn, torch.float8_e4m3fn),
    "float8_e5m2": (ml_dtypes.float8_e5m2, torch.float8_e5m2),
}


def values(name):
    """A (4, 6, 8) array of the dtype from a seed, finite in every wire
    format: the JAX side's numpy array and the same bits as a tensor."""
    npdt, tdt = DTYPES[name]
    f = np.random.default_rng(3).standard_normal((4, 6, 8)).astype(
        np.float32) * 8
    arr = f.astype(npdt)
    raw = arr.view({1: np.uint8, 2: np.int16, 4: np.int32}[arr.itemsize])
    return arr, torch.from_numpy(raw.copy()).view(tdt)


def same_bits(arr: np.ndarray, t: torch.Tensor) -> bool:
    return (tuple(t.shape) == arr.shape and
            t.contiguous().view(torch.uint8).numpy().tobytes() ==
            np.ascontiguousarray(arr).tobytes())


@pytest.mark.parametrize("chunks", [None, (2, 1, 2)], ids=["one", "chunked"])
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_jax_store_reads_in_the_port(tmp_path, name, chunks):
    arr, _ = values(name)
    js.save_array(str(tmp_path / "s"), arr, chunks=chunks)
    out = ts.load_array(str(tmp_path / "s"))
    assert out.dtype == DTYPES[name][1]
    assert same_bits(arr, out)


@pytest.mark.parametrize("chunks", [None, (2, 1, 2)], ids=["one", "chunked"])
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_port_store_reads_in_jax(tmp_path, name, chunks):
    arr, t = values(name)
    ts.save_array(str(tmp_path / "t"), t, chunks=chunks)
    js.save_array(str(tmp_path / "j"), arr, chunks=chunks)
    out = js.load_array(str(tmp_path / "t"))
    assert out.dtype == arr.dtype
    assert out.tobytes() == arr.tobytes()
    mt, mj = (js.read_manifest(str(tmp_path / d)) for d in ("t", "j"))
    assert list(mt) == list(mj) and mt == mj
    for d in ("t", "j"):
        assert sorted(os.listdir(tmp_path / d / "shards")) == \
            [e["file"] for e in mt["shards"]]
        for e in mt["shards"]:
            assert (tmp_path / d / "shards" / e["file"]).read_bytes() == \
                (tmp_path / "j" / "shards" / e["file"]).read_bytes()


@pytest.mark.parametrize("codec", ["fp16", "fp8_e4m3", "fp8_e5m2", "bf16"])
def test_encoded_projection_store_and_sidecar_both_ways(tmp_path, codec):
    proj = np.random.default_rng(5).standard_normal((8, 4, 6)).astype(
        np.float32) * 1e5      # fp16 needs its scale-on-overflow here
    jsrc = jstreams.ProjectionSource.write(str(tmp_path / "j"), proj,
                                           chunks=(4, 1, 1), codec=codec)
    tsrc = tstreams.ProjectionSource.write(str(tmp_path / "t"), proj,
                                           chunks=(4, 1, 1), codec=codec)
    jd, jsc = jsrc.load_encoded()
    for src in (tsrc, tstreams.ProjectionSource(str(tmp_path / "j"))):
        td, tsc = src.load_encoded()
        assert same_bits(np.asarray(jd), td)
        assert (tsc is None) == (jsc is None)
        if jsc is not None:
            assert same_bits(np.asarray(jsc), tsc)
        assert src.codec_name == jsrc.codec_name
    td2, tsc2 = jstreams.ProjectionSource(str(tmp_path / "t")).load_encoded()
    assert td2.tobytes() == np.asarray(jd).tobytes()
    assert (tsc2 is None) == (jsc is None)
    if jsc is not None:
        assert tsc2.tobytes() == np.asarray(jsc).tobytes()
    for sub in ("", "scales"):
        mj = tmp_path / "j" / sub / "MANIFEST.json"
        if mj.exists():
            assert json.loads(mj.read_text()) == json.loads(
                (tmp_path / "t" / sub / "MANIFEST.json").read_text())


@pytest.mark.parametrize("value", [
    np.arange(8, dtype=np.int64), np.int64(7), np.array([True, False]),
    np.arange(6.0).reshape(2, 3)], ids=["i64", "0-d", "bool", "f64"])
def test_other_dtypes_round_trip_both_ways(tmp_path, value):
    ts.save_array(str(tmp_path / "t"), value)
    js.save_array(str(tmp_path / "j"), value)
    np.testing.assert_array_equal(ts.load_array(str(tmp_path / "j")).numpy(),
                                  value)
    np.testing.assert_array_equal(js.load_array(str(tmp_path / "t")), value)
    assert ts.read_manifest(str(tmp_path / "t")) == \
        js.read_manifest(str(tmp_path / "j"))


def test_write_clears_a_stale_store_and_checks_chunks(tmp_path):
    path = str(tmp_path / "a")
    ts.save_array(path, np.zeros((8, 8), np.float32), chunks=(4, 1))
    ts.save_array(path, np.ones((4, 4), np.float32))
    assert len(os.listdir(os.path.join(path, "shards"))) == 1
    np.testing.assert_array_equal(ts.load_array(path).numpy(), np.ones((4, 4)))
    for chunks in ((3, 1), (2,)):
        msgs = []
        for store in (js, ts):
            with pytest.raises(ValueError) as e:
                store.save_array(str(tmp_path / "b"), np.zeros((8, 8)),
                                 chunks=chunks)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_scatter_read_opens_only_overlapping_shards(tmp_path):
    a = np.arange(64, dtype=np.float32).reshape(8, 8)
    path = str(tmp_path / "a")
    js.save_array(path, a, chunks=(2, 2))        # 4 files of 4 x 4
    for region, files in (((slice(0, 4), slice(0, 4)), 1),
                          (((2, 6), (0, 8)), 4),
                          ((slice(5, 7), slice(1, 6)), 2)):
        ts.reset_open_count()
        out = ts.read_region(path, region)
        assert ts.open_count() == files
        want = a[tuple(r if isinstance(r, slice) else slice(*r)
                       for r in region)]
        np.testing.assert_array_equal(out.numpy(), want)
    ts.reset_open_count()
    ts.load_array(path)
    assert ts.open_count() == 4


def _corrupt(path, kind):
    shard0 = os.path.join(path, "shards", "shard_00000.bin")
    mpath = os.path.join(path, "MANIFEST.json")
    if kind == "truncate":
        with open(shard0, "r+b") as f:
            f.truncate(10)
    elif kind == "delete_file":
        os.remove(shard0)
    elif kind == "drop_entry":
        with open(mpath) as f:
            m = json.load(f)
        del m["shards"][0]
        with open(mpath, "w") as f:
            json.dump(m, f)
    elif kind == "no_manifest":
        os.remove(mpath)
    elif kind == "bad_manifest":
        with open(mpath, "w") as f:
            f.write("{not json")
    elif kind == "bad_dtype":
        with open(mpath) as f:
            m = json.load(f)
        m["dtype"] = "float7"
        with open(mpath, "w") as f:
            json.dump(m, f)


CORRUPTIONS = [("truncate", "truncated"),
               ("delete_file", "missing shard file"),
               ("drop_entry", "does not cover"),
               ("no_manifest", "missing MANIFEST"),
               ("bad_manifest", "unreadable manifest"),
               ("bad_dtype", "unknown dtype"),
               ("overlap", "overlaps committed shard")]


@pytest.mark.parametrize("kind,match", CORRUPTIONS,
                         ids=[k for k, _ in CORRUPTIONS])
def test_each_corruption_raises_store_error(tmp_path, kind, match):
    """Each kind raises StoreError in the port, as in the reference: a
    read of a damaged store, or an append over a committed region (the
    reference's own dtype lookup raises TypeError for an unknown name, so
    that kind is the port's only)."""
    a = np.arange(64, dtype=np.float32).reshape(8, 8)
    for store in (ts, js):
        path = str(tmp_path / store.__name__.split(".")[0])
        store.save_array(path, a, chunks=(2, 2))
        _corrupt(path, kind)
        if store is js and kind == "bad_dtype":
            continue
        with pytest.raises(store.StoreError, match=match):
            if kind == "overlap":
                store.append_region(path, ((2, 6), (0, 4)), a[2:6, :4])
            else:
                store.load_array(path)


def test_distant_corruption_leaves_other_regions_readable(tmp_path):
    a = np.arange(64, dtype=np.float32).reshape(8, 8)
    path = str(tmp_path / "a")
    ts.save_array(path, a, chunks=(2, 2))
    with open(os.path.join(path, "shards", "shard_00003.bin"), "r+b") as f:
        f.truncate(3)
    np.testing.assert_array_equal(
        ts.read_region(path, (slice(0, 4), slice(0, 4))).numpy(), a[:4, :4])
    with pytest.raises(ts.StoreError, match="truncated"):
        ts.read_region(path, (slice(4, 8), slice(4, 8)))


def test_growing_store_matches_reference_and_rejects_overlap(tmp_path):
    """init_store + append_region in both packages give the same manifest
    and bytes; an overlapping append raises StoreError with the
    reference's message, word for word; a wrong-shaped append raises
    ValueError."""
    data = np.random.default_rng(1).standard_normal((6, 2, 3)).astype(
        np.float32)
    for name, store in (("j", js), ("t", ts)):
        path = str(tmp_path / name)
        store.init_store(path, (6, 2, 3),
                         np.float32 if store is js else torch.float32,
                         extra_manifest={"codec": None})
        store.append_region(path, ((0, 2), (0, 2), (0, 3)), data[:2])
        store.append_region(path, (slice(4, 6), slice(0, 2), slice(0, 3)),
                            data[4:])
    assert ts.read_manifest(str(tmp_path / "t")) == \
        js.read_manifest(str(tmp_path / "j"))
    for f in ("shard_00000.bin", "shard_00001.bin"):
        assert (tmp_path / "t" / "shards" / f).read_bytes() == \
            (tmp_path / "j" / "shards" / f).read_bytes()
    msgs = []
    for name, store in (("j", js), ("t", ts)):
        with pytest.raises(store.StoreError, match="overlaps committed") as e:
            store.append_region(str(tmp_path / name),
                                ((1, 3), (0, 2), (0, 3)), data[1:3])
        msgs.append(str(e.value).replace(str(tmp_path / name), "P"))
        with pytest.raises(ValueError, match="does not span"):
            store.append_region(str(tmp_path / name),
                                ((2, 4), (0, 2), (0, 3)), data[:1])
    assert msgs[0] == msgs[1]


def test_snapshot_without_a_mesh_is_a_host_copy(tmp_path):
    """The copy is taken at snapshot time; a host write records no spec,
    as the reference's does."""
    t = torch.arange(6.0)
    snap = ts.snapshot(t)
    t += 1
    assert torch.equal(snap, torch.arange(6.0))
    ts.save_array(str(tmp_path / "s"), snap)
    assert ts.stored_spec(str(tmp_path / "s")) is None
    assert js.stored_spec(str(tmp_path / "s")) is None
