"""Port parity for the mesh engine on a (2, 2, 2) gloo mesh: eight spawned
ranks of `tests/_torch_mesh_rank.py` run `ReconstructionPlan(mesh=...)`
for {fused, pipelined, chunked} x {psum, scatter} x {factorized, kernel}
(the kernel runs its plain version on the CPU), scatter_bf16, fp8 and bf16
streams; each output, gathered by `assemble_volume`, is held against the
JAX package's single-device reconstruction of the same numpy projections,
computed here, at the bounds of tests/test_plan.py's 2 x 2 x 2 run. The
ranks also run the incremental session (psum, scatter, scatter_bf16) by
polling a streaming store the test writes, held against the JAX package's
single-device session on the same deltas, and store its volume to a sink
every rank writes its own shard of. The ranks are spawned once for the
module; every process group has a 60 s timeout and every rank a
deadline.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import phantom as jph
from repro.core.geometry import default_geometry as jdefault_geometry
from repro.core.plan import ReconstructionPlan as JaxPlan
from repro.core.precision import Precision
from repro_torch.core.geometry import default_geometry
from repro_torch.core.plan import ReconstructionPlan
from repro_torch.io.streams import StreamingProjectionWriter, VolumeSink

torch.set_num_threads(1)

WORLD = 8
DEADLINE_S = 180
MAX_ABS = 5e-6                    # tests/test_plan.py:450
BF16_REDUCE_RTOL = 4 * 2.0 ** -8  # tests/test_plan.py TestStreamCodecPlans
FP8_VS_SINGLE_REL = 1e-5          # only f32 reassociation in the reduce
# bf16 stream, port vs JAX: the packages' f32 filter outputs differ by up
# to 2.4e-7 (torch.fft against XLA's FFT), which flips 5 of the 18432
# bf16 roundings by one bf16 ulp (2.4e-4); their single-device bf16
# volumes are 1.2e-5 apart in max abs. The bound is 2.5x that gap.
BF16_VS_JAX_MAX_ABS = 3e-5
HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
SCHEDULES = ("fused", "pipelined", "chunked")


def projections():
    """The phantom's projections at 16^3 / 32 views plus 1 % Gaussian
    noise from a seed, as numpy f32."""
    g = jdefault_geometry(16, n_proj=32)
    clean = np.asarray(jph.forward_project(g))
    rng = np.random.default_rng(14)
    noise = rng.standard_normal(clean.shape).astype(np.float32)
    return g, (clean + 0.01 * float(np.abs(clean).max()) * noise).astype(
        np.float32)


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """Run the eight ranks once; the volumes and metadata rank 0 wrote."""
    work = tmp_path_factory.mktemp("mesh222")
    g, proj = projections()
    np.save(work / "proj.npy", proj)
    writer = StreamingProjectionWriter(str(work / "stream"), proj.shape)
    for lo in range(0, g.n_proj, 8):
        writer.append(proj[lo:lo + 8], lo)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_mesh_rank.py"),
         str(r), str(WORLD), str(work / "pg_init"), str(work)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=DEADLINE_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-3000:]}"
    vols = dict(np.load(work / "volumes.npz"))
    meta = json.loads((work / "meta.json").read_text())
    meta["work"] = str(work)
    return g, proj, {k.replace("__", "/"): v for k, v in vols.items()}, meta


@pytest.fixture(scope="module")
def jax_f32(mesh_run):
    g, proj, _, _ = mesh_run
    return np.asarray(JaxPlan(geometry=g).build()(proj))


@pytest.mark.parametrize("reduce", ["psum", "scatter"])
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("impl", ["factorized", "kernel"])
def test_mesh_matches_jax_single_device(mesh_run, jax_f32, impl, schedule,
                                        reduce):
    _, _, vols, _ = mesh_run
    err = float(np.max(np.abs(vols[f"{impl}/{schedule}/{reduce}"] - jax_f32)))
    assert err < MAX_ABS, f"{impl}/{schedule}/{reduce}: {err:.3e}"


@pytest.mark.parametrize("schedule,reduce", [("fused", "psum"),
                                             ("pipelined", "scatter"),
                                             ("chunked", "scatter")])
def test_traced_engine_on_mesh(mesh_run, jax_f32, schedule, reduce):
    """build_traced on eight ranks (the fused stage decomposition of each
    schedule; each rank's P in the AllGather's column order) against the
    JAX package's single-device volume."""
    _, _, vols, _ = mesh_run
    err = float(np.max(np.abs(vols[f"traced/{schedule}/{reduce}"]
                              - jax_f32)))
    assert err < MAX_ABS, f"traced/{schedule}/{reduce}: {err:.3e}"


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_scatter_bf16_on_mesh(mesh_run, jax_f32, schedule):
    """Half-width reduce on a real 2-rank data axis: within the bf16 bound
    of the f32 reference (the chunked carry keeps it there over both
    micro-batches)."""
    _, _, vols, _ = mesh_run
    out = vols[f"factorized/{schedule}/scatter_bf16"]
    rel = float(np.max(np.abs(out - jax_f32)) / np.max(np.abs(jax_f32)))
    assert rel < BF16_REDUCE_RTOL, f"{schedule}: {rel:.3e}"


@pytest.mark.parametrize("case", ["fp8_e4m3/fused/psum",
                                  "fp8_e4m3/pipelined/scatter"])
def test_fp8_on_mesh(mesh_run, jax_f32, case):
    """The fp8 stream and its scale sidecar through the gather: within the
    fp8 bound of f32, and 1e-5 of the port's own single-device fp8 engine
    (the codec quantizes per projection, so only the reduce's f32 order
    separates the two)."""
    g, proj, vols, _ = mesh_run
    out = vols[case]
    scale = float(np.max(np.abs(jax_f32)))
    assert float(np.max(np.abs(out - jax_f32))) / scale < \
        Precision("fp8_e4m3").max_tol()
    single = ReconstructionPlan(
        geometry=default_geometry(16, n_proj=32), precision="fp8_e4m3",
        device="cpu").build()(proj).numpy()
    rel = float(np.max(np.abs(out - single)) / np.max(np.abs(single)))
    assert rel < FP8_VS_SINGLE_REL, f"{case}: {rel:.3e}"


def test_chunked_psum_bf16_on_mesh(mesh_run):
    """A bf16 stream through chunked + psum: within 5e-6 of the port's own
    single-device bf16 engine (the same encoded stream; only the reduce's
    f32 order differs), and within BF16_VS_JAX_MAX_ABS of the JAX
    package's bf16 result (the FFTs' flipped bf16 roundings; see there)."""
    g, proj, vols, _ = mesh_run
    out = vols["bf16/chunked/psum"]
    single = ReconstructionPlan(
        geometry=default_geometry(16, n_proj=32), precision="bf16",
        device="cpu").build()(proj).numpy()
    err = float(np.max(np.abs(out - single)))
    assert err < MAX_ABS, f"{err:.3e}"
    ref16 = np.asarray(JaxPlan(geometry=g, precision="bf16").build()(proj))
    err = float(np.max(np.abs(out - ref16)))
    assert err < BF16_VS_JAX_MAX_ABS, f"{err:.3e}"


@pytest.mark.parametrize("reduce,shape", [
    ("psum", [8, 16, 16]), ("scatter", [8, 4, 2, 16])])
def test_chunked_local_layout(mesh_run, reduce, shape):
    """Each rank's chunked output: its x-slab (N_x/R, N_y, N_z) under psum,
    the 4-D store (N_x/R, y_chunks, N_y/y_chunks/C_data, N_z) under
    scatter."""
    _, _, _, meta = mesh_run
    for impl in ("factorized", "kernel"):
        assert meta["shapes"][f"{impl}/chunked/{reduce}"] == shape


def test_column_pmats_are_the_gathered_order(mesh_run):
    """Each rank slices its column group's P per micro-batch (fused and 2
    steps) exactly as the model-axis AllGather would concatenate it."""
    assert mesh_run[3]["column_pmats"]


@pytest.mark.parametrize("key,msg", [
    ("np_ranks", "N_p=30 must divide over the 8 ranks of the R=2 x C=4 grid"),
    ("nx_slabs", "N_x=17 must divide into R=2 volume slabs")])
def test_validate_messages_on_mesh(mesh_run, key, msg):
    assert msg in mesh_run[3]["errors"][key]


@pytest.fixture(scope="module")
def jax_session(mesh_run):
    """The JAX package's single-device session over the same 8-projection
    deltas."""
    g, proj, _, _ = mesh_run
    sess = JaxPlan(geometry=g, schedule="incremental",
                   n_steps=4).build_incremental()
    for lo in range(0, g.n_proj, 8):
        sess.update(proj[lo:lo + 8], (lo, lo + 8))
    return np.asarray(sess.finalize())


@pytest.mark.parametrize("reduce", ["psum", "scatter", "scatter_bf16"])
def test_incremental_session_on_mesh(mesh_run, jax_session, reduce):
    """Each rank polls its share of every delta, folds it, and stores its
    part of the volume: the assembled volume is within the bounds above
    of the JAX session, and the sink holds it, under the spec the JAX
    writer records for that layout."""
    _, _, vols, meta = mesh_run
    out = vols[f"incremental/{reduce}"]
    assert meta["polls"][reduce] == 4
    scale = float(np.max(np.abs(jax_session)))
    err = float(np.max(np.abs(out - jax_session)))
    if reduce == "scatter_bf16":
        assert err / scale < BF16_REDUCE_RTOL, f"{err / scale:.3e}"
    else:
        assert err < MAX_ABS, f"{reduce}: {err:.3e}"
    sink = VolumeSink(os.path.join(meta["work"], f"sink_{reduce}"))
    np.testing.assert_array_equal(sink.read().numpy(), out)
    spec = ["model"] if reduce == "psum" else ["model", "data"]
    assert json.loads(open(os.path.join(
        sink.path, "MANIFEST.json")).read())["spec"] == spec


def test_mesh_load_is_local_projections(mesh_run):
    """Every rank's ProjectionSource.load(mesh) is its local_projections of
    the whole array."""
    assert mesh_run[3]["load_is_local"]
