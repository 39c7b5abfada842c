"""Port parity for `repro_torch.core.distributed`, `core/pipeline.py`,
`parallel/mesh.py` and the mesh half of `core/plan.py`, in this process.

The grid rules (`choose_grid`, `grid_candidates`, `bp_call_shape`) against
the JAX functions over a sweep, error messages included. On a (1, 1, 1)
gloo mesh over a world of one, the gather and the reduce are identities,
so every schedule under psum and scatter is bit-equal to `mesh=None`, and
scatter_bf16 is one bf16 rounding away; the chunked error-feedback test is
tests/test_plan.py's. The streaming session, the I/O engine (each rank's
rows read, its part stored under the reference's spec) and the batched
engine on the same mesh are bit-equal to `mesh=None` too. Multi-rank
parity is tests/test_torch_mesh.py.
"""
import dataclasses
import datetime
import warnings

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import distributed as jdist
from repro.core import geometry as jgeo
from repro.core import phantom as jph
from repro.core import plan as jplan
from repro_torch import io as tio
from repro_torch.core import distributed as tdist
from repro_torch.core import fdk as tfdk
from repro_torch.core import pipeline as tpipe
from repro_torch.core import plan as tplan
from repro_torch.core.geometry import CBCTGeometry
from repro_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

AXES = ("pod", "data", "model")
BF16_REDUCE_RTOL = 4 * 2.0 ** -8   # tests/test_plan.py TestStreamCodecPlans
SCHEDULES = {"fused": {}, "pipelined": {"n_steps": 2},
             "chunked": {"n_steps": 2, "y_chunks": 4}}
JG = jgeo.default_geometry(16, n_proj=32)
G = CBCTGeometry(**dataclasses.asdict(JG))


@pytest.fixture(scope="module")
def proj():
    return np.array(jph.forward_project(JG))


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """A (1, 1, 1) (pod, data, model) mesh over a gloo world of one."""
    init = tmp_path_factory.mktemp("pg") / "init"
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield tmesh.make_mesh((1, 1, 1), AXES, device_type="cpu")
    finally:
        tplan.clear_engine_cache()
        dist.destroy_process_group()


def run(plan, proj):
    """The plan's output on this rank, assembled into (N_x, N_y, N_z)."""
    out = plan.build()(tdist.local_projections(proj, plan.mesh)
                       if plan.mesh is not None else proj)
    if plan.mesh is not None:
        out = tdist.assemble_volume(out, plan.mesh, plan.reduce)
    return out.reshape(G.volume_shape())


# -- the paper's grid rule ---------------------------------------------------

GRID_SIZES = (16, 64, 96, 256, 512, 1024, 2048, 4096)
GRID_DEVICES = (1, 2, 3, 4, 6, 8, 12, 16, 32, 64, 256, 2048)
GRID_BUDGETS = [{}, {"sub_vol_bytes": 256 * 1024},
                {"hbm_bytes": 2**20}, {"hbm_bytes": 2**34,
                                       "sub_vol_bytes": 2**26}]


def _outcome(fn, *args, **kwargs):
    try:
        grid = fn(*args, **kwargs)
    except ValueError as e:
        return "error", str(e)
    return "grid", (grid.r, grid.c)


@pytest.mark.parametrize("budget", GRID_BUDGETS,
                         ids=["default", "small_slab", "tiny_hbm", "mixed"])
def test_choose_grid_matches_reference(budget):
    """Same grid or the same ValueError, word for word, over the sweep;
    every error branch is reached somewhere in it."""
    messages = set()
    for n in GRID_SIZES:
        jg = jgeo.default_geometry(n)
        tg = CBCTGeometry(**dataclasses.asdict(jg))
        for n_dev in GRID_DEVICES:
            want = _outcome(jdist.choose_grid, jg, n_dev, **budget)
            assert _outcome(tdist.choose_grid, tg, n_dev, **budget) == want
            if want[0] == "error":
                messages.add(want[1].split(" ")[0])
    if budget == {"sub_vol_bytes": 256 * 1024}:
        assert {"memory", "volume"} <= messages
    if budget == {"hbm_bytes": 2**20}:
        assert "detector" in messages


def test_choose_grid_error_for_untileable_volume():
    jg = jgeo.default_geometry(24)
    tg = CBCTGeometry(**dataclasses.asdict(jg))
    kw = {"sub_vol_bytes": 4 * 24 ** 3 // 16}
    want = _outcome(jdist.choose_grid, jg, 64, **kw)
    assert want[0] == "error" and "does not tile N_x=24" in want[1]
    assert _outcome(tdist.choose_grid, tg, 64, **kw) == want


def test_paper_grid_rule():
    """R = 32, C = 8 for 4096^3 on 256 GPUs of 16 GB (paper §4.1.5)."""
    g = CBCTGeometry(**dataclasses.asdict(jgeo.default_geometry(4096)))
    assert tdist.choose_grid(g, 256) == tdist.IFDKGrid(r=32, c=8)


def test_grid_candidates_match_reference():
    for n, n_proj in ((16, 32), (24, 36), (48, 60), (64, 64)):
        jg = jgeo.default_geometry(n, n_proj=n_proj)
        tg = CBCTGeometry(**dataclasses.asdict(jg))
        for n_dev in range(1, 17):
            want = [(c.r, c.c) for c in jdist.grid_candidates(jg, n_dev)]
            assert [(c.r, c.c) for c in tdist.grid_candidates(tg, n_dev)] \
                == want


def test_bp_call_shape_and_wire_tables_match_reference():
    for r, c, sched, steps, yc in [(1, 1, "fused", 1, None),
                                   (2, 4, "pipelined", 2, None),
                                   (2, 4, "chunked", 2, 4),
                                   (4, 2, "chunked", 4, 8)]:
        assert tplan.bp_call_shape(G, r, c, sched, steps, yc) == \
            jplan.bp_call_shape(JG, r, c, sched, steps, yc)
    assert tdist.SCATTER_REDUCES == jdist.SCATTER_REDUCES
    assert tdist.REDUCE_WIRE_ITEMSIZE == jdist.REDUCE_WIRE_ITEMSIZE


# -- the engine on a (1, 1, 1) mesh -------------------------------------------

@pytest.mark.parametrize("reduce", ["psum", "scatter"])
@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("impl", ["factorized", "kernel"])
def test_mesh_1x1x1_is_bit_equal_to_no_mesh(mesh, proj, impl, schedule,
                                            reduce):
    kw = dict(geometry=G, impl=impl, schedule=schedule, device="cpu",
              **SCHEDULES[schedule])
    want = tplan.ReconstructionPlan(**kw).build()(proj)
    got = run(tplan.ReconstructionPlan(mesh=mesh, reduce=reduce, **kw), proj)
    assert torch.equal(got, want)


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_scatter_bf16_matches_f32_psum(mesh, proj, schedule):
    kw = dict(geometry=G, mesh=mesh, schedule=schedule, device="cpu",
              **SCHEDULES[schedule])
    f32 = run(tplan.ReconstructionPlan(reduce="psum", **kw), proj)
    out = run(tplan.ReconstructionPlan(reduce="scatter_bf16", **kw), proj)
    rel = float((out - f32).abs().max() / f32.abs().max())
    assert 0 < rel < BF16_REDUCE_RTOL, f"{schedule}: {rel:.3e}"


@pytest.mark.parametrize("n_steps", [2, 4])
def test_chunked_error_feedback_beats_naive_requantize(mesh, proj, n_steps):
    """The f32 error-feedback carry keeps the chunked multi-round reduce
    within the ONE-round bf16 bound of the f32 oracle: n_steps roundings
    do not pile up (tests/test_plan.py)."""
    oracle = np.asarray(jplan.ReconstructionPlan(geometry=JG).build()(proj))
    chunked = run(tplan.ReconstructionPlan(
        geometry=G, mesh=mesh, schedule="chunked", n_steps=n_steps,
        y_chunks=4, reduce="scatter_bf16", device="cpu"), proj).numpy()
    scale = float(np.max(np.abs(oracle))) + 1e-12
    rmse = float(np.sqrt(np.mean((chunked - oracle) ** 2))) / scale
    assert rmse < BF16_REDUCE_RTOL, f"rmse {rmse:.3e}"


@pytest.mark.parametrize("n_steps", [4, 8])
def test_chunked_carry_is_what_keeps_the_error_down(mesh, proj, n_steps):
    """With the carry only the last round's rounding survives, a rounding
    of a partial about 1/n_steps of the volume; without it the n_steps
    roundings add up like a random walk, about 1/sqrt(n_steps) of one
    fused rounding (0.63 and 0.57 of it at 4 and 8 steps with the carry
    removed, against 0.31 and 0.20 with it). The RMS error against the f32
    psum must stay under 0.8/sqrt(n_steps) of the fused scatter_bf16's."""
    kw = dict(geometry=G, mesh=mesh, device="cpu")
    f32 = run(tplan.ReconstructionPlan(**kw), proj)
    fused = run(tplan.ReconstructionPlan(reduce="scatter_bf16", **kw), proj)
    chunked = run(tplan.ReconstructionPlan(
        schedule="chunked", n_steps=n_steps, y_chunks=4,
        reduce="scatter_bf16", **kw), proj)

    def rmse(x):
        return float(((x - f32) ** 2).mean().sqrt())
    assert rmse(chunked) < 0.8 / n_steps ** 0.5 * rmse(fused)


def test_collectives_move_the_wire_bytes(mesh, proj):
    """The column AllGather moves the codec's wire bytes (and the scale
    sidecar of fp8 and of fp16's scale-on-overflow), not P, which each rank
    slices from the geometry; psum all-reduces the f32 slab over pod and
    data; scatter_bf16 reduce-scatters it at 2 bytes an element."""
    vol = G.n_x * G.n_y * G.n_z
    cases = [("fp32", "psum", 4, 0, 2 * 4 * vol, 0),
             ("fp8_e4m3", "psum", 1, 4 * G.n_proj, 2 * 4 * vol, 0),
             ("fp16", "scatter_bf16", 2, 4 * G.n_proj, 4 * vol, 2 * vol)]
    for codec, reduce, item, sidecar, ar, rs in cases:
        fn = tplan.ReconstructionPlan(geometry=G, mesh=mesh, precision=codec,
                                      reduce=reduce, device="cpu").build()
        before = dict(fn.collectives.bytes)   # the engine may be cached
        fn(tdist.local_projections(proj, mesh))
        moved = {k: v - before[k] for k, v in fn.collectives.bytes.items()}
        assert moved == {
            "all_gather": item * G.n_proj * G.n_v * G.n_u + sidecar,
            "all_reduce": ar, "reduce_scatter": rs}


def test_single_device_mesh_runs_the_engine(mesh, proj):
    one = tmesh.single_device_mesh(device_type="cpu")
    assert one.mesh_dim_names == ("data", "model") and tuple(one.shape) == \
        (1, 1)
    plan = tplan.ReconstructionPlan(geometry=G, mesh=one, reduce="scatter",
                                    device="cpu")
    assert plan.grid == tdist.IFDKGrid(1, 1)
    assert plan.describe()["grid"] == (1, 1)
    want = tplan.ReconstructionPlan(geometry=G, device="cpu").build()(proj)
    assert torch.equal(run(plan, proj), want)


# -- streaming, I/O and batched engines on the (1, 1, 1) mesh ----------------

@pytest.mark.parametrize("codec", [None, "fp8_e4m3"])
def test_mesh_load_is_local_projections(mesh, proj, tmp_path, codec):
    """ProjectionSource.load(mesh) and load_slice(lo, hi, mesh) give this
    rank exactly the rows local_projections gives it, decoded."""
    src = tio.ProjectionSource.write(str(tmp_path / "p"), proj,
                                     chunks=(4, 1, 1), codec=codec)
    whole = src.load(device="cpu")
    assert torch.equal(src.load(mesh, device="cpu"),
                       tdist.local_projections(whole, mesh))
    assert torch.equal(src.load_slice(8, 16, mesh, device="cpu"),
                       tdist.local_projections(whole[8:16], mesh))


def fold_session(plan, proj, n_deltas=4, session=None):
    sess = plan.build_incremental() if session is None else session
    step = G.n_proj // n_deltas
    for lo in range(0, G.n_proj, step):
        delta = proj[lo:lo + step]
        if plan.mesh is not None:
            delta = tdist.local_projections(delta, plan.mesh)
        sess.update(delta, (lo, lo + step))
    return sess.finalize()


@pytest.mark.parametrize("impl,reduce", [("kernel", "psum"),
                                         ("kernel", "scatter"),
                                         ("factorized", "psum")])
def test_mesh_session_is_bit_equal_to_no_mesh(mesh, proj, impl, reduce):
    kw = dict(geometry=G, impl=impl, schedule="incremental", n_steps=4,
              device="cpu")
    want = fold_session(tplan.ReconstructionPlan(**kw), proj)
    plan = tplan.ReconstructionPlan(mesh=mesh, reduce=reduce, **kw)
    got = tdist.assemble_volume(fold_session(plan, proj), mesh, reduce)
    assert torch.equal(got, want)


@pytest.mark.parametrize("impl,reduce", [("kernel", "scatter"),
                                         ("factorized", "psum")])
def test_mesh_traced_engines_are_bit_equal_to_no_mesh(mesh, proj, impl,
                                                      reduce):
    """build_traced and the traced session on the (1, 1, 1) mesh: each
    rank's un-reduced partial crosses the stage seams as a plain tensor,
    and the volume is bit-equal to mesh=None's traced run."""
    kw = dict(geometry=G, impl=impl, device="cpu")
    want = tplan.ReconstructionPlan(**kw).build_traced()(proj)
    plan = tplan.ReconstructionPlan(mesh=mesh, reduce=reduce, **kw)
    got = plan.build_traced()(tdist.local_projections(proj, mesh))
    assert torch.equal(tdist.assemble_volume(got, mesh, reduce), want)
    kw.update(schedule="incremental", n_steps=4)
    sessions = [tplan.ReconstructionPlan(**kw).build_traced(),
                tplan.ReconstructionPlan(mesh=mesh, reduce=reduce,
                                         **kw).build_traced()]
    want, got = (fold_session(s.plan, proj, session=s) for s in sessions)
    assert torch.equal(tdist.assemble_volume(got, mesh, reduce), want)
    assert set(sessions[1].stage_seconds()) >= {
        "stage.filter", "stage.allgather", "stage.backproject"}


def test_mesh_session_scatter_bf16_within_one_rounding(mesh, proj):
    kw = dict(geometry=G, mesh=mesh, schedule="incremental", n_steps=4,
              device="cpu")
    f32 = fold_session(tplan.ReconstructionPlan(**kw), proj)
    out = tdist.assemble_volume(fold_session(tplan.ReconstructionPlan(
        reduce="scatter_bf16", **kw), proj), mesh, "scatter_bf16")
    rel = float((out - f32).abs().max() / f32.abs().max())
    assert 0 < rel < BF16_REDUCE_RTOL, f"{rel:.3e}"


@pytest.mark.parametrize("schedule,reduce,spec,layout", [
    ("fused", "psum", ["model"], None),
    ("fused", "scatter", ["model", "data"], None),
    ("chunked", "scatter", ["model", None, "data", None],
     {"kind": "y_chunk_major", "y_chunks": 4})])
def test_mesh_build_with_source_and_sink(mesh, proj, tmp_path, schedule,
                                         reduce, spec, layout):
    """build(source=, sink=) on the mesh: the rank reads its rows, stores
    its part under the spec the JAX writer records for that layout, and
    the sink reads back the canonical volume."""
    plan = tplan.ReconstructionPlan(geometry=G, mesh=mesh, schedule=schedule,
                                    reduce=reduce, device="cpu",
                                    **SCHEDULES[schedule])
    assert plan.output_spec() == spec
    src = tio.ProjectionSource.write(str(tmp_path / "p"), proj)
    sink = tio.VolumeSink(str(tmp_path / "v"))
    local = plan.build(source=src, sink=sink)()
    assert tio.stored_spec(sink.path) == spec and sink.layout() == layout
    want = tplan.ReconstructionPlan(geometry=G, schedule=schedule,
                                    device="cpu",
                                    **SCHEDULES[schedule]).build()(proj)
    assert torch.equal(sink.read(), want)
    assert torch.equal(tdist.assemble_volume(local, mesh, reduce).reshape(
        G.volume_shape()), want)


def test_mesh_batched_lanes_bit_equal(mesh, proj):
    plan = tplan.ReconstructionPlan(geometry=G, mesh=mesh, reduce="scatter",
                                    device="cpu")
    local = tdist.local_projections(proj, mesh)
    out = plan.build_batched(2)(np.stack([local, 2 * local]))
    fn = plan.build()
    assert torch.equal(out[0], fn(local)) and torch.equal(out[1],
                                                          fn(2 * local))


def test_mesh_helpers(mesh):
    assert tmesh.dp_axes(mesh) == ("pod", "data")
    assert tmesh.axis_size(mesh, "pod", "data", "model", "absent") == 1
    assert tdist.mesh_index(mesh) == 0
    x = np.arange(12).reshape(12, 1)
    np.testing.assert_array_equal(tdist.local_projections(x, mesh), x)


def test_engine_is_cached_per_plan_and_mesh(mesh):
    plan = tplan.ReconstructionPlan(geometry=G, mesh=mesh, device="cpu")
    fn = plan.build()
    assert tplan.ReconstructionPlan(geometry=G, mesh=mesh,
                                    device="cpu").build() is fn
    with pytest.raises(ValueError, match=r"this rank's \(N_p/\(R\*C\)"):
        fn(np.zeros((3, G.n_v, G.n_u), np.float32))


VALIDATE_CASES = [
    ((1, 1), ("pod", "data"), {}, "lack the 'model' axis"),
    ((1,), ("model",), {"reduce": "scatter"},
     "needs a mesh with a 'data' axis"),
    ((1, 1), ("data", "model"),
     {"reduce": "scatter", "schedule": "chunked", "n_steps": 2,
      "y_chunks": 3}, "must divide into y_chunks=3"),
]


@pytest.mark.parametrize("shape,axes,kwargs,msg", VALIDATE_CASES,
                         ids=[m for *_, m in VALIDATE_CASES])
def test_validate_mesh_messages_match_reference(mesh, shape, axes, kwargs,
                                                msg):
    jmesh = jax.make_mesh(shape, axes)
    with pytest.raises(ValueError, match=msg):
        jplan.ReconstructionPlan(geometry=JG, mesh=jmesh, **kwargs).validate()
    tm = tmesh.make_mesh(shape, axes, device_type="cpu")
    with pytest.raises(ValueError, match=msg):
        tplan.ReconstructionPlan(geometry=G, mesh=tm, device="cpu",
                                 **kwargs).validate()


def test_mesh_must_be_a_device_mesh():
    with pytest.raises(TypeError, match="DeviceMesh"):
        tplan.ReconstructionPlan(geometry=G, mesh=object(), device="cpu")


def test_plan_from_reference_carries_the_mesh(mesh, proj):
    jmesh = jax.make_mesh((1, 1, 1), AXES)
    fields = {f.name: getattr(jplan.ReconstructionPlan(
        geometry=JG, mesh=jmesh, schedule="pipelined", n_steps=2,
        reduce="scatter"), f.name)
        for f in dataclasses.fields(jplan.ReconstructionPlan)}
    tp = tplan.plan_from_reference(fields, device="cpu", mesh=mesh)
    assert tp.mesh is mesh and (tp.schedule, tp.reduce) == \
        ("pipelined", "scatter")
    want = tplan.ReconstructionPlan(geometry=G, schedule="pipelined",
                                    n_steps=2, device="cpu").build()(proj)
    assert torch.equal(run(tp, proj), want)
    other = tmesh.make_mesh((1, 1), ("data", "model"), device_type="cpu")
    for port_mesh in (None, other):
        with pytest.raises(ValueError, match="is not the port's mesh"):
            tplan.plan_from_reference(fields, device="cpu", mesh=port_mesh)
    with pytest.raises(ValueError, match="is not the port's mesh"):
        tplan.plan_from_reference(dict(fields, mesh=None), device="cpu",
                                  mesh=mesh)


def test_plan_from_spec_takes_the_mesh(mesh):
    plan = tplan.plan_from_spec(G, "schedule=chunked,n_steps=2,y_chunks=4,"
                                "reduce=scatter_bf16", mesh=mesh,
                                device="cpu")
    assert plan.mesh is mesh and plan.validate().reduce == "scatter_bf16"
    assert plan.bp_call_shape() == (16, 4, 16)


def test_legacy_builders_are_the_plan(mesh, proj):
    local = tdist.local_projections(proj, mesh)
    tfdk._DEPRECATION_FIRED.clear()
    for build, kwargs in [
            (tdist.make_distributed_fdk, dict(schedule="fused",
                                              reduce="scatter")),
            (tpipe.make_pipelined_fdk, dict(schedule="pipelined", n_steps=4,
                                            reduce="scatter")),
            (tpipe.make_chunked_fdk, dict(schedule="chunked", n_steps=2,
                                          y_chunks=16, reduce="scatter"))]:
        with pytest.warns(DeprecationWarning, match="deprecated"):
            got = build(mesh, G, device="cpu")(local)
        with warnings.catch_warnings():
            warnings.simplefilter("error")   # warns once per process
            build(mesh, G, device="cpu")
        want = tplan.ReconstructionPlan(geometry=G, mesh=mesh, device="cpu",
                                        **kwargs).build()(local)
        assert torch.equal(got, want)
