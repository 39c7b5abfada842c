"""The dry run (`repro_torch.launch.dryrun`) on fake worlds, against real
ranks.

A smoke-config prefill and train step of Qwen2-1.5B (B 4, S 16, 2
micro-batches) are dry-run on a fake (data 2, model 2) world. The same
cells run on 4 real gloo ranks (`_torch_launch_rank.py ... dryrun`) on
CPU tensors, on the card's path through the model, each counted by the
same dispatch mode: every rank's collectives (kind, group, count, bytes),
FLOPs and attention-operator calls equal the dry run's, which is rank 0
of its fake world. `torch.utils.flop_counter.FlopCounterMode` on the same
real rank counts more: it sees each DTensor operation at its global
size, so the dry run counts on local tensors instead. On one rank
without a mesh both counts agree.

A smoke FDK cell dry-runs on a fake (2, 2) world through the kernel's
launch operator; the paper's 4k cell on both production meshes through
the CLI. The fake world is gone after each dry run, and a dry run
refuses to start beside a real default process group.

The peak memory is a rank's: a meta tensor made inside the trace counts
nothing (it allocates nothing on a card), the rank's inputs count (an
FDK cell's projection share, though the cell describes it as a meta
tensor), and each rank embeds only its dp rows, so a prefill at one row
a rank peaks and communicates the same on a (2, 2) and a (4, 2) world.
"""
import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_smoke_config
from repro_torch.core.geometry import CBCTGeometry
from repro_torch.data.pipeline import TensorSpec
from repro_torch.device import fake_card
from repro_torch.kernels.backproject.kernel import backproject_ops
from repro_torch.launch import dryrun as D
from repro_torch.launch.cells import build_cell

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.abspath(os.path.join(HERE, "..", "src"))
sys.path.insert(0, os.path.join(HERE, "..", "benchmarks"))
sys.path.insert(0, HERE)

from _torch_launch_rank import CELLS, MB  # noqa: E402

DEADLINE_S = 180
SMALL = dict(nodes=2, gpus_per_node=2)
SHAPES_SMALL = {"train_4k": dict(kind="train", seq=16, batch=4),
                "prefill_32k": dict(kind="prefill", seq=16, batch=4),
                "decode_32k": dict(kind="decode", seq=32, batch=4)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The real ranks (started first, in the background) and the dry
    runs of the same cells (in this process, meanwhile)."""
    work = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_launch_rank.py"), str(r),
         "4", str(work / "pg"), str(work), "dryrun"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    cfg = get_smoke_config("qwen2_1_5b")
    rows = {}
    with open(work / "dryrun.jsonl", "w") as out:
        for name, (shape, info) in CELLS.items():
            rows[name] = D.run_cell("qwen2_1_5b", shape, False, out,
                                    verbose=False, cfg=cfg, shape_info=info,
                                    microbatches=MB, **SMALL)
    for r, proc in enumerate(procs):
        try:
            log = proc.communicate(timeout=DEADLINE_S)[0]
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        assert proc.returncode == 0, f"rank {r}:\n{log[-3000:]}"
    real = [json.loads((work / f"real_{r}.json").read_text())
            for r in range(4)]
    return work, rows, real


@pytest.mark.parametrize("cell", list(CELLS))
def test_collectives_match_real_ranks(runs, cell):
    _, rows, real = runs
    want = rows[cell]["collectives"]["by_group"]
    assert want, "the sharded cell moved nothing"
    for r, rep in enumerate(real):
        assert rep[cell]["by_group"] == want, r


@pytest.mark.parametrize("cell", list(CELLS))
def test_flops_per_rank_match_real_ranks(runs, cell):
    """Per-rank FLOPs and kernel calls equal a real rank's counted the
    same way; FlopCounterMode on that rank counts DTensor operations at
    their global size, so it counts more."""
    _, rows, real = runs
    row = rows[cell]
    for rep in real:
        assert rep[cell]["flops"] == row["traced_flops_per_dev"]
        assert rep[cell]["kernel_calls"] == row["kernel_calls"]
        assert rep[cell]["flop_counter_mode"] > rep[cell]["flops"]
    layers = get_smoke_config("qwen2_1_5b").num_layers
    calls = layers if cell == "prefill" else layers * MB * 2   # + remat
    assert row["kernel_calls"] == {"flash_attention": calls}
    assert row["hlo_flops_per_dev"] == row["traced_flops_per_dev"]


@pytest.mark.parametrize("cell", list(CELLS))
def test_rows_carry_the_roofline_and_memory(runs, cell):
    _, rows, _ = runs
    row = rows[cell]
    assert row["status"] == "ok" and row["mesh"] == "2x2"
    assert row["chips"] == 4 and row["peak_mem_bytes"] > 0
    assert row["dominant"] in ("compute", "memory", "collective")
    assert row["wire_bytes_per_dev"] > 0
    assert row["t_collective_s"] > 0 and row["t_compute_s"] > 0


def test_roofline_table_renders_the_dry_run(runs):
    import roofline_table

    work, _, _ = runs
    table = roofline_table.render(str(work / "dryrun.jsonl")).splitlines()
    assert len(table) == 2 + len(CELLS)
    assert all(line.startswith("| qwen2_1_5b |") for line in table[2:])


def test_the_fake_world_is_torn_down_and_refuses_a_real_one(tmp_path):
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="default process group"):
            D.run_cell("qwen2_1_5b", "prefill_32k", False, verbose=False,
                       **SMALL)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("shape", ["prefill_32k", "train_4k"])
def test_one_rank_counts_equal_flop_counter_mode(shape):
    """Without a mesh the dry run's count is FlopCounterMode's on the same
    fake run."""
    cfg = get_smoke_config("qwen2_1_5b")
    info = dict(CELLS["prefill" if shape == "prefill_32k" else "train"][1])
    row = D.run_cell("qwen2_1_5b", shape, False, verbose=False, cfg=cfg,
                     shape_info=info, microbatches=MB, single=True)
    assert row["mesh"] == "1" and row["collectives"]["by_group"] == {}
    cell = build_cell("qwen2_1_5b", shape, None, cfg=cfg, shape_info=info,
                      microbatches=MB)
    with FakeTensorMode(), fake_card(), D._propagation_apart():
        inputs = [D.local_inputs(a, s) for a, s in
                  zip(cell.args, cell.in_shardings)]
        with FlopCounterMode(display=False) as fc:
            cell.fn(*inputs)
    assert fc.get_total_flops() == row["traced_flops_per_dev"] > 0


def test_fdk_cell_on_a_fake_mesh():
    """The smoke FDK cell through the kernels' launch operators (the
    filter's and the back-projector's, once per micro-batch each): its count
    per rank is the kernel's formula for the rank's projections and slab
    (each micro-batch's call), gathered over `model`, reduce-scattered
    over `data`."""
    n, n_proj = 32, 64
    g = CBCTGeometry(n_proj=n_proj, n_u=32, n_v=32, d_u=2 * 2.4 / 32,
                     d_v=2 * 2.4 / 32, d=4.0, dsd=8.0, n_x=n, n_y=n, n_z=n,
                     d_x=2.0 / n, d_y=2.0 / n, d_z=2.0 / n)
    row = D.run_fdk(False, "4k", fdk_impl="pipelined", n_steps=2,
                    impl="kernel", geometry=g, verbose=False, **SMALL)
    # R = 2 slabs of n/2 x-planes, C = 2 column groups of n_proj/2
    assert row["traced_flops_per_dev"] == backproject_ops(
        n_proj // 2, n // 2, n, n)
    assert row["kernel_calls"] == {"backproject_dual": 2, "filter_rows": 2}
    groups = row["collectives"]["by_group"]
    assert set(groups) == {"all-gather x2", "reduce-scatter x2 across nodes"}
    # the rank's n_proj / 4 projections (an input) beside its slab
    assert row["peak_mem_bytes"] >= (n // 2 * n * n
                                     + n_proj // 4 * 32 * 32) * 4
    assert not dist.is_initialized()


def test_inputs_count_and_meta_tensors_made_inside_count_nothing():
    """A cell that makes a 4 GiB meta tensor inside the trace (as a
    cache's layout or a stride's witness did) reports the peak of one
    that makes none; a real tensor of that size counts, and so does an
    input described by a meta tensor (the FDK cell's projections), once
    it is the rank's local part."""
    n = 2**30

    def cell(make):
        def fn(x):
            extra = make()
            out = x * 2
            del extra
            return out
        return fn

    spec = TensorSpec((256,), torch.float32)
    peaks = {name: D.trace(cell(make), (spec,), (None,))["peak_bytes"]
             for name, make in (
                 ("none", lambda: None),
                 ("meta", lambda: torch.empty(n, device="meta")),
                 ("real", lambda: torch.empty(n)))}
    assert peaks["meta"] == peaks["none"] == 2 * 256 * 4
    assert peaks["real"] == peaks["none"] + 4 * n
    proj = torch.empty((8, 32, 32), device="meta")
    assert D.trace(lambda p: None, (proj,), (None,))["peak_bytes"] \
        == 8 * 32 * 32 * 4


def test_prefill_rank_peak_does_not_grow_with_the_global_batch():
    """One row a rank of the smoke prefill on fake (2, 2) and (4, 2)
    worlds: each rank embeds its own row (the batch laid out over data),
    so its peak and its collectives are the same on both; when every rank
    looked up the whole batch both grew with it."""
    cfg = get_smoke_config("qwen2_1_5b")
    rows = [D.run_cell("qwen2_1_5b", "prefill_32k", False, verbose=False,
                       cfg=cfg, shape_info=dict(kind="prefill", seq=16,
                                                batch=data),
                       nodes=data, gpus_per_node=2) for data in (2, 4)]
    assert [r["mesh"] for r in rows] == ["2x2", "4x2"]
    assert rows[0]["peak_mem_bytes"] == rows[1]["peak_mem_bytes"] > 0
    groups = rows[0]["collectives"]["by_group"]
    assert groups and groups == rows[1]["collectives"]["by_group"]


def test_cli_dry_runs_the_paper_cell_on_both_production_meshes(tmp_path):
    out = tmp_path / "fdk.jsonl"
    assert D.main(["--fdk", "--fdk-problem", "4k", "--both-meshes",
                   "--bp-impl", "kernel", "--out", str(out)]) == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["mesh"] for r in rows] == ["32x8", "2x32x8"]
    assert [r["chips"] for r in rows] == [256, 512]
    for r in rows:
        assert r["arch"] == "ifdk-4k" and r["traced_flops_per_dev"] > 0
        assert r["wire_bytes_per_dev"] > 0 and r["peak_mem_bytes"] > 0


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "jamba_1_5_large",
                                  "mamba2_130m"])
def test_long_context_decode_cells_trace(arch):
    """long_500k's layout at smoke size (a batch of one, the cache's
    sequence over the data axis) on a fake (2, 2) world. The MoE's
    explicit reshards put the batch of one over the data axis of two,
    leaving a rank none of it, which DTensor's view rules refused, until
    `constrain_p` dropped the axes that would leave a rank empty."""
    info = dict(kind="decode", seq=64, batch=1, long=True)
    row = D.run_cell(arch, "long_500k", False, verbose=False,
                     cfg=get_smoke_config(arch), shape_info=info, **SMALL)
    assert row["status"] == "ok" and row["peak_mem_bytes"] > 0


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_audio_cells_trace(shape):
    """MusicGen's cells at smoke size on a fake (2, 2) world: the audio
    head's reshape merges the data-sharded batch into a strided shard,
    whose local size DTensor reads from an index tensor; in the dry run
    that tensor was fake and holds no values, until `_propagation_apart`
    ran that sizing on real tensors."""
    kind = SHAPES_SMALL[shape]
    row = D.run_cell("musicgen_large", shape, False, verbose=False,
                     cfg=get_smoke_config("musicgen_large"), shape_info=kind,
                     microbatches=MB, **SMALL)
    assert row["status"] == "ok" and row["traced_flops_per_dev"] > 0
