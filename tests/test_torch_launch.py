"""Port parity for the launcher's pure parts: `repro_torch.launch.roofline`
and `repro_torch.launch.cells` against `repro.launch.roofline` and
`repro.launch.cells`.

For all ten configs and the four shapes: the analytic FLOPs per token,
the model FLOPs, the analytic per-rank costs at the reference's tp=16
with each strategy flag, and the Roofline terms times their constants
(the FLOPs, bytes and wire bytes they price) equal the reference's to
1e-12 relative; input specs, applicability, the rules' fields (at the
reference's 8 GB serving budget on a (16, 16) mesh) and the micro-batch
depths are the same. `benchmarks/roofline_table.render` renders rows the
port writes. The H100 constants are the datasheet's.
"""
import json
import os
import sys

import numpy as np
import pytest

from repro import configs as jconfigs
from repro.launch import cells as jcells
from repro.launch import roofline as jroof
from repro.models import config as jconfig
from repro_torch import configs as tconfigs
from repro_torch.launch import cells as tcells
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import roofline as troof
from repro_torch.models import config as tconfig
from repro_torch.parallel.sharding import AbstractMesh

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "benchmarks"))

REL = 1e-12
ARCHS = jconfigs.list_archs()
SHAPES = list(jcells.SHAPES)
FLAGS = [dict(fsdp=True, zero3_gather=True, moe_ep=False),
         dict(fsdp=True, zero3_gather=True, moe_ep=True),
         dict(fsdp=True, zero3_gather=False, moe_ep=False),
         dict(fsdp=False, zero3_gather=True, moe_ep=False)]


def same(a, b):
    assert a == pytest.approx(b, rel=REL, abs=0.0), (a, b)


def test_the_two_packages_list_the_same_configs_and_shapes():
    assert tconfigs.list_archs() == ARCHS
    assert tcells.SHAPES == jcells.SHAPES
    assert tcells.TRAIN_MICROBATCHES == jcells.TRAIN_MICROBATCHES


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_flops_and_costs_match_the_reference(arch):
    jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for s_kv, decode in ((1.0, False), (2048.5, False), (32768, True)):
        same(troof.forward_flops_per_token(tc, s_kv, decode),
             jroof.forward_flops_per_token(jc, s_kv, decode))
    n = jconfig.count_params(jc)
    assert tconfig.count_params(tc) == n
    for shape in SHAPES:
        info = jcells.SHAPES[shape]
        same(troof.model_flops_for(tc, info, tconfig.count_active_params(tc)),
             jroof.model_flops_for(jc, info, jconfig.count_active_params(jc)))
        for chips, mb, remat in ((256, 8, True), (512, 1, False)):
            for flags in FLAGS:
                got = troof.analytic_costs(tc, info, chips, n, mb, remat,
                                           tp=16, **flags)
                want = jroof.analytic_costs(jc, info, chips, n, mb, remat,
                                            tp=16, **flags)
                same(got.flops_per_dev, want.flops_per_dev)
                same(got.hbm_bytes_per_dev, want.hbm_bytes_per_dev)


@pytest.mark.parametrize("arch", ARCHS)
def test_roofline_terms_match_the_reference(arch):
    """Each term times its constant is what it prices; ratios that hold
    no constant are equal; the rows have the reference's keys."""
    jc = jconfigs.get_config(arch)
    for shape in SHAPES:
        info = jcells.SHAPES[shape]
        ac = jroof.analytic_costs(jc, info, 256, jconfig.count_params(jc))
        mf = jroof.model_flops_for(jc, info,
                                   jconfig.count_active_params(jc))
        kw = dict(arch=arch, shape=shape, mesh="16x16", chips=256,
                  hlo_flops=ac.flops_per_dev, hlo_bytes=ac.hbm_bytes_per_dev,
                  wire_bytes=3.5e9, model_flops=mf, peak_mem_bytes=1e9)
        j, t = jroof.Roofline(**kw), troof.Roofline(**kw)
        same(t.t_compute * troof.PEAK_FLOPS, j.t_compute * jroof.PEAK_FLOPS)
        same(t.t_memory * troof.HBM_BW, j.t_memory * jroof.HBM_BW)
        same(t.t_collective * troof.NET_BW,
             j.t_collective * jroof.ICI_LINK_BW)
        same(t.useful_ratio, j.useful_ratio)
        assert set(t.row()) == set(j.row())
        on_nvlink = troof.Roofline(**kw, nvlink_wire_bytes=3.5e9)
        same(on_nvlink.t_collective * troof.NVLINK_BW, 3.5e9)
        assert t.bound_time == max(t.t_compute, t.t_memory, t.t_collective)


def test_collective_stats_ring_factors_match_the_reference():
    j, t = jroof.CollectiveStats(), troof.CollectiveStats()
    for kind, nbytes, g, mult in (("all-gather", 4096.0, 8, 1.0),
                                  ("all-reduce", 1000.0, 32, 3.0),
                                  ("reduce-scatter", 777.0, 2, 1.0),
                                  ("all-to-all", 64.0, 4, 2.0),
                                  ("collective-permute", 10.0, 2, 1.0)):
        j.add(kind, nbytes, g, mult)
        t.add(kind, nbytes, g, mult, intra_node=kind != "all-reduce")
    same(t.wire_bytes, j.wire_bytes)
    assert t.op_bytes == j.op_bytes and t.op_count == j.op_count
    same(t.nvlink_wire_bytes, j.wire_bytes - 2 * 31 / 32 * 1000.0 * 3.0)


def test_h100_constants_are_the_datasheet_figures():
    assert troof.PEAK_FLOPS == 989.4e12 and troof.HBM_BW == 3.35e12
    assert troof.NVLINK_BW == 450e9 and troof.NET_BW == 50e9
    assert tmesh.production_shape() == ((32, 8), ("data", "model"))
    assert tmesh.production_shape(multi_node_groups=2) == (
        (2, 32, 8), ("pod", "data", "model"))
    assert [np.prod(tmesh.production_shape(multi_node_groups=g)[0])
            for g in (1, 2)] == [256, 512]


@pytest.mark.parametrize("arch", ARCHS)
def test_cells_match_the_reference(arch):
    """Input specs (names, shapes, dtypes), the skip reasons, the rules'
    fields for both strategies and the micro-batch depths."""
    jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
    mesh = AbstractMesh((16, 16), ("data", "model"))
    for shape in SHAPES:
        assert tcells.cell_is_applicable(tc, shape) == \
            jcells.cell_is_applicable(jc, shape)
        js, ts = jcells.input_specs(jc, shape), tcells.input_specs(tc, shape)
        assert sorted(js) == sorted(ts)
        for k in js:
            assert tuple(ts[k].shape) == tuple(js[k].shape)
            assert str(ts[k].dtype).removeprefix("torch.") == \
                str(np.dtype(js[k].dtype))
        for strategy in ("baseline", "optimized"):
            jr = jcells.make_rules(jc, shape, None, strategy)
            tr = tcells.make_rules(tc, shape, mesh, strategy,
                                   hbm_budget=8e9)
            for field in ("fsdp", "zero3_gather", "gather_moe_experts",
                          "decode_feature_shard", "sequence_parallel",
                          "fsdp_axes"):
                assert getattr(tr, field) == getattr(jr, field), field
    for strategy in ("baseline", "optimized"):
        assert tcells.strategy_microbatches(tc, strategy) == \
            jcells.strategy_microbatches(jc, strategy)
    assert tcells.inference_fsdp(tc, 16, 8e9) == jcells.inference_fsdp(jc)


def test_serving_budget_defaults_to_half_a_card():
    """Without a card the budget is half the 80 GB datasheet figure, and
    the TP degree is the mesh's model axis (8 on an H100 node)."""
    big = tconfigs.get_config("jamba_1_5_large")
    n = tconfig.count_params(big)
    assert tcells.card_memory_bytes() == troof.HBM_BYTES
    assert tcells.inference_fsdp(big) == (n * 2.0 / 8 > 40e9)
    rules = tcells.make_rules(big, "decode_32k",
                              AbstractMesh((32, 8), ("data", "model")))
    assert rules.fsdp == (n * 2.0 / 8 > 40e9)


def test_roofline_table_renders_port_rows(tmp_path):
    """The unchanged `benchmarks/roofline_table.py` renders rows the port
    writes: one traced cell and one skipped."""
    import roofline_table

    rl = troof.Roofline(arch="qwen2_1_5b", shape="train_4k", mesh="32x8",
                        chips=256, hlo_flops=1e13, hlo_bytes=1e11,
                        wire_bytes=4e10, nvlink_wire_bytes=1e10,
                        model_flops=2e15, peak_mem_bytes=3e10)
    path = tmp_path / "dryrun.jsonl"
    with open(path, "w") as f:
        f.write(json.dumps({"status": "ok", **rl.row()}) + "\n")
        f.write(json.dumps({"arch": "yi_6b", "shape": "long_500k",
                            "mesh": "32x8", "status": "skipped",
                            "reason": "pure full-attention arch"}) + "\n")
    table = roofline_table.render(str(path)).splitlines()
    assert len(table) == 4
    assert table[2].startswith("| qwen2_1_5b | train_4k | 32x8 | ")
    assert f"| {rl.dominant} |" in table[2] and rl.dominant == "collective"
    assert "SKIP" in table[3]


def test_launcher_and_checkpoints_import_neither_jax_nor_repro():
    """In a fresh interpreter where `jax` and `repro` cannot be imported,
    the launcher's modules and the checkpoints import, and pull in
    neither."""
    import subprocess

    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch.launch.cells, repro_torch.launch.dryrun\n"
        "import repro_torch.launch.mesh, repro_torch.launch.roofline\n"
        "import repro_torch.checkpoint, repro_torch.checkpoint.io\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and\n"
        "       (m.split('.')[0] in ('jax', 'jaxlib', 'repro'))]\n"
        "assert not bad, bad\n")
    src = os.path.abspath(os.path.join(HERE, "..", "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=src),
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
