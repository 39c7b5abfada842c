"""Port parity for the sharding rules: `repro_torch.parallel.sharding`
against `repro.parallel.sharding`, in one process and with no devices.

Both packages resolve their rules against a shape-only mesh (JAX's
`AbstractMesh`, the port's own) of four shapes: (data 1, model 1), (2, 2),
(4, 8) and (pod 2, data 16, model 16), with the reference's defaults and
each rules flag toggled. For all ten full configs the parameter specs
(`param_shardings`), the decode caches' specs (`cache_specs`, with and
without `shard_seq`) and the train state's (`state_shardings`) are the
reference's entry for entry, and each spec's DTensor placements put
`Shard(dim)` on exactly the mesh dims the spec names whose size is above 1
(a mesh dim of size 1 is `Replicate()`: every rank holds the whole tensor
dim either way). `abstract_params` and `make_abstract_state` give the
reference's shapes and dtypes.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh
from torch.distributed.tensor import Replicate, Shard

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.parallel import sharding as JS
from repro.training import train_step as JTS
from repro_torch import configs as tconfigs
from repro_torch.models import transformer as TT
from repro_torch.parallel import sharding as TS
from repro_torch.training import train_step as TTS

ARCHS = ["qwen2_1_5b", "deepseek_coder_33b", "yi_6b", "internlm2_20b",
         "qwen2_moe_a2_7b", "mixtral_8x7b", "jamba_1_5_large",
         "mamba2_130m", "internvl2_26b", "musicgen_large"]
MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "4x8": ((4, 8), ("data", "model")),
    "pod2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
FLAGS = {
    "defaults": {},
    "no_fsdp": {"fsdp": False},
    "sequence_parallel": {"sequence_parallel": True},
    "fsdp_over_model": {"fsdp_axes": ("pod", "data", "model")},
    "no_zero3_gather": {"zero3_gather": False},
    "gather_moe_experts": {"gather_moe_experts": True},
    "decode_feature_shard": {"decode_feature_shard": True},
}
CASES = [(m, f) for m in MESHES for f in FLAGS]


def _rules(mesh_name, flag_name):
    shape, axes = MESHES[mesh_name]
    kw = FLAGS[flag_name]
    return (JS.ShardingRules(mesh=JAbstractMesh(shape, axes), **kw),
            TS.ShardingRules(mesh=TS.AbstractMesh(shape, axes), **kw))


def _spec(spec, ndim):
    """A PartitionSpec as a tuple of ndim entries (JAX drops none, the
    reference's specs are full length; an empty P() is all None)."""
    out = tuple(spec)
    return out + (None,) * (ndim - len(out))


def _flat(tree, prefix=()):
    """{path: leaf} of nested dicts / NamedTuples, in sorted key order."""
    if hasattr(tree, "_fields") and not isinstance(tree, TS.Sharding):
        tree = tree._asdict()
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in _flat(tree[key], prefix + (key,)).items()}
    return {prefix: tree}


def _check_sharding(ref_sharding, got: TS.Sharding, shape, mesh_axes):
    """The port's Sharding has the reference's spec as placements."""
    spec = _spec(ref_sharding.spec, len(shape))
    sizes = TS.mesh_axes(got.mesh)
    want = [Replicate()] * len(mesh_axes)
    for dim, entry in enumerate(spec):
        for axis in ((entry,) if isinstance(entry, str) else entry or ()):
            if sizes[axis] > 1:
                want[mesh_axes.index(axis)] = Shard(dim)
    assert tuple(got.placements) == tuple(want), (shape, spec, got)
    assert TS.placements_for(got.mesh, spec) == tuple(want)


@pytest.mark.parametrize("mesh_name,flag_name", CASES)
def test_rules_resolve_as_the_reference(mesh_name, flag_name):
    """axes, spec, spec_for_shape (dims that do not divide, reused axes)
    and tp_size, on logical names and shapes chosen to hit every rule."""
    jr, tr = _rules(mesh_name, flag_name)
    for logical in ("fsdp", "dp", "tp", "sp", None):
        assert tr.axes(logical) == jr.axes(logical)
    assert tr.tp_size() == jr.tp_size()
    names = ("fsdp", "dp", "tp", "sp", None)
    rng = np.random.default_rng(0)
    for _ in range(200):
        nd = int(rng.integers(1, 5))
        shape = tuple(int(x) for x in rng.choice([1, 2, 3, 4, 6, 8, 12, 16,
                                                  32, 64, 96], nd))
        logical = tuple(names[i] for i in rng.integers(0, 5, nd))
        assert tuple(tr.spec(*logical)) == _spec(jr.spec(*logical), nd)
        assert tuple(tr.spec_for_shape(shape, *logical)) == _spec(
            jr.spec_for_shape(shape, *logical), nd), (shape, logical)


@pytest.mark.parametrize("mesh_name,flag_name", CASES)
def test_param_shardings_match_the_reference(mesh_name, flag_name):
    jr, tr = _rules(mesh_name, flag_name)
    axes = MESHES[mesh_name][1]
    for arch in ARCHS:
        jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
        want = _flat(JT.param_shardings(jc, jr))
        got = _flat(TT.param_shardings(tc, tr))
        shapes = {k: v.shape for k, v in _flat(TT.abstract_params(tc)).items()}
        assert set(got) == set(want), arch
        for path, sh in want.items():
            _check_sharding(sh, got[path], shapes[path], axes)


@pytest.mark.parametrize("mesh_name,flag_name", CASES)
def test_cache_specs_match_the_reference(mesh_name, flag_name):
    """Every KV and SSM cache leaf's sharding, for a batch that divides
    the data axes and a batch of one (where shard_seq moves the data
    axes to the sequence)."""
    jr, tr = _rules(mesh_name, flag_name)
    axes = MESHES[mesh_name][1]
    for arch in ARCHS:
        jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
        for batch, s_max, shard_seq in ((32, 64, False), (1, 256, True),
                                        (8, 8192, False)):
            jcache, jsh = JT.cache_specs(jc, batch, s_max, jr, shard_seq)
            tcache, tsh = TT.cache_specs(tc, batch, s_max, tr, shard_seq)
            jcache, jsh = _flat(jcache), _flat(jsh)
            tcache, tsh = _flat(tcache), _flat(tsh)
            assert set(tsh) == set(jsh) == set(tcache), arch
            for path, sh in jsh.items():
                assert tuple(tcache[path].shape) == tuple(jcache[path].shape)
                assert str(tcache[path].dtype).split(".")[-1] == str(
                    jcache[path].dtype)
                _check_sharding(sh, tsh[path], tcache[path].shape, axes)


@pytest.mark.parametrize("mesh_name,flag_name", CASES)
def test_state_shardings_match_the_reference(mesh_name, flag_name):
    jr, tr = _rules(mesh_name, flag_name)
    axes = MESHES[mesh_name][1]
    for arch in ("qwen2_1_5b", "qwen2_moe_a2_7b", "jamba_1_5_large"):
        jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
        want, got = JTS.state_shardings(jc, jr), TTS.state_shardings(tc, tr)
        shapes = _flat(TTS.make_abstract_state(tc))
        for part in ("params", "mu", "nu"):
            w = _flat(want.params if part == "params" else
                      getattr(want.opt, part))
            g = _flat(got.params if part == "params" else
                      getattr(got.opt, part))
            assert set(g) == set(w)
            for path, sh in w.items():
                key = ("params",) + path if part == "params" else (
                    "opt", part) + path
                _check_sharding(sh, g[path], shapes[key].shape, axes)
        _check_sharding(want.opt.step, got.opt.step, (), axes)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_and_state_match_the_reference(arch):
    jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
    want = _flat(jax.tree.map(lambda s: (s.shape, str(s.dtype)),
                              JT.abstract_params(jc)))
    got = TT.abstract_params(tc)
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
           for k, v in _flat(got).items()}
    assert got == want
    assert all(v.device.type == "meta" for v in _flat(
        TT.abstract_params(tc)).values())
    jstate = JTS.make_abstract_state(jc)
    tstate = TTS.make_abstract_state(tc)
    for part in ("mu", "nu"):
        w = _flat(jax.tree.map(lambda s: (s.shape, str(s.dtype)),
                               getattr(jstate.opt, part)))
        g = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
             for k, v in _flat(getattr(tstate.opt, part)).items()}
        assert g == w
    assert tuple(tstate.opt.step.shape) == tuple(jstate.opt.step.shape)
    assert tstate.opt.step.dtype == torch.int32


def test_placements_refuse_a_spec_out_of_mesh_order():
    """A dim sharded over several axes takes them in mesh order, as
    `named` (the reference's NamedSharding) does."""
    from repro_torch.parallel.mesh import named

    mesh = TS.AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    assert named(mesh, ("pod", "data"), None).placements == (
        Shard(0), Shard(0), Replicate())
    assert TS.placements_for(mesh, (("pod", "data"), "model")) == (
        Shard(0), Shard(0), Shard(1))
    with pytest.raises(ValueError, match="mesh's order"):
        TS.placements_for(mesh, (("data", "pod"), None))
    rules = TS.ShardingRules(mesh=mesh, fsdp_axes=("data", "pod"))
    with pytest.raises(ValueError, match="mesh's order"):
        rules.sharding_for_shape((8, 4), "fsdp", None)
    ones = TS.AbstractMesh((1, 2, 1), ("pod", "data", "model"))
    assert TS.placements_for(ones, (("pod", "data"), "model")) == (
        Replicate(), Shard(0), Replicate())


def test_without_a_mesh_nothing_is_sharded():
    rules = TS.ShardingRules()
    x = torch.ones(4, 6)
    assert rules.constrain(x, "dp", "tp") is x
    assert rules.constrain_p(x, TS.P("data", None)) is x
    assert rules.sharding("dp") is None
    assert rules.sharding_for_shape((4, 6), "dp", "tp") is None
    assert tuple(rules.spec_for_shape((4, 6), "dp", "tp")) == (None, None)
    assert rules.tp_size() == 1
    cfg = tconfigs.get_smoke_config("qwen2_1_5b")
    assert all(v is None for v in _flat(TT.param_shardings(cfg, rules))
               .values())


@pytest.mark.parametrize("h,kv,tp", [(12, 2, 2), (8, 1, 2), (12, 3, 2),
                                     (12, 3, 4), (16, 4, 8), (28, 4, 4)])
def test_local_heads_read_their_kv_heads(h, kv, tp):
    """A rank holding query heads [r h/tp, (r + 1) h/tp) of a replicated
    K/V attends with the KV heads `kv_heads_for` gives it (a run with its
    group, or one per query head where the run splits a group) exactly as
    those heads of the whole attention do."""
    from repro_torch.models import layers as TL

    rng = np.random.default_rng(h * 100 + kv * 10 + tp)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (2, 5, n, 8), dtype=np.float32)) for n in (h, kv, kv))
    pos = torch.arange(5)[None].expand(2, 5)
    bias = TL._mask_bias(pos, pos, None)
    whole = TL._sdpa(q, k, v, bias, h // kv)
    hn = h // tp
    for r in range(tp):
        heads = range(r * hn, (r + 1) * hn)
        kv_heads, group = TL.kv_heads_for(heads, h // kv)
        assert len(kv_heads) * group == hn
        assert [kv_heads[j // group] for j in range(hn)] == [
            i // (h // kv) for i in heads]
        got = TL._sdpa(q[:, :, heads.start:heads.stop],
                       TL._take_heads(k, kv_heads),
                       TL._take_heads(v, kv_heads), bias, group)
        torch.testing.assert_close(got, whole[:, :, heads.start:heads.stop],
                                   rtol=1e-6, atol=1e-6)
