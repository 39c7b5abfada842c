"""Port parity for the LM substrate's configs and layers:
`repro_torch.configs` and `repro_torch.models` against `repro`'s, on the
CPU (the whole serving slice is held in test_torch_serving.py, the MoE and
SSM layers in test_torch_moe.py and test_torch_ssm.py).

Both packages get the same numpy inputs and the same weights: the
reference draws them with jax.random and the port takes a copy. The
reference functions run under jax.jit, which compiles each once instead of
op by op. On the CPU the port's prefill attention step runs the reference's
own code (`_sdpa`, or the query-chunked form past CHUNK_THRESHOLD), so in
f32 the packages differ only by summation order: layers agree within
1e-5 of the values' scale (`close`).
"""
import contextlib
import dataclasses
import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import configs as jconfigs
from repro.models import config as jconfig
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch.models import config as tconfig
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.parallel.mesh import make_mesh
from repro_torch.parallel.sharding import AbstractMesh, ShardingRules, full
from repro_torch.training import make_abstract_state, state_shardings
from torch.distributed.tensor import DTensor

torch.set_num_threads(1)

# dense: the attention layer tests (GQA groups 2, 2, 4 and 2)
ARCHS = ["qwen2_1_5b", "yi_6b", "deepseek_coder_33b", "internlm2_20b"]
FAMILIES = ["qwen2_moe_a2_7b", "jamba_1_5_large", "mamba2_130m"]
# every reference architecture, in the reference's order
PORTED = ["qwen2_1_5b", "deepseek_coder_33b", "yi_6b", "internlm2_20b",
          "qwen2_moe_a2_7b", "mixtral_8x7b", "jamba_1_5_large",
          "mamba2_130m", "internvl2_26b", "musicgen_large"]
LAYER_TOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def close(got, want, tol):
    """max |got - want| <= tol * max(1, max |want|)."""
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, tol * scale)


def as_np(t):
    return t.detach().to(torch.float32).numpy()


@contextlib.contextmanager
def one_rank_mesh(tmp_path):
    """A (data 1, model 1) DeviceMesh over a gloo world of one, for the
    block's duration: the DTensor paths of the sharded layers run on it
    with every local part whole."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield make_mesh((1, 1), ("data", "model"), device_type="cpu")
    finally:
        dist.destroy_process_group()


def cfgs(arch, dtype="float32", **over):
    """The reference's and the port's smoke config, equally overridden."""
    return (jconfigs.get_smoke_config(arch).scaled(dtype=dtype, **over),
            tconfigs.get_smoke_config(arch).scaled(dtype=dtype, **over))


def ref_params(jc, seed=0):
    """The reference's init_params for `jc`, compiled once."""
    return jax.jit(JT.init_params, static_argnums=0)(
        jc, jax.random.PRNGKey(seed))


def _flat_defs(defs, prefix=()):
    if isinstance(defs, (JL.ParamDef, TL.ParamDef)):
        return {prefix: (defs.shape, defs.spec, defs.scale, defs.dtype,
                         defs.fan_in)}
    out = {}
    for k, v in defs.items():
        out.update(_flat_defs(v, prefix + (k,)))
    return out


# -- configs -----------------------------------------------------------------

@pytest.mark.parametrize("name", PORTED + [
    "qwen2-1.5b", "yi-6b", "qwen2-moe-a2.7b", "jamba-1.5-large-398b",
    "mamba2-130m", "deepseek-coder-33b", "internlm2-20b", "mixtral-8x7b",
    "internvl2-26b", "musicgen-large"])
def test_configs_match_the_reference(name):
    for get in ("get_config", "get_smoke_config"):
        want = getattr(jconfigs, get)(name)
        got = getattr(tconfigs, get)(name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.repeats == want.repeats
        assert got.resolved_head_dim == want.resolved_head_dim
        assert got.attention_free == want.attention_free
        assert got.sub_quadratic == want.sub_quadratic
        assert tconfig.count_params(got) == jconfig.count_params(want)


def _as_port_config(want):
    """A reference ModelConfig rebuilt from the port's dataclasses."""
    fields = dataclasses.asdict(want)
    fields["pattern"] = tuple(tconfig.SubLayer(**s) for s in fields["pattern"])
    for key, cls in (("moe", tconfig.MoEConfig), ("ssm", tconfig.SSMConfig),
                     ("frontend", tconfig.FrontendConfig)):
        if fields[key] is not None:
            fields[key] = cls(**fields[key])
    return tconfig.ModelConfig(**fields)


@pytest.mark.parametrize("name", jconfigs.list_archs())
def test_counts_and_properties_every_family(name):
    """count_active_params, count_moe_expert_params, attention_free and
    sub_quadratic over each of the reference's ten configs."""
    want = jconfigs.get_config(name)
    got = _as_port_config(want)
    assert tconfig.count_active_params(got) == \
        jconfig.count_active_params(want)
    assert tconfig.count_moe_expert_params(got) == \
        jconfig.count_moe_expert_params(want)
    assert got.attention_free == want.attention_free
    assert got.sub_quadratic == want.sub_quadratic


def test_count_params_every_family():
    """count_params is pure arithmetic over any reference config."""
    for name in jconfigs.list_archs():
        want = jconfigs.get_config(name)
        got = _as_port_config(want)
        assert tconfig.count_params(got) == jconfig.count_params(want), name


def test_registry_lists_ported_and_names_the_rest():
    """The port lists every reference architecture in the reference's order
    (items 17 and 18 brought the last five), and names nothing else."""
    assert tconfigs.list_archs() == jconfigs.list_archs() == PORTED
    for name in PORTED:
        assert tconfigs.get_config(name) == _as_port_config(
            jconfigs.get_config(name))
    with pytest.raises(ValueError, match="unknown architecture"):
        tconfigs.get_config("gpt-17")


@pytest.mark.parametrize("arch", PORTED)
def test_model_defs_match_the_reference(arch):
    """Same keys, shapes, specs, init scales, dtypes and fan_in (the stacked
    defs keep none, as in the reference)."""
    jc, tc = cfgs(arch)
    assert _flat_defs(TT.model_defs(tc)) == _flat_defs(JT.model_defs(jc))
    jc, tc = (c.scaled(tie_embeddings=not c.tie_embeddings) for c in (jc, tc))
    assert _flat_defs(TT.model_defs(tc)) == _flat_defs(JT.model_defs(jc))


def test_init_params_follows_the_param_defs():
    _, tc = cfgs("qwen2_1_5b")
    params = TT.init_params(tc, seed=0, device="cpu")
    again = TT.init_params(tc, seed=0, device="cpu")
    other = TT.init_params(tc, seed=1, device="cpu")
    defs = _flat_defs(TT.model_defs(tc))
    flat = {}

    def walk(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat[prefix + (k,)] = v
    walk(params)
    assert set(flat) == set(defs)
    assert TT.param_count(params) == tconfig.count_params(tc)
    for path, (shape, _, scale, dtype, fan_in) in defs.items():
        t = flat[path]
        assert tuple(t.shape) == shape and t.dtype == torch.float32
        if scale == 0.0:
            assert not t.any()
        else:
            std = scale / np.sqrt(fan_in or shape[0])
            assert abs(float(t.std()) / std - 1) < 0.2, path
    assert torch.equal(params["embed"], again["embed"])
    assert not torch.equal(params["embed"], other["embed"])


# -- layers ------------------------------------------------------------------

def test_rmsnorm_matches_the_reference():
    x = _rng().standard_normal((2, 5, 64), dtype=np.float32) * 3
    scale = _rng(1).standard_normal(64, dtype=np.float32) * 0.1
    want = JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6)
    got = TL.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x),
                     1e-6)
    close(as_np(got), want, LAYER_TOL)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches_the_reference(theta):
    x = _rng().standard_normal((2, 9, 3, 16), dtype=np.float32)
    pos = np.array([np.arange(9), np.arange(5, 14)], dtype=np.int32)
    want = JL.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = TL.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    close(as_np(got), want, LAYER_TOL)


def _attn_params(arch, seed=0):
    """One attention layer's reference weights and the port's copy."""
    jc, tc = cfgs(arch)
    defs = JL.attention_defs(jc)
    jp = jax.jit(lambda key: JL.init_tree(key, defs))(
        jax.random.PRNGKey(seed))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jc, jp, tc, tp


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("chunked", [False, True])
def test_attention_with_kv_matches_the_reference(arch, chunked, monkeypatch):
    """Dense scores, and the query-chunked form past a lowered threshold
    (S = 10 over chunks of 4: the last chunk padded)."""
    if chunked:
        for mod in (JL, TL):
            monkeypatch.setattr(mod, "CHUNK_THRESHOLD", 8)
            monkeypatch.setattr(mod, "QUERY_CHUNK", 4)
    jc, jp, tc, tp = _attn_params(arch)
    x = _rng(2).standard_normal((2, 10, jc.d_model), dtype=np.float32)
    pos = np.broadcast_to(np.arange(10, dtype=np.int32), (2, 10))
    want = jax.jit(JL.attention_with_kv, static_argnums=1)(
        jp, jc, jnp.asarray(x), jnp.asarray(pos))
    got = TL.attention_with_kv(tp, tc, torch.from_numpy(x),
                               torch.from_numpy(pos.copy()))
    for g, w in zip(got, want):
        close(as_np(g), w, LAYER_TOL)


@pytest.mark.parametrize("window", [None, 6])
def test_attention_decode_matches_the_reference(window):
    """One token against a partly filled cache; with a window the cache is
    a ring buffer (6 slots, position 9 goes to slot 3)."""
    jc, jp, tc, tp = _attn_params("qwen2_1_5b")
    jc, tc = (c.scaled(sliding_window=window) for c in (jc, tc))
    s_alloc, cur = (12, 7) if window is None else (6, 9)
    rng = _rng(4)
    x = rng.standard_normal((2, 1, jc.d_model), dtype=np.float32)
    shape = (2, s_alloc, jc.num_kv_heads, jc.resolved_head_dim)
    ck = rng.standard_normal(shape, dtype=np.float32)
    cv = rng.standard_normal(shape, dtype=np.float32)
    want = jax.jit(JL.attention_decode, static_argnums=1)(
        jp, jc, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
        jnp.int32(cur))
    got = TL.attention_decode(tp, tc, torch.from_numpy(x),
                              torch.from_numpy(ck.copy()),
                              torch.from_numpy(cv.copy()), cur)
    for g, w in zip(got, want):
        close(as_np(g), w, LAYER_TOL)


@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu"])
def test_mlp_matches_the_reference(mlp_type):
    jc, tc = cfgs("yi_6b", mlp_type=mlp_type)
    defs = JL.mlp_defs(jc)
    jp = jax.jit(lambda key: JL.init_tree(key, defs))(jax.random.PRNGKey(3))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = _rng(5).standard_normal((2, 7, jc.d_model), dtype=np.float32)
    want = JL.mlp(jp, jc, jnp.asarray(x))
    close(as_np(TL.mlp(tp, tc, torch.from_numpy(x))), want, LAYER_TOL)


# -- weights, devices, and what the slice leaves out --------------------------

def test_params_from_reference_checks_keys_and_shapes():
    jc, tc = cfgs("qwen2_1_5b")
    tree = jax.tree.map(np.asarray, ref_params(jc))
    bad = dict(tree, embed=tree["embed"][:-1])
    with pytest.raises(ValueError, match="embed: shape"):
        TT.params_from_reference(bad, tc, device="cpu")
    missing = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(ValueError, match="keys"):
        TT.params_from_reference(missing, tc, device="cpu")
    bf16 = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                        tree)
    got = TT.params_from_reference(bf16, tc, device="cpu")
    assert got["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(as_np(got["embed"]),
                                  bf16["embed"].astype(np.float32))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is satisfiable")
    _, tc = cfgs("qwen2_1_5b")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TT.init_params(tc, seed=0)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TT.init_cache(tc, 1, 8)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TT.params_from_reference({}, tc)


def test_what_the_slice_leaves_out_raises(tmp_path):
    """MoE and SSM patterns, the vision and audio frontends and a sliding
    window build; prefill and loss_fn under sharding rules on a one-rank
    mesh (every param and activation a DTensor, each local part whole)
    give the unsharded results, the abstract state and its shardings
    resolve, and a checkpoint of sharded (DTensor) state, once refused,
    comes back bit-equal as DTensors."""
    _, tc = cfgs("qwen2_1_5b")
    moe = tc.scaled(pattern=(tconfig.SubLayer(ffn="moe"),),
                    moe=tconfig.MoEConfig(num_experts=2, top_k=1,
                                          d_ff_expert=8))
    ssm = tc.scaled(pattern=(tconfig.SubLayer(kind="ssm"),),
                    ssm=tconfig.SSMConfig())
    for cfg in (moe, ssm):
        assert TT.param_count(TT.init_params(cfg, seed=0, device="cpu")) \
            == tconfig.count_params(cfg)
    vision = tc.scaled(frontend=tconfig.FrontendConfig(
        modality="vision", d_frontend=12, num_positions=3))
    audio = tc.scaled(frontend=tconfig.FrontendConfig(modality="audio",
                                                      num_positions=2))
    window = tc.scaled(sliding_window=4)
    for cfg in (vision, audio, window):
        assert TT.param_count(TT.init_params(cfg, seed=0, device="cpu")) \
            == tconfig.count_params(cfg)
    assert tconfigs.get_config("mixtral_8x7b").sliding_window == 4096
    tp = TT.init_params(tc, seed=0, device="cpu")
    toks = torch.arange(4, dtype=torch.int64)[None]
    batch = {"tokens": toks, "labels": toks}
    with one_rank_mesh(tmp_path) as mesh:
        rules = ShardingRules(mesh=mesh)
        sp = TT.init_params(tc, seed=0, device="cpu", rules=rules)
        assert isinstance(sp["embed"], DTensor)
        for got, want in ((TT.prefill(sp, tc, {"tokens": toks}, rules),
                           TT.prefill(tp, tc, {"tokens": toks})),
                          (TT.loss_fn(sp, tc, batch, rules),
                           TT.loss_fn(tp, tc, batch))):
            close(as_np(full(got[0])), as_np(want[0]), 1e-6)
        save_checkpoint(str(tmp_path / "ckpt"), 0, sp)
        back = load_checkpoint(str(tmp_path / "ckpt"), 0, sp, device="cpu")
        def pairs(a, b):
            if isinstance(b, dict):
                return [x for k in b for x in pairs(a[k], b[k])]
            return [(a, b)]
        leaves = pairs(back, sp)
        assert len(leaves) > 3 and all(
            isinstance(b, DTensor) and torch.equal(b.to_local(), s.to_local())
            for b, s in leaves)
    no_mesh = ShardingRules()
    state = make_abstract_state(tc)
    assert state.params["embed"].device.type == "meta"
    assert state.opt.mu["embed"].dtype == torch.float32
    assert state_shardings(tc, no_mesh).params["embed"] is None
    mesh = AbstractMesh((1, 1), ("data", "model"))
    assert state_shardings(tc, ShardingRules(mesh=mesh)).opt.step.mesh \
        is mesh


@pytest.mark.parametrize("arch", FAMILIES)
def test_params_from_reference_carries_moe_ssm_and_hybrid_trees(arch):
    """The reference's MoE, SSM and hybrid parameter trees carry across
    unchanged: every leaf equal, under the same keys."""
    jc, tc = cfgs(arch)
    tree = jax.tree.map(np.asarray, ref_params(jc))
    got = TT.params_from_reference(tree, tc, device="cpu")
    want = _flat_leaves(tree)
    have = _flat_leaves(got)
    assert set(have) == set(want) == set(_flat_defs(TT.model_defs(tc)))
    for path, leaf in have.items():
        np.testing.assert_array_equal(as_np(leaf), want[path])


def _flat_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_leaves(v, prefix + (k,)))
        return out
    return {prefix: tree}
