"""Full model: embeddings + block stack + tied or untied head; the
training loss, and prefill and decode with KV and SSM caches.

Port of `repro/models/transformer.py`. Parameters keep the reference's dict
keys, with each pattern-repeat's weights stacked on a leading `repeats`
axis, so that carrying weights across is one-to-one
(`params_from_reference`). The reference scans over that axis; here a
Python loop walks it, one layer's views at a time. `loss_fn` rematerialises
each repeat's block in the backward (`torch.utils.checkpoint`, the
counterpart of the reference's `jax.checkpoint(..., nothing_saveable)`).

A block is the config's pattern of sub-layers: attention or Mamba-2 (SSD)
mixing, then an MLP, a MoE or no FFN (the hybrid Jamba stack repeats 8 of
them). The modality frontends are the reference's: audio (MusicGen) sums K
codebook embeddings at the input and predicts K codebooks with K heads;
vision (InternVL2) maps precomputed patch embeddings through the trained
2-layer MLP projector and puts them before the text, image tokens first.

Sharding rules (`parallel/sharding.py`): the parameters are DTensors laid
out by `param_shardings` (`init_params(..., rules=)` and
`params_from_reference(..., rules=)` place them one leaf at a time), each
rank embeds only its dp rows of the inputs (a whole batch handed in is
cut locally, one laid out over dp is taken as it is), and each block
gathers its fsdp-sharded weights at use (ZeRO-3, `_gather_block_params`;
the MoE's routed experts stay sharded unless `gather_moe_experts`). The
caches are DTensors laid out by `cache_specs`, each rank writing its own
part. The outputs are DTensors; `.full_tensor()` gathers one.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..device import resolve_device
from ..parallel.sharding import (
    ShardingRules, local_bounds, reshard, settled, shard_tensor, summed,
    tree_shardings, wrap_local, zeros_sharded)
from . import layers as L
from .config import ModelConfig, SubLayer
from .moe import moe, moe_defs
from .ssm import SSMCache, ssm_block, ssm_cache_defs, ssm_defs

PyTree = Any


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------

def _modality(cfg: ModelConfig) -> Optional[str]:
    """"vision", "audio" or None."""
    return None if cfg.frontend is None else cfg.frontend.modality


def _sublayer_defs(cfg: ModelConfig, sub: SubLayer) -> Dict:
    defs: Dict[str, Any] = {"norm_mix": L.rmsnorm_defs(cfg.d_model)}
    if sub.kind == "attn":
        defs["attn"] = L.attention_defs(cfg)
    else:
        defs["ssm"] = ssm_defs(cfg)
    if sub.ffn != "none":
        defs["norm_ffn"] = L.rmsnorm_defs(cfg.d_model)
        if sub.ffn == "mlp":
            defs["mlp"] = L.mlp_defs(cfg)
        else:
            defs["moe"] = moe_defs(cfg)
    return defs


def _stack_defs(defs: PyTree, repeats: int) -> PyTree:
    """Each ParamDef with a leading `repeats` axis. As in the reference, the
    stacked def keeps no fan_in, so a block weight's init std is
    scale / sqrt(repeats)."""
    if isinstance(defs, L.ParamDef):
        return L.ParamDef((repeats, *defs.shape), (None, *defs.spec),
                          scale=defs.scale, dtype=defs.dtype)
    return {k: _stack_defs(v, repeats) for k, v in defs.items()}


def model_defs(cfg: ModelConfig) -> PyTree:
    d = cfg.d_model
    defs: Dict[str, Any] = {}
    if _modality(cfg) == "audio":
        # K codebook embedding tables, summed at the input, and K heads
        k = cfg.frontend.num_positions
        defs["embed"] = L.ParamDef((k, cfg.vocab_size, d),
                                   (None, "tp", "fsdp"), fan_in=d)
        defs["head"] = L.ParamDef((k, d, cfg.vocab_size),
                                  (None, "fsdp", "tp"), fan_in=d)
    else:
        defs["embed"] = L.ParamDef((cfg.vocab_size, d), ("tp", "fsdp"),
                                   fan_in=d)
        if not cfg.tie_embeddings:
            defs["head"] = L.ParamDef((d, cfg.vocab_size), ("fsdp", "tp"))
    if _modality(cfg) == "vision":
        df = cfg.frontend.d_frontend
        defs["projector"] = {
            "w1": L.ParamDef((df, d), ("fsdp", "tp")),
            "norm": L.rmsnorm_defs(df),
            "w2": L.ParamDef((d, d), ("tp", "fsdp")),
        }
    block = {
        f"sub_{i}": _sublayer_defs(cfg, s) for i, s in enumerate(cfg.pattern)
    }
    defs["blocks"] = _stack_defs(block, cfg.repeats)
    defs["final_norm"] = L.rmsnorm_defs(d)
    return defs


def init_params(cfg: ModelConfig, seed: int, device="cuda",
                rules: Optional[ShardingRules] = None) -> PyTree:
    """Random parameters, std = scale / sqrt(fan_in) per ParamDef, drawn
    from a torch.Generator seeded with `seed` on `device`. Not bit-equal to
    the reference's jax.random draw: parity tests carry the reference's
    weights across with `params_from_reference` instead.

    With `rules`, every rank draws the same leaves in the same order and
    keeps only its part of each (`shard_tensor`), so the sharded weights
    are those of the unsharded call and no rank holds more than one whole
    leaf at a time."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if rules is None:
        return L.init_tree(gen, model_defs(cfg))
    shardings = param_shardings(cfg, rules)

    def draw(defs, sh):
        if isinstance(defs, L.ParamDef):
            return shard_tensor(L.init_param(gen, defs), sh, dev)
        return {k: draw(defs[k], sh[k]) for k in sorted(defs)}

    return draw(model_defs(cfg), shardings)


def params_from_reference(np_tree: PyTree, cfg: ModelConfig,
                          device="cuda",
                          rules: Optional[ShardingRules] = None) -> PyTree:
    """The reference's parameter pytree, as numpy arrays under its dict keys
    (``jax.tree.map(np.asarray, params)``), as the port's dict of tensors on
    `device`, each in its array's dtype. Keys and shapes are checked
    against `model_defs(cfg)`. With `rules`, each leaf goes to the device
    as this rank's part, one leaf at a time."""
    dev = resolve_device(device)
    shardings = param_shardings(cfg, rules) if rules is not None else None

    def convert(tree, defs, sh, path):
        if isinstance(defs, L.ParamDef):
            arr = np.array(tree)   # a copy: the port owns its weights
            if arr.shape != defs.shape:
                raise ValueError(f"{'/'.join(path)}: shape {arr.shape}, "
                                 f"expected {defs.shape}")
            if arr.dtype.name == "bfloat16":   # ml_dtypes, unknown to torch
                t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            return t.to(dev) if sh is None else shard_tensor(t, sh, dev)
        if set(tree) != set(defs):
            raise ValueError(f"{'/'.join(path) or 'params'}: keys "
                             f"{sorted(tree)}, expected {sorted(defs)}")
        return {k: convert(tree[k], defs[k], None if sh is None else sh[k],
                           path + (k,)) for k in defs}

    return convert(np_tree, model_defs(cfg), shardings, ())


def abstract_params(cfg: ModelConfig) -> PyTree:
    """The parameter tree as meta tensors: shapes and dtypes, no storage."""
    def meta(defs):
        if isinstance(defs, L.ParamDef):
            return torch.empty(defs.shape, dtype=L.torch_dtype(defs.dtype),
                               device="meta")
        return {k: meta(v) for k, v in defs.items()}

    return meta(model_defs(cfg))


def param_shardings(cfg: ModelConfig, rules: ShardingRules) -> PyTree:
    return tree_shardings(rules, model_defs(cfg))


def param_count(params: PyTree) -> int:
    if isinstance(params, torch.Tensor):
        return params.numel()
    return sum(param_count(v) for v in params.values())


def _layer(tree: PyTree, r: int) -> PyTree:
    """Repeat r's views of a stacked (repeats, ...) tree."""
    if isinstance(tree, torch.Tensor):
        return tree[r]
    return {k: _layer(v, r) for k, v in tree.items()}


def _unstack(tree: PyTree) -> List[PyTree]:
    """Every repeat's views of a stacked (repeats, ...) tree, from one
    unbind per leaf. In the backward each leaf's gradient is then one stack
    of its repeats' gradients; `_layer`'s indexing would zero-fill and add
    a whole leaf-sized gradient for every repeat."""
    if isinstance(tree, torch.Tensor):
        return list(tree.unbind(0))
    parts = {k: _unstack(v) for k, v in tree.items()}
    n = len(next(iter(parts.values())))
    return [{k: part[r] for k, part in parts.items()} for r in range(n)]


def _gathered(tree: PyTree, defs: PyTree, rules: ShardingRules) -> PyTree:
    """Each leaf constrained to its def's spec with the fsdp dim
    replicated: an all-gather over the fsdp axes at use."""
    if isinstance(defs, L.ParamDef):
        return rules.constrain(
            tree, *(None if s == "fsdp" else s for s in defs.spec))
    return {k: _gathered(tree[k], defs[k], rules) for k in tree}


def _zero3(rules) -> bool:
    return (rules is not None and rules.mesh is not None and rules.fsdp
            and rules.zero3_gather)


def _gather_block_params(p_block, cfg: ModelConfig, rules):
    """ZeRO-3 gather-at-use of one repeat's block weights. Without it a
    d-sharded contraction would resolve as a partial sum of the (larger)
    activations; the gradient goes back to the fsdp-sharded leaf as a
    reduce-scatter. With `gather_moe_experts` False the routed expert
    weights stay sharded (expert parallelism): only the router and the
    shared expert, which every token uses, are gathered."""
    if not _zero3(rules):
        return p_block
    out = {}
    for i, sub in enumerate(cfg.pattern):
        key = f"sub_{i}"
        sub_defs, sub_p = _sublayer_defs(cfg, sub), p_block[key]
        new = {}
        for name, d_sub in sub_defs.items():
            if name == "moe" and not rules.gather_moe_experts:
                new[name] = dict(sub_p[name])
                for small in ("router", "shared"):
                    if small in sub_p[name]:
                        new[name][small] = _gathered(
                            sub_p[name][small], d_sub[small], rules)
            else:
                new[name] = _gathered(sub_p[name], d_sub, rules)
        out[key] = new
    return out


def _gather_head_params(params, cfg: ModelConfig, rules):
    """The same gather-at-use for the embedding, the head and the vision
    projector: a d-sharded head contraction would otherwise all-reduce
    the whole logits tensor over the data axes."""
    if not _zero3(rules):
        return params
    defs = model_defs(cfg)
    out = dict(params)
    for key in ("embed", "head", "projector"):
        if key in params:
            out[key] = _gathered(params[key], defs[key], rules)
    return out


def _replicated(t: torch.Tensor, like) -> torch.Tensor:
    """A whole input tensor as a replicated DTensor on `like`'s mesh when
    `like` is a DTensor; unchanged otherwise."""
    if not isinstance(like, DTensor) or isinstance(t, DTensor):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t.to(like.device), mesh,
                              [Replicate()] * mesh.ndim, run_check=False)


def _dp_rows(t: torch.Tensor, rules, like) -> torch.Tensor:
    """A batch entry as this rank's dp rows under `rules` when the weights
    (`like`) are DTensors: a DTensor laid out over dp on its leading dim
    (`sharding_for_shape`, which drops the data axes a batch does not
    divide). A whole tensor is cut locally, with no communication; a
    DTensor fed with that layout is taken as it is. Without rules, on
    `like`'s device as `_replicated` leaves it."""
    if not isinstance(like, DTensor) or rules is None or rules.mesh is None:
        return _replicated(t.to(like.device), like)
    sh = rules.sharding_for_shape(t.shape, "dp", *(None,) * (t.ndim - 1))
    if isinstance(t, DTensor):
        return reshard(t, sh.placements)
    return shard_tensor(t, sh, like.device)


def _zero_aux(x: torch.Tensor) -> torch.Tensor:
    """A 0-d f32 zero, replicated on x's mesh when x is a DTensor."""
    return _replicated(torch.zeros((), dtype=torch.float32,
                                   device=x.device), x)


# ---------------------------------------------------------------------------
# Input embedding and head
# ---------------------------------------------------------------------------

def embed_inputs(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                 rules=None) -> torch.Tensor:
    """(B, S, d) in cfg.dtype. batch["tokens"]: (B, S) ids, or (B, K, S)
    for audio, whose K codebook embeddings are summed. With
    batch["patch_embeds"] (B, S_img, d_frontend) a vision model's projector
    output comes first: (B, S_img + S, d). Decode batches are text only.
    Under rules with DTensor weights each rank looks up only its dp rows
    (`_dp_rows`), and the output is constrained to (dp, sp, -); with
    DTensor weights and no rules the inputs are replicated onto their
    mesh."""
    dtype = L.torch_dtype(cfg.dtype)
    emb = params["embed"]
    tokens = _dp_rows(batch["tokens"], rules, emb)
    if _modality(cfg) == "audio":
        x = sum(F.embedding(tokens[:, i], emb[i])
                for i in range(cfg.frontend.num_positions)).to(dtype)
    else:
        x = F.embedding(tokens, emb).to(dtype)
    if _modality(cfg) == "vision" and "patch_embeds" in batch:
        pe = _dp_rows(batch["patch_embeds"], rules, emb).to(dtype)
        pr = params["projector"]
        h = L.rmsnorm(pr["norm"], pe, cfg.rms_eps)
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(h @ pr["w1"].to(dtype), approximate="tanh")
        # On a mesh the lookup leaves a masked partial sum and the
        # projector a plain one; DTensor joins no two partial kinds, so
        # each is reduced first (the constraint below would reduce it).
        x = torch.cat([settled(h @ pr["w2"].to(dtype)), settled(x)], dim=1)
    if rules is not None:
        x = rules.constrain(x, "dp", "sp", None)
    return x


def prompt_len(cfg: ModelConfig, batch: Dict[str, torch.Tensor]) -> int:
    """The positions `embed_inputs` gives a prompt: its text (or codes),
    and a vision prompt's patch_embeds before it."""
    n = batch["tokens"].shape[-1]
    if _modality(cfg) == "vision" and "patch_embeds" in batch:
        n += batch["patch_embeds"].shape[1]
    return n


def _logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """(B, S, V), or (B, S, K, V) from the K heads of an audio model."""
    if _modality(cfg) == "audio":
        return torch.einsum("bsd,kdv->bskv", x, params["head"].to(x.dtype))
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    return x @ head.to(x.dtype)


def _ffn(p, cfg: ModelConfig, sub: SubLayer, x: torch.Tensor, rules=None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sub-layer's FFN half, (x + ffn(norm(x)), aux): aux is the MoE
    router loss, a 0-d f32 zero for an MLP or no FFN."""
    aux = _zero_aux(x)
    if sub.ffn == "none":
        return x, aux
    h = L.rmsnorm(p["norm_ffn"], x, cfg.rms_eps)
    if sub.ffn == "mlp":
        return x + L.mlp(p["mlp"], cfg, h, rules), aux
    out, aux = moe(p["moe"], cfg, h, rules)
    return x + out, aux


# ---------------------------------------------------------------------------
# Blocks and the training forward (loss)
# ---------------------------------------------------------------------------

def _apply_sublayer(p, cfg: ModelConfig, sub: SubLayer, x: torch.Tensor,
                    positions: torch.Tensor, rules,
                    check_positions: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sub-layer, its mixer (attention or SSM) and its FFN; returns
    (x, aux), aux being the MoE router loss (0 without a MoE)."""
    h = L.rmsnorm(p["norm_mix"], x, cfg.rms_eps)
    if sub.kind == "attn":
        x = x + L.attention(p["attn"], cfg, h, positions, rules,
                            check_positions)
    else:
        out, _ = ssm_block(p["ssm"], cfg, h, rules)
        x = x + out
    return _ffn(p, cfg, sub, x, rules)


def _block(p_block, cfg: ModelConfig, x: torch.Tensor,
           positions: torch.Tensor, rules, check_positions: bool = True
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    aux_total = _zero_aux(x)
    for i, sub in enumerate(cfg.pattern):
        x, aux = _apply_sublayer(p_block[f"sub_{i}"], cfg, sub, x,
                                 positions, rules, check_positions)
        aux_total = aux_total + aux
    return x, aux_total


def _run_blocks(params, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, rules, remat: bool,
                check_positions: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block stack over the stacked weights' repeats. With `remat`,
    each repeat keeps only its input for the backward and recomputes its
    block there (no RNG runs inside a block, so its state is not kept);
    the ZeRO-3 gather is inside the recomputed part."""
    def block(p, h):
        p = _gather_block_params(p, cfg, rules)
        return _block(p, cfg, h, positions, rules, check_positions)

    aux = _zero_aux(x)
    for p_block in _unstack(params["blocks"]):
        if remat:
            x, a = checkpoint(block, p_block, x, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, a = block(p_block, x)
        aux = aux + a
    return x, aux


def _vocab_partial(pl, vdim: int) -> list:
    """The placements of a sum over the vocab dim `vdim` of a tensor laid
    out by `pl`: a partial sum where the vocab dim was sharded."""
    return [Partial() if p == Shard(vdim) else p for p in pl]


def _label_logits(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """logits[..., labels] over the last dim. On a DTensor whose vocab dim
    is sharded each rank picks the labels in its own vocab range (zero
    elsewhere), summed over the vocab-sharding ranks (`summed`): no rank
    gathers the logits. `labels` is whole, or a DTensor (the rank's rows)
    laid out like the logits' other dims."""
    if not isinstance(logits, DTensor):
        return torch.gather(logits, -1, labels[..., None])[..., 0]
    logits = settled(logits)
    mesh, pl = logits.device_mesh, logits.placements
    bounds = local_bounds(logits.shape, mesh, pl)
    vdim = logits.ndim - 1
    (v0, vn) = bounds[vdim]
    if isinstance(labels, DTensor):
        lab = reshard(labels, [Replicate() if p == Shard(vdim) else p
                               for p in pl]).to_local()
    else:
        lab = labels.to(logits.device)
        for dim, (off, n) in enumerate(bounds[:-1]):
            lab = lab.narrow(dim, off, n)
    lab = lab - v0
    inside = (lab >= 0) & (lab < vn)
    local = logits.to_local()
    ll = torch.gather(local, -1, lab.clamp(0, vn - 1)[..., None])[..., 0]
    ll = torch.where(inside, ll, 0.0)
    return summed(ll, mesh, _vocab_partial(pl, vdim), logits.shape[:-1])


def _logsumexp(logits: torch.Tensor) -> torch.Tensor:
    """logsumexp over the last dim. On a DTensor whose vocab dim is
    sharded: max + log(sum(exp(x - max))) with the max all-reduced and the
    sum of each rank's exponentials summed over the vocab-sharding ranks
    (`summed`) on local parts. DTensor's own sum over the sharded dim, as
    its backward runs with torch 2.11, gives gradients hundreds of times
    off (`tools/dtensor_grad_probe.py`); the explicit sum keeps the
    gradient of a sum."""
    if not isinstance(logits, DTensor):
        return torch.logsumexp(logits, dim=-1)
    logits = settled(logits)
    mesh, pl = logits.device_mesh, logits.placements
    vdim = logits.ndim - 1
    local = logits.to_local()
    mx = torch.amax(local, dim=-1, keepdim=True).detach()
    for i, p in enumerate(pl):
        if p == Shard(vdim):
            dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=mesh.get_group(i))
    total = summed(torch.sum(torch.exp(local - mx), dim=-1), mesh,
                   _vocab_partial(pl, vdim), logits.shape[:-1])
    out_pl = [Replicate() if p == Shard(vdim) else p for p in pl]
    return wrap_local(mx[..., 0], mesh, out_pl, logits.shape[:-1]) \
        + torch.log(total)


def _mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over every element. On a DTensor each rank sums its own
    part, the parts are summed over the ranks that shard it (`summed`,
    each term entering once) and divided by the global count; DTensor's
    own reduction is not used (see `_logsumexp`)."""
    if not isinstance(x, DTensor):
        return torch.mean(x)
    x = settled(x)
    pl = [Partial() if p.is_shard() else p for p in x.placements]
    return summed(torch.sum(x.to_local()), x.device_mesh, pl, ()) \
        / x.numel()


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            rules=None, remat: bool = True
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy, mean(logsumexp(logits) - logit[label])
    over every text position in f32. batch: tokens and labels, (B, S) ids
    or (B, K, S) for audio (one label per codebook); a vision model's
    optional patch_embeds (B, S_img, d_frontend), whose image positions
    carry no label and are left out. Returns (ce + aux, {"ce": ce, "aux":
    aux}), aux the MoE layers' summed router loss (a 0-d f32 zero without
    them).

    The positions are 0..S-1 in every row by construction, so the kernel's
    attention step skips its check (and its host sync). Under rules each
    rank takes its dp rows of the tokens and the labels (`_dp_rows`), the
    cross entropy reduces over the vocab-sharded logits in place
    (`_logsumexp`, `_label_logits`), and `ce` is the mean over the GLOBAL
    count of positions, each rank's terms summed once (`_mean`)."""
    params = _gather_head_params(params, cfg, rules)
    x = embed_inputs(params, cfg, batch, rules)
    b, s = x.shape[0], x.shape[1]
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    x, aux = _run_blocks(params, cfg, x, positions, rules, remat,
                         check_positions=False)
    x = L.rmsnorm(params["final_norm"], x, cfg.rms_eps)
    logits = _logits(params, cfg, x).to(torch.float32)
    labels = _dp_rows(batch["labels"], rules, params["embed"]).to(
        dtype=torch.int64)
    if _modality(cfg) == "vision":
        logits = logits[:, s - labels.shape[-1]:]       # drop the n_img
    if _modality(cfg) == "audio":
        labels = labels.movedim(1, 2)                   # (B, S, K)
    lse = _logsumexp(logits)
    ll = _label_logits(logits, labels)
    ce = _mean(lse - ll)
    return ce + aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Serving: prefill + decode with caches
# ---------------------------------------------------------------------------

class DecodeCache(NamedTuple):
    """Per sub-layer key "sub_<i>": stacked (repeats, B, S_alloc, K, hd)
    k and v caches of each attention sub-layer in cfg.dtype, and an
    SSMCache of each SSM sub-layer, conv (repeats, B, d_conv-1, C) in
    cfg.dtype and state (repeats, B, H, P, N) in f32."""
    attn_k: Dict
    attn_v: Dict
    ssm: Dict


def cache_alloc_len(cfg: ModelConfig, s_max: int) -> int:
    """SWA archs keep a ring buffer of the window size (see attention_decode)."""
    if cfg.sliding_window is not None:
        return min(s_max, cfg.sliding_window)
    return s_max


def _cache_layout(cfg: ModelConfig, batch: int, s_alloc: int
                  ) -> DecodeCache:
    """The decode cache's shapes and dtypes, as meta tensors."""
    shape = (cfg.repeats, batch, s_alloc, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    dtype = L.torch_dtype(cfg.dtype)
    cache = DecodeCache({}, {}, {})
    for i, sub in enumerate(cfg.pattern):
        key = f"sub_{i}"
        if sub.kind == "attn":
            for side in (cache.attn_k, cache.attn_v):
                side[key] = torch.empty(shape, dtype=dtype, device="meta")
        else:
            one = ssm_cache_defs(cfg, batch, "meta")
            cache.ssm[key] = SSMCache(*(
                torch.empty((cfg.repeats, *t.shape), dtype=t.dtype,
                            device="meta") for t in one))
    return cache


def _cache_shardings(cache: DecodeCache, rules: ShardingRules,
                     shard_seq: bool) -> DecodeCache:
    seq_ax = "dp" if shard_seq else None

    def kv(t):
        return rules.sharding_for_shape(t.shape, None, "dp", seq_ax, "tp",
                                        None)

    def ssm(c: SSMCache) -> SSMCache:
        return SSMCache(
            conv=rules.sharding_for_shape(c.conv.shape, None, "dp", None,
                                          "tp"),
            state=rules.sharding_for_shape(c.state.shape, None, "dp", "tp",
                                           None, None))

    return DecodeCache({k: kv(t) for k, t in cache.attn_k.items()},
                       {k: kv(t) for k, t in cache.attn_v.items()},
                       {k: ssm(c) for k, c in cache.ssm.items()})


def cache_specs(cfg: ModelConfig, batch: int, s_max: int,
                rules: Optional[ShardingRules] = None,
                shard_seq: bool = False):
    """The decode cache for `s_max` positions as meta tensors, and with
    `rules` also its Shardings: (cache, shardings). KV caches are (-, dp,
    seq, tp, -), seq being dp with `shard_seq` (the long-context layout:
    a batch of one cannot use data parallelism, so the cache's sequence
    is what gets distributed); SSM conv buffers (-, dp, -, tp), states
    (-, dp, tp, -, -)."""
    cache = _cache_layout(cfg, batch, cache_alloc_len(cfg, s_max))
    if rules is None:
        return cache
    return cache, _cache_shardings(cache, rules, shard_seq)


def _zero_cache(cfg: ModelConfig, batch: int, s: int, device: torch.device,
                rules: Optional[ShardingRules] = None,
                shard_seq: bool = False) -> DecodeCache:
    layout = _cache_layout(cfg, batch, s)
    sharded = rules is not None and rules.mesh is not None
    sh = _cache_shardings(layout, rules, shard_seq) if sharded else layout

    def zeros(t, h):
        if isinstance(t, SSMCache):
            return SSMCache(*(zeros(x, y) for x, y in zip(t, h)))
        if sharded:
            return zeros_sharded(t.shape, t.dtype, h, device)
        return torch.zeros(t.shape, dtype=t.dtype, device=device)

    return DecodeCache(*({k: zeros(t, hs[k]) for k, t in side.items()}
                         for side, hs in zip(layout, sh)))


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               device="cuda", rules: Optional[ShardingRules] = None,
               shard_seq: bool = False) -> DecodeCache:
    """Zeroed decode caches for a decode up to `s_max` positions (a vision
    model's image positions included): KV caches of cache_alloc_len slots
    and SSM conv buffers in cfg.dtype, SSM states in f32. With `rules`,
    DTensors laid out by `cache_specs`, only the local parts allocated."""
    return _zero_cache(cfg, batch, cache_alloc_len(cfg, s_max),
                       resolve_device(device), rules, shard_seq)


def _grow(small: torch.Tensor, s_alloc: int, ring: bool) -> torch.Tensor:
    """A (repeats, B, s0, ...) cache in a zeroed (repeats, B, s_alloc, ...)
    one, position p at slot p mod s_alloc (see `extend_cache`)."""
    s0 = small.shape[2]
    if s0 > s_alloc and not ring:
        raise ValueError(f"a prefill of {s0} positions does not fit a "
                         f"decode cache of {s_alloc}")
    first = max(0, s0 - s_alloc)          # the first position kept
    big = small.new_zeros((*small.shape[:2], s_alloc, *small.shape[3:]))
    big[:, :, :s0 - first] = small[:, :, first:]
    # Position `first` belongs at slot first mod s_alloc: roll the kept
    # run there.
    shift = first % s_alloc
    return big.roll(shift, dims=2) if shift else big


def extend_cache(cfg: ModelConfig, cache: DecodeCache,
                 s_max: int) -> DecodeCache:
    """The decode cache up to `s_max` that continues a prefill's `cache`.

    Each attention sub-layer's k and v over the prompt's s0 positions go
    into a zeroed (repeats, B, s_alloc, K, hd) cache, s_alloc =
    cache_alloc_len(cfg, s_max): position p at slot p mod s_alloc, where
    `attention_decode` looks for it. Without a window s_alloc is s_max and
    the slots are the positions. With one, s_alloc = min(s_max, window) is a
    ring, and when s0 > s_alloc only the last s_alloc positions are kept,
    the ones the window still covers. (The reference's `place` keeps the
    prefill's s0 slots as the ring whenever s_alloc < s_max, so with s0 <
    window decode overwrites positions the window still covers; ROADMAP.md
    Queue 3.) The SSM caches do not grow with the sequence and carry over
    as they are. A DTensor cache grows on each rank's own part, keeping
    its placements (its sequence gathered first if it was sharded)."""
    s_alloc = cache_alloc_len(cfg, s_max)
    ring = cfg.sliding_window is not None

    def grown(t: torch.Tensor) -> torch.Tensor:
        if not isinstance(t, DTensor):
            return _grow(t, s_alloc, ring)
        t = reshard(t, [Replicate() if p == Shard(2) else p
                        for p in t.placements])
        shape = (*t.shape[:2], s_alloc, *t.shape[3:])
        return wrap_local(_grow(t.to_local(), s_alloc, ring), t.device_mesh,
                          t.placements, shape)

    return DecodeCache({k: grown(t) for k, t in cache.attn_k.items()},
                       {k: grown(t) for k, t in cache.attn_v.items()},
                       cache.ssm)


def _put(stacked: torch.Tensor, r: int, value: torch.Tensor) -> None:
    """stacked[r] = value; for a DTensor on this rank's part, value laid
    out like stacked[r] first."""
    if not isinstance(stacked, DTensor):
        stacked[r] = value
        return
    pl = [Shard(p.dim - 1) if p.is_shard() else p
          for p in stacked.placements]
    stacked.to_local()[r].copy_(reshard(value, pl).to_local())


def decode_step(params, cfg: ModelConfig, cache: DecodeCache,
                tokens: torch.Tensor, cur_len: int, rules=None):
    """One decode step. tokens: (B, 1), or (B, K, 1) for audio, whole or
    (under rules) laid out over dp, each rank embedding its own rows;
    cur_len: the position of `tokens` (a Python int; after a vision
    prompt, its image positions count). Writes the new k, v and the SSM
    states into `cache` in place.

    Returns (logits (B, V) or (B, K, V), cache)."""
    params = _gather_head_params(params, cfg, rules)
    x = embed_inputs(params, cfg, {"tokens": tokens}, rules)
    for r in range(cfg.repeats):
        p_block = _gather_block_params(_layer(params["blocks"], r), cfg,
                                       rules)
        if rules is not None and rules.decode_feature_shard:
            x = rules.constrain(x, "dp", None, "fsdp")
        for i, sub in enumerate(cfg.pattern):
            key = f"sub_{i}"
            p = p_block[key]
            hn = L.rmsnorm(p["norm_mix"], x, cfg.rms_eps)
            if sub.kind == "attn":
                out, _, _ = L.attention_decode(
                    p["attn"], cfg, hn, cache.attn_k[key][r],
                    cache.attn_v[key][r], cur_len, rules)
            else:
                stacked = cache.ssm[key]
                out, new = ssm_block(
                    p["ssm"], cfg, hn, rules,
                    cache=SSMCache(stacked.conv[r], stacked.state[r]))
                # ssm_block built the shifted conv buffer and the state as
                # new tensors, so these copies never overlap their source.
                _put(stacked.conv, r, new.conv)
                _put(stacked.state, r, new.state)
            x, _ = _ffn(p, cfg, sub, x + out, rules)
    x = L.rmsnorm(params["final_norm"], x, cfg.rms_eps)
    logits = _logits(params, cfg, x)
    return logits[:, 0], cache


def prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            rules=None):
    """Process a full prompt; returns (last-position logits, cache).

    The cache covers the prompt span, (repeats, B, S, K, hd) in cfg.dtype
    per attention sub-layer, S counting a vision prompt's image positions
    (decode extends its own cache, `extend_cache`), and holds each SSM
    sub-layer's state and conv tail after the prompt. Under rules the
    cache is laid out by `cache_specs`.
    """
    params = _gather_head_params(params, cfg, rules)
    x = embed_inputs(params, cfg, batch, rules)
    b, s = x.shape[0], x.shape[1]
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    cache = _zero_cache(cfg, b, s, x.device,
                        rules if isinstance(x, DTensor) else None)
    for r in range(cfg.repeats):
        p_block = _gather_block_params(_layer(params["blocks"], r), cfg,
                                       rules)
        for i, sub in enumerate(cfg.pattern):
            key = f"sub_{i}"
            p = p_block[key]
            hn = L.rmsnorm(p["norm_mix"], x, cfg.rms_eps)
            if sub.kind == "attn":
                out, k, v = L.attention_with_kv(p["attn"], cfg, hn,
                                                positions, rules)
                _put(cache.attn_k[key], r, k)
                _put(cache.attn_v[key], r, v)
            else:
                out, new = ssm_block(p["ssm"], cfg, hn, rules,
                                     return_cache=True)
                _put(cache.ssm[key].conv, r, new.conv)
                _put(cache.ssm[key].state, r, new.state)
            x, _ = _ffn(p, cfg, sub, x + out, rules)
    x = L.rmsnorm(params["final_norm"], x[:, -1:], cfg.rms_eps)
    logits = _logits(params, cfg, x)
    return logits[:, -1], cache
