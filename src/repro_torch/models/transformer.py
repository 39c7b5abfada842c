"""Full model, dense subset: embeddings + block stack + tied or untied head;
the training loss, and prefill and decode with KV caches.

Port of `repro/models/transformer.py`. Parameters keep the reference's dict
keys, with each pattern-repeat's weights stacked on a leading `repeats`
axis, so that carrying weights across is one-to-one
(`params_from_reference`). The reference scans over that axis; here a
Python loop walks it, one layer's views at a time. `loss_fn` rematerialises
each repeat's block in the backward (`torch.utils.checkpoint`, the
counterpart of the reference's `jax.checkpoint(..., nothing_saveable)`).

Not in this slice: MoE and SSM sub-layers, vision/audio frontends and
sharding rules raise NotImplementedError naming their ROADMAP.md item.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from . import layers as L
from .config import (FRONTENDS, MOE, PARALLEL, SSM, ModelConfig, SubLayer,
                     not_ported)

PyTree = Any


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------

def _check_supported(cfg: ModelConfig) -> None:
    """Raises for what the dense slice leaves out."""
    if cfg.frontend is not None:
        raise not_ported(f"{cfg.name}: the {cfg.frontend.modality} frontend",
                         FRONTENDS)
    if any(sub.kind != "attn" for sub in cfg.pattern):
        raise not_ported(f"{cfg.name}: SSM sub-layers", SSM)
    if any(sub.ffn == "moe" for sub in cfg.pattern):
        raise not_ported(f"{cfg.name}: MoE sub-layers", MOE)


def _sublayer_defs(cfg: ModelConfig, sub: SubLayer) -> Dict:
    defs: Dict[str, Any] = {"norm_mix": L.rmsnorm_defs(cfg.d_model),
                            "attn": L.attention_defs(cfg)}
    if sub.ffn == "mlp":
        defs["norm_ffn"] = L.rmsnorm_defs(cfg.d_model)
        defs["mlp"] = L.mlp_defs(cfg)
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
    _check_supported(cfg)
    d = cfg.d_model
    defs: Dict[str, Any] = {
        "embed": L.ParamDef((cfg.vocab_size, d), ("tp", "fsdp"), fan_in=d)}
    if not cfg.tie_embeddings:
        defs["head"] = L.ParamDef((d, cfg.vocab_size), ("fsdp", "tp"))
    block = {
        f"sub_{i}": _sublayer_defs(cfg, s) for i, s in enumerate(cfg.pattern)
    }
    defs["blocks"] = _stack_defs(block, cfg.repeats)
    defs["final_norm"] = L.rmsnorm_defs(d)
    return defs


def init_params(cfg: ModelConfig, seed: int, device="cuda") -> PyTree:
    """Random parameters, std = scale / sqrt(fan_in) per ParamDef, drawn
    from a torch.Generator seeded with `seed` on `device`. Not bit-equal to
    the reference's jax.random draw: parity tests carry the reference's
    weights across with `params_from_reference` instead."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return L.init_tree(gen, model_defs(cfg))


def params_from_reference(np_tree: PyTree, cfg: ModelConfig,
                          device="cuda") -> PyTree:
    """The reference's parameter pytree, as numpy arrays under its dict keys
    (``jax.tree.map(np.asarray, params)``), as the port's dict of tensors on
    `device`, each in its array's dtype. Keys and shapes are checked
    against `model_defs(cfg)`."""
    dev = resolve_device(device)

    def convert(tree, defs, path):
        if isinstance(defs, L.ParamDef):
            arr = np.array(tree)   # a copy: the port owns its weights
            if arr.shape != defs.shape:
                raise ValueError(f"{'/'.join(path)}: shape {arr.shape}, "
                                 f"expected {defs.shape}")
            if arr.dtype.name == "bfloat16":   # ml_dtypes, unknown to torch
                t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            return t.to(dev)
        if set(tree) != set(defs):
            raise ValueError(f"{'/'.join(path) or 'params'}: keys "
                             f"{sorted(tree)}, expected {sorted(defs)}")
        return {k: convert(tree[k], defs[k], path + (k,)) for k in defs}

    return convert(np_tree, model_defs(cfg), ())


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


# ---------------------------------------------------------------------------
# Input embedding and head
# ---------------------------------------------------------------------------

def embed_inputs(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                 rules=None) -> torch.Tensor:
    _check_supported(cfg)
    if rules is not None:
        raise not_ported("rules=", PARALLEL)
    tokens = batch["tokens"].to(params["embed"].device)
    return params["embed"][tokens].to(L.torch_dtype(cfg.dtype))


def _logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    return x @ head.to(x.dtype)


def _ffn(p, cfg: ModelConfig, sub: SubLayer, h: torch.Tensor) -> torch.Tensor:
    if sub.ffn == "none":
        return h
    hn = L.rmsnorm(p["norm_ffn"], h, cfg.rms_eps)
    return h + L.mlp(p["mlp"], cfg, hn)


# ---------------------------------------------------------------------------
# Blocks and the training forward (loss)
# ---------------------------------------------------------------------------

def _apply_sublayer(p, cfg: ModelConfig, sub: SubLayer, x: torch.Tensor,
                    positions: torch.Tensor, rules,
                    check_positions: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One attention sub-layer and its FFN; returns (x, aux), aux being the
    MoE router loss, 0 in the dense slice."""
    h = L.rmsnorm(p["norm_mix"], x, cfg.rms_eps)
    x = x + L.attention(p["attn"], cfg, h, positions, rules, check_positions)
    return _ffn(p, cfg, sub, x), x.new_zeros((), dtype=torch.float32)


def _block(p_block, cfg: ModelConfig, x: torch.Tensor,
           positions: torch.Tensor, rules, check_positions: bool = True
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    aux_total = x.new_zeros((), dtype=torch.float32)
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
    block there (no RNG runs inside a block, so its state is not kept)."""
    def block(p, h):
        return _block(p, cfg, h, positions, rules, check_positions)

    aux = x.new_zeros((), dtype=torch.float32)
    for p_block in _unstack(params["blocks"]):
        if remat:
            x, a = checkpoint(block, p_block, x, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, a = block(p_block, x)
        aux = aux + a
    return x, aux


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            rules=None, remat: bool = True
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy, mean(logsumexp(logits) - logit[label])
    over every position in f32. batch: tokens (B, S) and labels (B, S)
    ids. Returns (ce + aux, {"ce": ce, "aux": aux}), aux a 0-d f32 zero
    (the router loss of the MoE layers this slice leaves out).

    The positions are 0..S-1 in every row by construction, so the kernel's
    attention step skips its check (and its host sync)."""
    x = embed_inputs(params, cfg, batch, rules)
    b, s = x.shape[0], x.shape[1]
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    x, aux = _run_blocks(params, cfg, x, positions, rules, remat,
                         check_positions=False)
    x = L.rmsnorm(params["final_norm"], x, cfg.rms_eps)
    logits = _logits(params, cfg, x).to(torch.float32)
    labels = batch["labels"].to(device=logits.device, dtype=torch.int64)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    ce = torch.mean(lse - ll)
    return ce + aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Serving: prefill + decode with caches
# ---------------------------------------------------------------------------

class DecodeCache(NamedTuple):
    """Stacked (repeats, B, S_alloc, K, hd) caches per attention sub-layer
    (keys "sub_<i>"); `ssm` stays empty in the dense slice."""
    attn_k: Dict
    attn_v: Dict
    ssm: Dict


def cache_alloc_len(cfg: ModelConfig, s_max: int) -> int:
    """SWA archs keep a ring buffer of the window size (see attention_decode)."""
    if cfg.sliding_window is not None:
        return min(s_max, cfg.sliding_window)
    return s_max


def _zero_cache(cfg: ModelConfig, batch: int, s: int,
                device: torch.device) -> DecodeCache:
    _check_supported(cfg)
    shape = (cfg.repeats, batch, s, cfg.num_kv_heads, cfg.resolved_head_dim)
    dtype = L.torch_dtype(cfg.dtype)
    keys = [f"sub_{i}" for i in range(len(cfg.pattern))]
    return DecodeCache(
        {k: torch.zeros(shape, dtype=dtype, device=device) for k in keys},
        {k: torch.zeros(shape, dtype=dtype, device=device) for k in keys},
        {})


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               device="cuda") -> DecodeCache:
    """Zeroed decode caches in cfg.dtype for a decode up to `s_max`."""
    return _zero_cache(cfg, batch, cache_alloc_len(cfg, s_max),
                       resolve_device(device))


def decode_step(params, cfg: ModelConfig, cache: DecodeCache,
                tokens: torch.Tensor, cur_len: int, rules=None):
    """One decode step. tokens: (B, 1); cur_len: the position of `tokens`
    (a Python int). Writes the new k, v into `cache` in place.

    Returns (logits (B, V), cache)."""
    x = embed_inputs(params, cfg, {"tokens": tokens}, rules)
    for r in range(cfg.repeats):
        p_block = _layer(params["blocks"], r)
        for i, sub in enumerate(cfg.pattern):
            key = f"sub_{i}"
            p = p_block[key]
            hn = L.rmsnorm(p["norm_mix"], x, cfg.rms_eps)
            out, _, _ = L.attention_decode(
                p["attn"], cfg, hn, cache.attn_k[key][r],
                cache.attn_v[key][r], cur_len)
            x = _ffn(p, cfg, sub, x + out)
    x = L.rmsnorm(params["final_norm"], x, cfg.rms_eps)
    logits = _logits(params, cfg, x)
    return logits[:, 0], cache


def prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            rules=None):
    """Process a full prompt; returns (last-position logits, cache).

    The cache covers the prompt span, (repeats, B, S, K, hd) in cfg.dtype
    per attention sub-layer; decode extends its own cache.
    """
    x = embed_inputs(params, cfg, batch, rules)
    b, s = x.shape[0], x.shape[1]
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    cache = _zero_cache(cfg, b, s, x.device)
    for r in range(cfg.repeats):
        p_block = _layer(params["blocks"], r)
        for i, sub in enumerate(cfg.pattern):
            key = f"sub_{i}"
            p = p_block[key]
            hn = L.rmsnorm(p["norm_mix"], x, cfg.rms_eps)
            out, k, v = L.attention_with_kv(p["attn"], cfg, hn, positions)
            cache.attn_k[key][r] = k
            cache.attn_v[key][r] = v
            x = _ffn(p, cfg, sub, x + out)
    x = L.rmsnorm(params["final_norm"], x[:, -1:], cfg.rms_eps)
    logits = _logits(params, cfg, x)
    return logits[:, -1], cache
