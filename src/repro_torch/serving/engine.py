"""Serving: batched prefill + single-token decode over a KV cache.

Port of `repro/serving/engine.py`. Everything runs on the device the
parameters live on (`init_params` / `params_from_reference` put them on
the card unless asked for the CPU); there, every prefill attention layer
runs the flash-attention kernel. SSM sub-layers carry a fixed-size
recurrent state from the prefill into the decode instead of a KV cache.

After a vision prompt decode continues at position n_img + s0, behind the
image positions the prefill put first. The reference's `greedy_generate`
decodes from s0 and so writes its first steps over image positions
(ROADMAP.md Queue 3): it is no oracle for a prompt with images.

Under sharding rules the parameters are DTensors (`init_params(...,
rules=)`); a prompt is whole or laid out over dp, each rank embedding its
own rows. Each step's argmax runs on the rank's rows with their vocab
gathered (`_next_ids`), so the next ids stay laid out over dp; each
step's ids are gathered whole for the result (a stack of DTensors is
laid out wrong by the card's torch 2.11: its shard moves to the new
dim).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..models import transformer as T
from ..models.config import ModelConfig
from ..parallel.sharding import full, reshard, settled, wrap_local

PyTree = Any


def make_prefill(cfg: ModelConfig, rules=None):
    def prefill_fn(params, batch: Dict[str, torch.Tensor]):
        return T.prefill(params, cfg, batch, rules)
    return prefill_fn


def make_decode_step(cfg: ModelConfig, rules=None):
    def decode_fn(params, cache, tokens, cur_len):
        return T.decode_step(params, cfg, cache, tokens, cur_len, rules)
    return decode_fn


def _next_ids(logits: torch.Tensor) -> torch.Tensor:
    """The argmax over the last (vocab) dim. On a DTensor, of this rank's
    rows with their vocab gathered (no other rank's rows move), as a
    DTensor laid out like those rows."""
    if not isinstance(logits, DTensor):
        return torch.argmax(logits, dim=-1)
    logits = settled(logits)
    vdim = logits.ndim - 1
    rows = [Replicate() if p == Shard(vdim) else p for p in logits.placements]
    ids = torch.argmax(reshard(logits, rows).to_local(), dim=-1)
    return wrap_local(ids, logits.device_mesh, rows, logits.shape[:-1])


def greedy_generate(cfg: ModelConfig, params, prompt: Dict[str, torch.Tensor],
                    steps: int, s_max: int, rules=None) -> torch.Tensor:
    """Prefill the prompt, then greedily decode `steps` tokens.

    prompt["tokens"]: (B, S0) ids, or (B, K, S0) codes for audio; a vision
    prompt may add patch_embeds (B, S_img, d_frontend), which the prefill
    puts before the text. `s_max` counts every position, image ones
    included. Returns (B, steps + 1) int64 ids, or (B, K, steps + 1) for
    audio: the argmax after the prompt and after each decoded token."""
    s0 = T.prompt_len(cfg, prompt)
    logits, cache = T.prefill(params, cfg, prompt, rules)

    # Re-home the prefill's KV caches into larger decode caches; the SSM
    # caches carry over as they are.
    cache = T.extend_cache(cfg, cache, s_max)

    out = []
    cur = _next_ids(logits)          # (B,), or (B, K) for audio
    for t in range(steps):
        out.append(full(cur))
        logits, cache = T.decode_step(params, cfg, cache, cur[..., None],
                                      s0 + t, rules)
        cur = _next_ids(logits)
    out.append(full(cur))
    return torch.stack(out, dim=-1)
