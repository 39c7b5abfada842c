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
rules=)`), prompts are whole on every rank, and each step's logits are
gathered for the argmax, so every rank holds the same ids.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..models import transformer as T
from ..models.config import ModelConfig
from ..parallel.sharding import full

PyTree = Any


def make_prefill(cfg: ModelConfig, rules=None):
    def prefill_fn(params, batch: Dict[str, torch.Tensor]):
        return T.prefill(params, cfg, batch, rules)
    return prefill_fn


def make_decode_step(cfg: ModelConfig, rules=None):
    def decode_fn(params, cache, tokens, cur_len):
        return T.decode_step(params, cfg, cache, tokens, cur_len, rules)
    return decode_fn


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
    cur = torch.argmax(full(logits), dim=-1)  # (B,), or (B, K) for audio
    for t in range(steps):
        out.append(cur)
        logits, cache = T.decode_step(params, cfg, cache, cur[..., None],
                                      s0 + t, rules)
        cur = torch.argmax(full(logits), dim=-1)
    out.append(cur)
    return torch.stack(out, dim=-1)
