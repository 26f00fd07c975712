"""Serving step functions (port of ``repro.launch.steps``).

``make_prefill_step(cfg)`` returns ``(params, batch) -> last-position
logits``; ``make_decode_step(cfg)`` returns ``(params, cache, tokens,
pos) -> (next_token, logits, cache)`` with greedy argmax; with
``cast=False`` its params must already be as ``cast_for_compute`` returns
them (a decode loop casts once).  Both run without autograd.  The training step waits for the training slice
(ROADMAP §1 P14).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M


def make_prefill_step(cfg: ModelConfig) -> Callable:
    @torch.no_grad()
    def prefill_step(params, batch):
        return M.prefill(cfg, params, batch)

    return prefill_step


def make_decode_step(cfg: ModelConfig, *, cast: bool = True) -> Callable:
    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        logits, new_cache = M.decode_step(cfg, params, cache, tokens, pos, cast=cast)
        # torch.argmax returns the first maximal index, as jnp.argmax does
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_token, logits, new_cache

    return serve_step
