"""Data pipeline (port of ``repro.data.pipeline``): deterministic synthetic
streams and the input shapes of a cell.

* :func:`batch_struct` and :func:`decode_struct` give the shape and dtype
  of every model input of an (arch x shape) cell, as the reference's
  ``ShapeDtypeStruct`` stand-ins do, without allocating.
* :func:`synthetic_batch` fills the same structure from an explicit
  ``torch.Generator``.
* :class:`TokenStream` is the host-sharded training iterator: batch
  ``step`` on host ``host_id`` is drawn from a generator seeded from
  ``(seed, step, host_id)``, so any host can replay any step, which makes
  checkpoint/restart deterministic with no loader state to save.

The reference draws from JAX's threefry streams, which the port does not
reproduce (ROADMAP rule): the port's batches are deterministic and
host-sharded in the same way but hold other tokens, so parity tests hand
both sides the same numpy batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, NamedTuple

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig


class TensorSpec(NamedTuple):
    """The shape and dtype of one input (the reference's ``ShapeDtypeStruct``)."""

    shape: tuple[int, ...]
    dtype: torch.dtype


def _token_len(cfg: ModelConfig, seq_len: int) -> int:
    """Text-token length for a cell (frontends consume part of the cell's
    sequence budget; enc-dec caps the decoder)."""
    if cfg.is_encoder_decoder:
        return min(cfg.max_target_len, seq_len)
    if cfg.frontend == "vit_patches":
        return seq_len - cfg.frontend_tokens
    return seq_len


def batch_struct(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, TensorSpec]:
    """The inputs of a train or prefill batch."""
    b, s = shape.global_batch, shape.seq_len
    t = _token_len(cfg, s)
    out = {"tokens": TensorSpec((b, t), torch.int32)}
    if shape.kind == "train":
        out["labels"] = TensorSpec((b, t), torch.int32)
    if cfg.is_encoder_decoder:
        out["enc_frames"] = TensorSpec((b, s, cfg.d_model), torch.bfloat16)
    if cfg.frontend == "vit_patches":
        out["patch_embeds"] = TensorSpec((b, cfg.frontend_tokens, cfg.d_model), torch.bfloat16)
    return out


def decode_struct(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, TensorSpec]:
    """The inputs of one decode step."""
    return {
        "tokens": TensorSpec((shape.global_batch, 1), torch.int32),
        "pos": TensorSpec((), torch.int32),
    }


def synthetic_batch(
    cfg: ModelConfig,
    seq_len: int,
    batch: int,
    generator: torch.Generator,
    *,
    train: bool = True,
    device=DEFAULT_DEVICE,
) -> dict[str, torch.Tensor]:
    """A batch drawn from ``generator`` (a CPU generator, so a batch does
    not depend on the device it lands on): uniform tokens, next-token
    labels (the last one 0) and, for the frontends, 0.02-scaled normal
    inputs in bf16."""
    dev = resolve_device(device)
    t = _token_len(cfg, seq_len)
    tokens = torch.randint(0, cfg.vocab_size, (batch, t), generator=generator, dtype=torch.int32)
    out = {"tokens": tokens}
    if train:
        out["labels"] = torch.cat([tokens[:, 1:], torch.zeros((batch, 1), dtype=torch.int32)], 1)
    if cfg.is_encoder_decoder:
        out["enc_frames"] = (
            torch.randn((batch, seq_len, cfg.d_model), generator=generator) * 0.02
        ).to(torch.bfloat16)
    if cfg.frontend == "vit_patches":
        out["patch_embeds"] = (
            torch.randn((batch, cfg.frontend_tokens, cfg.d_model), generator=generator) * 0.02
        ).to(torch.bfloat16)
    return {k: v.to(dev) for k, v in out.items()}


def _step_seed(seed: int, step: int, host_id: int) -> int:
    """The generator seed of one (seed, step, host) batch."""
    return int(np.random.SeedSequence((seed, step, host_id)).generate_state(1, np.uint64)[0])


@dataclass
class TokenStream:
    """Deterministic, host-sharded synthetic token stream.

    Batch ``step`` on host ``host_id`` is a pure function of ``(seed,
    step, host_id)``: resuming after a failure or on a different host
    count replays identical data."""

    cfg: ModelConfig
    seq_len: int
    global_batch: int
    n_hosts: int = 1
    host_id: int = 0
    seed: int = 0
    device: str | torch.device = DEFAULT_DEVICE

    def __post_init__(self):
        if self.global_batch % self.n_hosts:
            raise ValueError(f"global batch {self.global_batch} does not split over "
                             f"{self.n_hosts} hosts")
        self.host_batch = self.global_batch // self.n_hosts
        self.device = resolve_device(self.device)

    def batch_at(self, step: int) -> dict[str, torch.Tensor]:
        gen = torch.Generator().manual_seed(_step_seed(self.seed, step, self.host_id))
        return synthetic_batch(self.cfg, self.seq_len, self.host_batch, gen, device=self.device)

    def __iter__(self) -> Iterator[dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
