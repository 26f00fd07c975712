"""The one traffic generator: reads a mix's parameters from
``portbench/traffic/<name>.json`` and makes its inputs from the seed.

* ``"kind": "train"``: a stream of token rows, uniform over the
  vocabulary; optimizer step ``j`` takes rows of its own (``micro_batch *
  accum`` rows of ``seq_len + 1`` tokens: inputs and next-token labels).
* ``"kind": "prefill"``: a closed loop of one-prompt requests whose lengths
  are dealt from decks: each deck holds ``count`` prompts of each
  ``length`` of ``"deck"``, shuffled by the seed, so every deck gives the
  exact mix; request ``i``'s tokens are uniform over the vocabulary.

Every draw comes from a generator seeded by the run's seed and a tag of
its own, so a run's inputs can be made again, one by one, for the check.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np
import torch

DIR = Path(__file__).resolve().parent / "traffic"


def load(name: str) -> dict:
    return json.loads((DIR / f"{name}.json").read_text())


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for the draw ``tag`` of the run seeded ``seed``."""
    digest = hashlib.blake2b(f"{seed}/{tag}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, tag))


def tokens(seed: int, tag: str, shape: tuple[int, ...], vocab: int, device) -> torch.Tensor:
    return torch.randint(0, vocab, shape, generator=generator(seed, tag, device),
                         dtype=torch.int32, device=device)


def train_batch(traffic: dict, seed: int, step: int, vocab: int, device) -> dict:
    """Optimizer step ``step``'s batch: ``tokens`` and ``labels``, each
    (micro_batch * accum, seq_len)."""
    rows = traffic["micro_batch"] * traffic["accum"]
    t = tokens(seed, f"batch{step}", (rows, traffic["seq_len"] + 1), vocab, device)
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def deck(traffic: dict) -> list[int]:
    """One deck's prompt lengths, unshuffled."""
    return [length for length, count in traffic["deck"] for _ in range(count)]


class Lengths:
    """Request ``i``'s prompt length: decks dealt in a seeded order."""

    def __init__(self, traffic: dict, seed: int):
        self._deck = np.array(deck(traffic))
        self._rng = np.random.default_rng(derive(seed, "decks"))
        self._dealt: list[int] = []

    def __getitem__(self, i: int) -> int:
        while len(self._dealt) <= i:
            self._dealt += self._rng.permutation(self._deck).tolist()
        return self._dealt[i]


def prompt(seed: int, i: int, length: int, vocab: int, device) -> torch.Tensor:
    """Request ``i``'s prompt, (1, length)."""
    return tokens(seed, f"prompt{i}", (1, length), vocab, device)
