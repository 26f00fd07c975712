"""The generator: exact mixes from the decks, inputs fixed by the seed."""

from __future__ import annotations

from collections import Counter

import pytest
import torch

from portbench import traffic as T

SEEDS = [0, 1, 7, 2**31 - 1, 2**31 + 12345, 3 * 2**31 + 1]


@pytest.mark.parametrize("name", ["prefill_mix_1k_8k", "prefill_mix_2k_16k"])
@pytest.mark.parametrize("seed", SEEDS)
def test_every_deck_has_the_exact_mix(name, seed):
    mix = T.load(name)
    lengths = T.Lengths(mix, seed)
    size = len(T.deck(mix))
    want = Counter(T.deck(mix))
    for d in range(6):
        assert Counter(lengths[d * size + i] for i in range(size)) == want


def test_seed_fixes_the_order_and_tokens():
    mix = T.load("prefill_mix_1k_8k")
    a, b, c = T.Lengths(mix, 5), T.Lengths(mix, 5), T.Lengths(mix, 6)
    assert [a[i] for i in range(40)] == [b[i] for i in range(40)]
    assert [a[i] for i in range(40)] != [c[i] for i in range(40)]
    seed = 2**31 + 3
    assert torch.equal(T.prompt(seed, 4, 33, 100, "cpu"), T.prompt(seed, 4, 33, 100, "cpu"))
    assert not torch.equal(T.prompt(seed, 4, 33, 100, "cpu"), T.prompt(seed, 5, 33, 100, "cpu"))


def test_train_rows_differ_from_step_to_step():
    mix = dict(T.load("train_4k"), seq_len=16)
    b0, b1 = (T.train_batch(mix, 9, j, 1000, "cpu") for j in (0, 1))
    assert b0["tokens"].shape == (mix["micro_batch"] * mix["accum"], 16)
    assert torch.equal(b0["tokens"][:, 1:], b0["labels"][:, :-1])
    assert not torch.equal(b0["tokens"], b1["tokens"])
