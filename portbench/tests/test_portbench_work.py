"""The yardstick's arithmetic: PERF.md's least times of the chip_smoke
cells, and counts that do not change with the layer groups' recompute."""

from __future__ import annotations

import functools
import importlib
import json
from pathlib import Path

import pytest

from portbench import traffic as T
from portbench import work as W
from portbench.tests import _tiny

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
DANUBE = json.loads((CONFIGS / "h2o_danube_1_8b.json").read_text())
FALCON = json.loads((CONFIGS / "falcon_mamba_7b.json").read_text())


def _ms(seconds):
    return 1e3 * seconds


def test_danube_prefill_least_time():
    # PERF.md: danube prefill of 2 x 8,192 tokens, least time 67.75 ms (operations)
    work = W.prefill_work(DANUBE, 2, 8192)
    assert round(_ms(W.model_ops(work) / W.BF16_OPS_PER_S), 2) == 67.75


def test_falcon_prefill_least_time():
    # PERF.md: falcon prefill of 2 x 2,048 tokens, 63.44 ms: products 55.73 + 64 scans at
    # K2's bytes bound 7.71
    work = W.prefill_work(FALCON, 2, 2048)
    gemm = _ms(W.model_ops(work) / W.BF16_OPS_PER_S)
    scans = _ms(sum(w.bytes_s for w in work["k2"]))
    assert (round(gemm, 2), round(scans, 2), round(gemm + scans, 2)) == (55.73, 7.71, 63.44)


def test_danube_train_least_time_without_the_recompute():
    # PERF.md: danube training, 4 x 2,048 tokens in two micro-batches of 2, 94.24 ms
    # without the recompute; chip_smoke's train_step_ops also counted the 2 x 24 + 1 norm
    # scales as products (6 operations per scale and token, 0.0061 ms), which this count
    # leaves out
    ops = W.model_ops(W.train_work(DANUBE, 2, 2048, 2))
    norms = 6 * 4 * 2048 * (2 * DANUBE["n_layers"] + 1) * DANUBE["d_model"]
    assert round(_ms((ops + norms) / W.BF16_OPS_PER_S), 2) == 94.24


def test_attention_pairs_window():
    assert W.attention_pairs(8192, 8192, True, 4096) == 4096 * 4097 // 2 + 4096 * 4096
    assert W.attention_pairs(4096, 4096, True, 4096) == 4096 * 4097 // 2


@pytest.mark.parametrize("count", [W.prefill_work, W.train_work])
def test_a_family_without_a_module_is_refused(count):
    with pytest.raises(ValueError, match="moe"):
        count(dict(DANUBE, family="moe"), 1, 64, *([1] if count is W.train_work else []))


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_counts_do_not_move_with_the_recompute(family):
    """The benchmark's count is the model's: it equals the program's own
    count (``count_program``) of a step without the layer groups'
    recompute, once the scan's and the conv's elementwise operations, which
    ``mfu`` leaves out, are added; the program's count with the recompute
    is larger, the benchmark's the same."""
    from repro_torch.core.meshsig.counters import count_program
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.optim import adamw

    cfg = _tiny.CONFIGS[family]
    mcfg = _tiny.model_config(cfg)
    fam = importlib.import_module(f"portbench.families.{family}")
    tr = _tiny.TRAIN
    counted = {}
    for remat in (True, False):
        lm = M.train_mode(fam.build(mcfg, _tiny.leaves(fam, cfg)))
        opt = adamw.init(steps.param_tree(lm))
        step = steps.make_train_step(mcfg, accum=tr["accum"])
        batch = T.train_batch(tr, 1, 0, cfg["vocab_size"], "cpu")
        stack = M._stack
        M._stack = functools.partial(stack, remat=remat)
        try:
            counted[remat] = count_program(step, lm, opt, batch, 0, mode="observe").flops
        finally:
            M._stack = stack
    work = W.train_work(cfg, tr["micro_batch"], tr["seq_len"], tr["accum"])
    tokens = tr["micro_batch"] * tr["seq_len"] * tr["accum"]
    extra = 0.0
    if family == "ssm":
        di = cfg["ssm_expand"] * cfg["d_model"]
        conv = 3 * 2 * cfg["ssm_conv"] * di * tokens * cfg["n_layers"]
        extra = sum(w.ops for w in work["k2"]) + conv
    assert W.model_ops(work) + extra == counted[False]
    assert counted[True] > counted[False]
