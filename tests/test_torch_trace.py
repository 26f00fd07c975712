"""The port's spans (``repro_torch.runtime.trace``) on the CPU, no JAX:

* with no profiler ``span`` is one shared no-op and no span is entered;
* under ``torch.profiler`` a dense train step (accum 2) records one
  ``train_step``, ``cast`` and ``optimizer``, a ``recompute`` per layer
  group and micro-batch and a ``cast.backward`` per cast leaf and
  micro-batch; a mamba prefill records one ``mamba.conv`` a layer;
* the loss, the gradients, the updated leaves and AdamW's moments are the
  same bits with the profiler on and off, and with the training cast's
  own autograd Function and with ``Tensor.to``.
"""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.base import get_config, torch_dtype
from repro_torch.launch import steps
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.runtime import trace as T

B, S, ACCUM = 4, 16, 2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(cfg):
    tok = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S + 1))
    return {"tokens": torch.as_tensor(tok[:, :-1]), "labels": torch.as_tensor(tok[:, 1:])}


def _train(cfg, profiled: bool = False) -> dict:
    """One gradient computation and one train step from the same seeded
    parameters: every tensor they give, by name."""
    out = {}
    params = M.train_mode(M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu"))
    micros = steps._micro_batches(_batch(cfg), ACCUM)
    step = steps.make_train_step(cfg, accum=ACCUM)
    with profile(activities=[ProfilerActivity.CPU]) if profiled else T.OFF:
        grads, loss, _ = steps._grads(cfg, params, micros)
        out.update({f"grad.{n}": g.clone() for n, g in grads.items()}, loss=loss)
        for p in params.parameters():
            p.grad = None
        opt = adamw.init(steps.param_tree(params), cfg.moment_dtype)
        params, opt, metrics = step(params, opt, _batch(cfg), 0)
    out.update({f"param.{n}": p.detach() for n, p in params.named_parameters()},
               step_loss=metrics["loss"], grad_norm=metrics["grad_norm"])
    out.update({f"m.{i}": m for i, m in enumerate(adamw._leaves(opt.m))})
    out.update({f"v.{i}": v for i, v in enumerate(adamw._leaves(opt.v))})
    return out


def _assert_same_bits(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def _spans(prof) -> collections.Counter:
    return collections.Counter(e.name[len(T.PREFIX):] for e in prof.events()
                               if e.name.startswith(T.PREFIX))


def test_no_profiler_no_span(monkeypatch):
    assert T.span("train_step") is T.span("mamba.conv") is T.OFF

    def entered(name):
        raise AssertionError(f"span {name} entered with no profiler")

    monkeypatch.setattr(T, "record_function", entered)
    cfg = get_config("h2o-danube-1.8b").reduced()
    params = M.train_mode(M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu"))
    opt = adamw.init(steps.param_tree(params), cfg.moment_dtype)
    steps.make_train_step(cfg, accum=ACCUM)(params, opt, _batch(cfg), 0)
    ssm = get_config("falcon-mamba-7b").reduced()
    lm = M.init_params(ssm, torch.Generator().manual_seed(0), device="cpu")
    steps.make_prefill_step(ssm)(lm, {"tokens": _batch(ssm)["tokens"]})


def test_spans_under_the_profiler():
    cfg = get_config("h2o-danube-1.8b").reduced()
    params = M.train_mode(M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu"))
    compute = torch_dtype(cfg.compute_dtype)
    cast = sum(not M._keeps_f32(n) and p.dtype != compute for n, p in params.named_parameters())
    opt = adamw.init(steps.param_tree(params), cfg.moment_dtype)
    step = steps.make_train_step(cfg, accum=ACCUM)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, opt, _batch(cfg), 0)
    assert cast > 0 and _spans(prof) == {"train_step": 1, "cast": 1, "optimizer": 1,
                                         "recompute": cfg.n_groups * ACCUM,
                                         "cast.backward": cast * ACCUM}
    ssm = get_config("falcon-mamba-7b").reduced()
    lm = M.init_params(ssm, torch.Generator().manual_seed(0), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        steps.make_prefill_step(ssm)(lm, {"tokens": _batch(ssm)["tokens"]})
    assert _spans(prof) == {"prefill": 1, "cast": 1, "mamba.conv": ssm.n_layers}


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "falcon-mamba-7b"])
def test_same_bits_with_the_profiler_on_and_off(arch):
    cfg = get_config(arch).reduced()
    _assert_same_bits(_train(cfg, profiled=True), _train(cfg))


def test_cast_function_gives_the_bits_of_to(monkeypatch):
    cfg = get_config("h2o-danube-1.8b").reduced()
    params = M.train_mode(M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu"))
    compute = M.cast_for_compute(cfg, params)
    assert type(compute.lm_head.grad_fn).__name__ == "_CastToComputeBackward"
    want = _train(cfg)
    monkeypatch.setattr(M._CastToCompute, "apply", lambda p, dtype: p.to(dtype))
    compute = M.cast_for_compute(cfg, params)
    assert type(compute.lm_head.grad_fn).__name__ == "ToCopyBackward0"
    _assert_same_bits(want, _train(cfg))


@pytest.mark.parametrize("dropless", [False, True])
def test_moe_spans_under_the_profiler(dropless):
    """Reduced jamba's prefill (capacity path) and the same with the
    dropless grouped path: one ``moe.route``, ``moe.experts`` and
    ``moe.combine`` an MoE layer, and the same logits' bits with the
    profiler on and off."""
    import dataclasses

    cfg = dataclasses.replace(get_config("jamba-1.5-large-398b").reduced(),
                              moe_dropless=dropless)
    lm = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    step = steps.make_prefill_step(cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = step(lm, {"tokens": _batch(cfg)["tokens"]})
    moe = sum(M.slot_kinds(cfg, i % cfg.group_size)[2] == "moe" for i in range(cfg.n_layers))
    mamba = sum(M.slot_kinds(cfg, i % cfg.group_size)[0] == "mamba" for i in range(cfg.n_layers))
    assert moe > 0 and _spans(prof) == {"prefill": 1, "cast": 1, "mamba.conv": mamba,
                                        "moe.route": moe, "moe.experts": moe,
                                        "moe.combine": moe}
    assert torch.equal(traced, step(lm, {"tokens": _batch(cfg)["tokens"]}))
