"""The port's layer-group rematerialisation (``models.model._stack``,
the reference's ``jax.checkpoint`` of each scan body in ``_run_stack``)
on the CPU, in one process: numpy-seeded inputs and ``meta`` tensors, no
gloo, no JAX.

* In float32 the loss and every leaf's gradient with remat equal
  ``remat=False`` bit for bit, at accum 1 and 2, on five reduced archs
  (dense, two-layer groups, MoE, the eight-layer hybrid group, the
  encoder-decoder); the kernels' forwards run twice for each backward,
  and the MoE's dropped assignments are tallied once.
* A recompute runs under its forward's thread state: on a layout-only
  16 x 16 mesh the backward of reduced jamba runs on a thread of its own
  (as a card's does), its recompute saves what the forward saved
  (checkpoint's check of every recomputed tensor raises otherwise) and
  its collectives reach the forward's recording, the balance loss's mean
  over the rows' axes among them.
* The counter source sees the recompute (K1's and K2's forwards twice a
  backward, a lower peak), and a full-size ``train_4k`` rank of
  mixtral-8x22b fits a card.

``remat=False`` is reached through the private parameter, as the
reference's own ``remat`` is private.
"""

import collections
import contextlib
import dataclasses
import functools
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.launch import dryrun, steps
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as M
from repro_torch.models import moe as moe_mod
from repro_torch.parallel import context as ctx

META = torch.device("meta")
B, S, FRAMES = 4, 24, 40


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny tensors: one intra-op thread, so a loaded host does not stall
    every op on its slowest thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def no_remat():
    """Every stack runs without remat inside."""
    stack = M._stack
    M._stack = functools.partial(stack, remat=False)
    try:
        yield
    finally:
        M._stack = stack


def _batch(cfg):
    rng = np.random.default_rng(1)
    tok = rng.integers(0, cfg.vocab_size, (B, S + 1))
    batch = {"tokens": torch.as_tensor(tok[:, :-1]), "labels": torch.as_tensor(tok[:, 1:])}
    if cfg.is_encoder_decoder:
        frames = rng.standard_normal((B, FRAMES, cfg.d_model)).astype(np.float32)
        batch["enc_frames"] = torch.as_tensor(frames)
    return batch


def _grads(cfg, batch, accum):
    """``(loss, {name: gradient}, kernels' call counts, dropped (token,
    expert) assignments)`` of one gradient computation from the same
    seeded parameters."""
    params = M.train_mode(M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu"))
    with ctx.record("observe") as rec, moe_mod.drop_tally() as drops:
        grads, loss, _ = steps._grads(cfg, params, steps._micro_batches(batch, accum))
    return (loss, grads, collections.Counter(w.name for w in rec.kernels),
            [int(d) for d in drops])


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ["llama3-8b", "gemma2-9b", "mixtral-8x22b",
                                  "jamba-1.5-large-398b", "whisper-medium"])
def test_remat_loss_and_gradients_equal_no_remat_bit_for_bit(arch, accum):
    cfg = dataclasses.replace(get_config(arch).reduced(), compute_dtype="float32")
    batch = _batch(cfg)
    loss, grads, calls, drops = _grads(cfg, batch, accum)
    with no_remat():
        want_loss, want, want_calls, want_drops = _grads(cfg, batch, accum)
    assert torch.equal(loss, want_loss), (loss, want_loss)
    # the recompute routes again but tallies no drop a second time
    assert drops == want_drops and len(drops) == accum * sum(
        M.slot_kinds(cfg, i % cfg.group_size)[2] == "moe" for i in range(cfg.n_layers))
    assert grads.keys() == want.keys()
    for name, g in want.items():
        assert torch.equal(grads[name], g), name
    # every forward kernel runs again in its group's recompute
    for k in ("flash_attention", "selective_scan"):
        assert calls[k] == 2 * calls[f"{k}_bwd"] == 2 * want_calls[k]
        assert want_calls[k] == want_calls[f"{k}_bwd"]
    assert calls["flash_attention"] > 0


def _jamba_on_a_16x16_layout(backward_on_a_thread: bool):
    """Rank 0's loss of reduced jamba on a layout-only 16 x 16 mesh under
    the training cell's rules, on ``meta``; its backward on this thread or
    on a new one that holds no state.  Returns the forward's and the
    backward's collectives, the kernels called and the gradients."""
    cfg = get_config("jamba-1.5-large-398b").reduced()
    mesh = ctx.Mesh(("data", "model"), (16, 16), 0)
    with mesh_lib.cell_context(mesh, cfg, ShapeConfig("t", S, B, "train")):
        params = M.train_mode(mesh_lib.shard_params(
            cfg, M.init_params(cfg, torch.Generator(), device=META)))
        batch = {k: torch.empty((16, S), dtype=torch.int64, device=META)
                 for k in ("tokens", "labels")}
        with ctx.record("simulate") as rec:
            loss, _ = M.loss_fn(cfg, M.cast_for_compute(cfg, params), batch, cast=False)
            n_forward = len(rec.collectives)
            errors = []

            def backward():
                try:
                    loss.backward()
                except BaseException as e:  # reported by the caller
                    errors.append(e)

            if backward_on_a_thread:
                t = threading.Thread(target=backward)
                t.start()
                t.join(timeout=120)
            else:
                backward()
    assert not errors, errors
    grads = {n: p.grad for n, p in params.named_parameters()}
    return (cfg, rec.collectives[:n_forward], rec.collectives[n_forward:],
            collections.Counter(w.name for w in rec.kernels), grads)


def test_recompute_runs_under_the_forwards_state_on_another_thread():
    cfg, forward, backward, calls, grads = _jamba_on_a_16x16_layout(True)
    with no_remat():
        _, want_forward, want_backward, want_calls, want_grads = _jamba_on_a_16x16_layout(False)
    assert forward == want_forward
    for name, g in want_grads.items():
        assert (grads[name].shape, grads[name].dtype) == (g.shape, g.dtype), name
    # the backward is the same but for the recomputed forwards' collectives
    extra = collections.Counter(backward) - collections.Counter(want_backward)
    assert not collections.Counter(want_backward) - collections.Counter(backward)
    assert extra and not extra - collections.Counter(forward)
    # among them each MoE layer's balance-loss mean over the rows' axes
    # (data, set only inside the forward's row context) but the groups'
    # last layers', which the recompute stops before
    moe_inside = sum(M.slot_kinds(cfg, s)[2] == "moe" for s in range(cfg.group_size - 1))
    aux_mean = ctx.CollectiveRecord("all-reduce", "sum", ("data",), 16, 4, "float32")
    assert extra[aux_mean] == cfg.n_groups * moe_inside > 0
    for k in ("flash_attention", "selective_scan"):
        assert calls[k] == 2 * calls[f"{k}_bwd"] == 2 * want_calls[k] > 0


@pytest.mark.parametrize("arch,kernel", [("h2o-danube-1.8b", "flash_attention"),
                                         ("falcon-mamba-7b", "selective_scan")])
def test_counted_train_step_recomputes_and_peaks_lower(arch, kernel):
    cfg = get_config(arch).reduced()
    mesh = ctx.Mesh(("data", "model"), (1, 1), 0)
    shape = ShapeConfig("t", 512, 4, "train")
    remat, meta = dryrun.profile_cell(cfg, shape, mesh)
    with no_remat():
        plain, _ = dryrun.profile_cell(cfg, shape, mesh)
    assert meta["accum"] == 2
    calls, bwd = remat.kernels[kernel]["calls"], remat.kernels[f"{kernel}_bwd"]["calls"]
    assert calls == 2 * bwd == 2 * plain.kernels[kernel]["calls"] == 2 * 2 * cfg.n_layers
    assert remat.flops > plain.flops
    assert remat.memory["temp_size_in_bytes"] < plain.memory["temp_size_in_bytes"]
    assert remat.memory["argument_size_in_bytes"] == plain.memory["argument_size_in_bytes"]


def test_full_size_mixtral_train_4k_rank_fits_a_card():
    """Rank 0 of the 16 x 16 mesh, 2 x 4,096 tokens a micro-batch: 112.16
    GiB with every activation kept, under a card with remat."""
    counters, meta = dryrun.profile_cell(get_config("mixtral-8x22b"), dryrun.SHAPES["train_4k"],
                                         dryrun.layout_mesh("single"))
    assert meta["accum"] == 8
    assert dryrun.peak_bytes({"memory": counters.memory}) < mesh_lib.NOMINAL_CARD_BYTES
