"""The port's training path against the reference, on reduced configs:
``loss_fn`` and its parts, the gradients of every leaf (compared through
``lm_params_to_reference`` against ``jax.grad``), one ``make_train_step``
step and a three-step loss history with accum 1 and 2, the data pipeline,
and the training CLI on the CPU.

Every comparison runs in float32 compute from the reference's
``init_params`` tree (carried over by ``lm_params_from_reference``) and a
numpy-seeded batch handed to both sides.  Tolerances: loss rel 1e-5,
gradients rel 1e-4 of each leaf's largest magnitude, histories rel 1e-4.
Archs with a mamba slot hold 2e-2 against the reference as it is: its
training scan stores its states in bf16 even at float32 compute
(``repro/models/mamba.py``, ROADMAP §3), the port's scan is float32.  In
jamba, whose MoE routing feeds its mamba states, that rounding flips
expert choices and moves the reference's gradient norm by 2.4-6.8% over
three steps, so the mamba archs are also held, at the float32 tolerances,
against the reference with that one storage dtype made float32 by a
test-time shim (``_f32_scan``; no file of the JAX package changes): there
the port agrees to about 1e-6.  The attention core is K1's plain forward
and backward (the CPU path of ``mha_flash``), the scan K2's.
"""

import dataclasses
import functools
import subprocess
import sys
from pathlib import Path

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.mamba as ref_mamba

from _torch_parity import assert_rel_to_scale
from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import get_config as ref_get_config
from repro.data import pipeline as ref_pipeline
from repro.launch import steps as ref_steps
from repro.models import model as RM
from repro.optim import adamw as ref_adamw
from repro_torch.configs.base import SHAPES, get_config
from repro_torch.convert import lm_params_from_reference, lm_params_to_reference
from repro_torch.data import pipeline
from repro_torch.launch import steps
from repro_torch.models import model as M
from repro_torch.optim import adamw

ROOT = Path(__file__).resolve().parents[1]
B, S = 4, 24
LOSS_RTOL, GRAD_RTOL, HISTORY_RTOL = 1e-5, 1e-4, 1e-4
MAMBA_TOL = 2e-2
LR = 3e-3


def _has_mamba(cfg) -> bool:
    return any(M.slot_kinds(cfg, s)[0] == "mamba" for s in range(cfg.group_size))


@functools.lru_cache(maxsize=None)
def _case(name):
    """(reference config, port config, reference tree, numpy batch)."""
    rcfg = dataclasses.replace(ref_get_config(name).reduced(), compute_dtype="float32")
    pcfg = dataclasses.replace(get_config(name).reduced(), compute_dtype="float32")
    tree = jax.tree.map(np.asarray, RM.init_params(rcfg, jax.random.PRNGKey(0)))
    tok = np.random.default_rng(1).integers(0, rcfg.vocab_size, (B, S + 1)).astype(np.int32)
    return rcfg, pcfg, tree, {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def _port(pcfg, tree):
    return M.train_mode(lm_params_from_reference(pcfg, tree, device="cpu"))


def _torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _rel(got, want) -> float:
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


@functools.lru_cache(maxsize=None)
def _ref_value_and_grad(name):
    rcfg, _, tree, batch = _case(name)
    fn = jax.jit(jax.value_and_grad(lambda p, b: RM.loss_fn(rcfg, p, b), has_aux=True))
    (loss, parts), grads = fn(tree, batch)
    return float(loss), {k: float(v) for k, v in parts.items()}, jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("name", ["llama3-8b", "gemma2-9b", "qwen3-moe-30b-a3b",
                                  "falcon-mamba-7b"])
def test_loss_fn_matches_reference(name):
    _, pcfg, tree, batch = _case(name)
    want, want_parts, _ = _ref_value_and_grad(name)
    with torch.no_grad():
        loss, parts = M.loss_fn(pcfg, _port(pcfg, tree), _torch_batch(batch))
    tol = MAMBA_TOL if _has_mamba(pcfg) else LOSS_RTOL
    assert set(parts) == set(want_parts) == {"nll", "aux", "lse"}
    assert _rel(loss, want) <= tol, (float(loss), want)
    for k in ("nll", "lse"):
        assert _rel(parts[k], want_parts[k]) <= tol, (k, float(parts[k]), want_parts[k])
    assert abs(float(parts["aux"]) - want_parts["aux"]) <= tol * max(1.0, abs(want_parts["aux"]))


def test_loss_fn_masks_the_padded_vocab():
    """A label past ``vocab_size`` sees -1e30, so the padded rows add
    nothing to the log-sum-exp: raising their logits changes no loss."""
    _, pcfg, tree, batch = _case("llama3-8b")
    pcfg = dataclasses.replace(pcfg, vocab_size=500)  # padded to the tree's 512 rows
    assert pcfg.padded_vocab == tree["lm_head"].shape[1] > pcfg.vocab_size
    batch = {k: torch.as_tensor(v % pcfg.vocab_size) for k, v in batch.items()}
    lm = _port(pcfg, tree)
    with torch.no_grad():
        base, _ = M.loss_fn(pcfg, lm, batch)
        lm.lm_head[:, pcfg.vocab_size:] += 100.0
        moved, _ = M.loss_fn(pcfg, lm, batch)
    assert float(base) == float(moved)


@pytest.mark.parametrize("name", ["llama3-8b", "gemma2-9b", "qwen3-moe-30b-a3b"])
def test_gradients_match_reference(name):
    """Every leaf's gradient, dense, SWA with soft-caps (gemma2: window 32
    < S is not reached at S=24, the caps are) and MoE (router, experts,
    balance loss)."""
    _, pcfg, tree, batch = _case(name)
    _, _, want = _ref_value_and_grad(name)
    lm = _port(pcfg, tree)
    loss, _ = M.loss_fn(pcfg, lm, _torch_batch(batch))
    loss.backward()
    got = lm_params_to_reference(pcfg, {n: p.grad for n, p in lm.named_parameters()})
    got_flat = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    want_flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert set(got_flat) == {p for p, _ in want_flat}
    for path, g in want_flat:
        assert_rel_to_scale(got_flat[path], g, rtol=GRAD_RTOL, what=jax.tree_util.keystr(path))


def test_gradients_reach_master_leaves_in_float32_through_a_bf16_cast():
    """bf16 compute: the cast is differentiable, every trainable leaf gets
    a float32 gradient, and a no-grad forward still casts into detached
    inference leaves (the serving path)."""
    name = "h2o-danube-1.8b"
    _, pcfg, tree, batch = _case(name)
    cfg16 = dataclasses.replace(pcfg, compute_dtype="bfloat16")
    lm = _port(cfg16, tree)
    loss, _ = M.loss_fn(cfg16, lm, _torch_batch(batch))
    loss.backward()
    for n, p in lm.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, n
        assert bool(torch.isfinite(p.grad).all()), n
    with torch.no_grad():
        cast = M.cast_for_compute(cfg16, lm)
    assert cast is not lm
    assert cast.layers[0].mixer.wq.dtype == torch.bfloat16
    assert not cast.layers[0].mixer.wq.requires_grad
    assert cast.layers[0].norm1 is lm.layers[0].norm1


def _history(name, accum, n_steps):
    """Both sides' metrics over ``n_steps`` steps on one batch."""
    rcfg, pcfg, tree, batch = _case(name)
    # no warm-up: every step moves the weights
    rstep = jax.jit(ref_steps.make_train_step(
        rcfg, accum=accum, lr_schedule=ref_adamw.cosine_schedule(LR, 0, n_steps)))
    pstep = steps.make_train_step(pcfg, accum=accum,
                                  lr_schedule=adamw.cosine_schedule(LR, 0, n_steps))
    rp, ro = tree, ref_adamw.init(tree, rcfg.moment_dtype)
    lm = _port(pcfg, tree)
    po = adamw.init(steps.param_tree(lm), pcfg.moment_dtype)
    tb = _torch_batch(batch)
    ref_hist, port_hist = [], []
    for s in range(n_steps):
        rp, ro, rm = rstep(rp, ro, batch, jnp.asarray(s, jnp.int32))
        lm, po, pm = pstep(lm, po, tb, s)
        ref_hist.append({k: float(v) for k, v in rm.items()})
        port_hist.append({k: float(v) for k, v in pm.items()})
    assert int(po.step) == n_steps
    return ref_hist, port_hist, pcfg


def _assert_history(ref_hist, port_hist):
    """One step's metrics (loss rel 1e-5, grad norm rel 1e-4, lr, the
    parts at accum 1) and the loss history (rel 1e-4); the loss falls."""
    first_r, first_p = ref_hist[0], port_hist[0]
    assert set(first_p) == set(first_r)
    assert _rel(first_p["loss"], first_r["loss"]) <= LOSS_RTOL
    assert _rel(first_p["grad_norm"], first_r["grad_norm"]) <= GRAD_RTOL
    assert _rel(first_p["lr"], first_r["lr"]) <= 1e-6
    for k in set(first_r) - {"loss", "grad_norm", "lr"}:
        assert abs(first_p[k] - first_r[k]) <= LOSS_RTOL * max(1.0, abs(first_r[k])), k
    for r, p in zip(ref_hist, port_hist):
        assert _rel(p["loss"], r["loss"]) <= HISTORY_RTOL, (r, p)
    assert port_hist[-1]["loss"] < port_hist[0]["loss"]


@pytest.mark.parametrize("name,accum", [
    ("llama3-8b", 1), ("llama3-8b", 2), ("gemma2-9b", 2), ("qwen3-moe-30b-a3b", 1),
])
def test_train_step_and_history_match_reference(name, accum):
    _assert_history(*_history(name, accum, 3)[:2])


def _f32_scan(monkeypatch):
    """The reference's mamba module with its scan's bf16 storage made
    float32: its ``jnp`` seen through a namespace whose ``bfloat16`` is
    ``float32`` (every other name is ``jax.numpy``'s)."""
    shim = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("__")})
    shim.bfloat16 = jnp.float32
    monkeypatch.setattr(ref_mamba, "jnp", shim)


@pytest.mark.parametrize("name,accum", [("falcon-mamba-7b", 1), ("jamba-1.5-large-398b", 2)])
def test_mamba_train_history_matches_reference(name, accum, monkeypatch):
    """Against the reference as it is, the loss history within 2e-2 (its
    bf16 scan); against the reference with a float32 scan, every check of
    the dense archs."""
    ref_hist, port_hist, _ = _history(name, accum, 3)
    for r, p in zip(ref_hist, port_hist):
        assert _rel(p["loss"], r["loss"]) <= MAMBA_TOL, (r, p)
    _f32_scan(monkeypatch)
    _assert_history(*_history(name, accum, 3)[:2])


def test_auto_accum_matches_reference_without_a_mesh():
    cfg = get_config("llama3-8b")
    for gb in (1, 2, 4, 8, 12, 256):
        assert steps.auto_accum(cfg, gb) == ref_steps.auto_accum(ref_get_config("llama3-8b"), gb)


def test_token_stream_is_deterministic_and_host_sharded():
    cfg = get_config("llama3-8b").reduced()
    whole = pipeline.TokenStream(cfg, 16, 8, seed=3, device="cpu")
    a, b = whole.batch_at(5), whole.batch_at(5)
    assert torch.equal(a["tokens"], b["tokens"]) and torch.equal(a["labels"], b["labels"])
    assert not torch.equal(a["tokens"], whole.batch_at(6)["tokens"])
    assert not torch.equal(a["tokens"],
                           pipeline.TokenStream(cfg, 16, 8, seed=4, device="cpu").batch_at(5)["tokens"])
    assert a["tokens"].dtype == torch.int32 and a["tokens"].shape == (8, 16)
    assert torch.equal(a["labels"][:, :-1], a["tokens"][:, 1:]) and not a["labels"][:, -1].any()
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < cfg.vocab_size
    hosts = [pipeline.TokenStream(cfg, 16, 8, n_hosts=2, host_id=h, seed=3, device="cpu")
             for h in range(2)]
    shards = [h.batch_at(5)["tokens"] for h in hosts]
    assert all(s.shape == (4, 16) for s in shards)
    assert not torch.equal(shards[0], shards[1])
    assert torch.equal(shards[1], hosts[1].batch_at(5)["tokens"])
    it = iter(whole)
    assert torch.equal(next(it)["tokens"], whole.batch_at(0)["tokens"])


@pytest.mark.parametrize("arch", ["llama3-8b", "whisper-medium", "internvl2-2b"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_batch_and_decode_structs_match_reference(arch, shape):
    rcfg, pcfg = ref_get_config(arch), get_config(arch)
    want = ref_pipeline.batch_struct(rcfg, REF_SHAPES[shape])
    got = pipeline.batch_struct(pcfg, SHAPES[shape])
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == tuple(want[k].shape), k
        assert str(got[k].dtype).removeprefix("torch.") == str(want[k].dtype), k
    want_d = ref_pipeline.decode_struct(rcfg, REF_SHAPES[shape])
    got_d = pipeline.decode_struct(pcfg, SHAPES[shape])
    assert {k: v.shape for k, v in got_d.items()} == {k: tuple(v.shape) for k, v in want_d.items()}


def test_synthetic_batch_frontends():
    """The frontends' extra inputs and the token length each arch gets
    (enc-dec caps the decoder; ViT patches take part of the budget)."""
    gen = torch.Generator().manual_seed(0)
    for arch in ("whisper-medium", "internvl2-2b"):
        cfg = get_config(arch).reduced()
        out = pipeline.synthetic_batch(cfg, 40, 2, gen, device="cpu")
        want = ref_pipeline.synthetic_batch(ref_get_config(arch).reduced(), 40, 2,
                                            jax.random.PRNGKey(0))
        assert {k: tuple(v.shape) for k, v in out.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
        assert all(str(out[k].dtype).removeprefix("torch.") == str(want[k].dtype) for k in want)


def test_train_cli_runs_and_resumes_on_the_cpu(tmp_path):
    def run(steps_):
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--reduced", "--device", "cpu",
             "--steps", str(steps_), "--batch", "4", "--seq", "16", "--save-every", "2",
             "--ckpt-dir", str(tmp_path)],
            capture_output=True, text=True, timeout=300, cwd=ROOT,
            env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        )

    first = run(4)
    assert first.returncode == 0, first.stderr
    assert "done: step=4" in first.stdout
    second = run(5)  # resumes from step 4's checkpoint
    assert second.returncode == 0, second.stderr
    assert "done: step=5" in second.stdout
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000002", "step_00000004", "step_00000005"]
