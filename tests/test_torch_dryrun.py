"""The port's counter source, dry run and mesh-signature validation
(``repro_torch.core.meshsig.counters.count_program``,
``repro_torch.launch.dryrun``, ``repro_torch.core.meshsig.validate``) on
``meta`` tensors, in one process: no gloo, no card.

* Against the reference: ``measured_axis_bytes`` and
  ``prediction_errors`` at rel 1e-12 (plain floats on both sides), the
  fit and validation meshes, ``cell_supported`` on every cell and
  ``active_param_count`` on every arch exactly; the FLOPs of reduced
  llama3's prefill and train step at one device against
  ``hlo_counters.analyze_hlo`` of the reference's compiled step, at rel
  1e-6 once the terms the programs differ by are taken out by hand.
* Against hand-worked counts: every collective of reduced llama3's and
  reduced jamba's prefill on a layout-only (2, 4) mesh (kind, axes,
  ranks, bytes), FLOPs at one rank, and the bytes of one product and of
  one SwiGLU layer.
* The kernel wrappers' ``meta`` branches and their own counts.
* ``run_validation`` on reduced llama3 over the reference's five meshes.
* What must raise.
"""

import ast
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.base as ref_base
import repro.core.meshsig.fit as ref_fit
from repro.core.meshsig.hlo_counters import analyze_hlo
from repro_torch.configs.base import SHAPES, ShapeConfig, cell_supported, get_config, list_configs
from repro_torch.core.meshsig import fit as port_fit
from repro_torch.core.meshsig import validate as port_validate
from repro_torch.core.meshsig.counters import count_program
from repro_torch.kernels.flash_attention import kernel as k1
from repro_torch.kernels.mamba_scan import kernel as k2
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.parallel import context as ctx

REF_VALIDATE = Path(ref_fit.__file__).with_name("validate.py")
META = torch.device("meta")


def _ref_validate():
    # validate.py sets XLA_FLAGS for its own __main__ use; initialize the
    # backend first so importing it cannot re-shape this process's devices
    jax.devices()
    from repro.core.meshsig import validate

    return validate


def _empty(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device=META)


# ---------------------------------------------------------------------------
# (i) The reference's helpers, meshes, cell rules and parameter counts
# ---------------------------------------------------------------------------


def test_fit_and_validation_meshes_are_the_references():
    ref = _ref_validate()
    assert port_validate.FIT_MESHES == ref.FIT_MESHES
    assert port_validate.VAL_MESHES == ref.VAL_MESHES


@pytest.mark.parametrize("axes", [
    {"data": 8, "model": 32}, {"data": 4, "model": 64}, {"data": 16, "model": 16},
    {"pod": 2, "data": 4, "model": 8},
])
def test_measured_axis_bytes_and_prediction_errors_match_reference(axes):
    ref = _ref_validate()
    rng = np.random.default_rng(len(axes) * 100 + max(axes.values()))
    classes = ("static", "interleaved", "per_shard")
    bytes_ = {(c, a): float(rng.uniform(1e6, 1e9)) for c in classes for a in axes}
    terms = {(c, a): (float(rng.uniform(1e8, 1e10)), float(rng.integers(0, 2)))
             for c in classes for a in axes}
    profiles = [mod.MeshProfile(axis_sizes=dict(axes), class_axis_bytes=dict(bytes_),
                                local_bytes=1e10, flops=1e12) for mod in (port_fit, ref_fit)]
    sigs = [mod.MeshSignature(terms=dict(terms), local_bytes0=1e10, flops0=1e12,
                              batch_shards0=32) for mod in (port_fit, ref_fit)]
    got = port_validate.measured_axis_bytes(profiles[0])
    want = ref.measured_axis_bytes(profiles[1])
    assert got.keys() == want.keys()
    for a in want:
        assert got[a] == pytest.approx(want[a], rel=1e-12)
    errs = port_validate.prediction_errors(sigs[0], axes, got)
    ref_errs = ref.prediction_errors(sigs[1], axes, want)
    assert errs.keys() == ref_errs.keys()
    for a in ref_errs:
        assert errs[a] == pytest.approx(ref_errs[a], rel=1e-12, abs=1e-12)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ref_base.list_configs())
def test_cell_supported_matches_reference(arch, shape):
    assert cell_supported(get_config(arch), SHAPES[shape]) == ref_base.cell_supported(
        ref_base.get_config(arch), ref_base.SHAPES[shape])


def test_exactly_the_six_full_attention_archs_skip_long_500k():
    skipped = {(a, s) for a in list_configs() for s in SHAPES
               if not cell_supported(get_config(a), SHAPES[s])[0]}
    assert {s for _, s in skipped} == {"long_500k"}
    assert {a for a, _ in skipped} == {
        "deepseek-7b", "gemma2-9b", "internvl2-2b", "llama3-8b", "qwen3-moe-30b-a3b",
        "whisper-medium"}


@pytest.mark.parametrize("arch", ref_base.list_configs())
def test_active_param_count_matches_reference(arch):
    assert get_config(arch).active_param_count() == ref_base.get_config(arch).active_param_count()


# ---------------------------------------------------------------------------
# (ii) Hand-worked counts
# ---------------------------------------------------------------------------

B, S = 4, 8  # prefill cell of the hand counts: 2 rows a rank over data


def _prefill_log(cfg, sizes):
    """Every collective of rank 0's prefill of ``cfg`` on a layout-only
    mesh of ``sizes``, as ``(kind, axes, ranks, bytes)``."""
    mesh = ctx.Mesh(("data", "model"), sizes, 0)
    counters, _ = dryrun.profile_cell(cfg, ShapeConfig("p", S, B, "prefill"), mesh)
    return [(c.kind, c.axes, c.group, c.bytes) for c in counters.collectives]


def test_llama3_prefill_collectives_by_hand():
    cfg = get_config("llama3-8b").reduced()
    rows, d, tp = B // 2 * S, cfg.d_model, 4
    psum = ("all-reduce", ("model",), tp, rows * d * 4)  # float32 partial sums over model
    want = [psum]  # the embedding's lookup over the vocabulary cut
    for _ in range(cfg.n_layers):
        want += [psum, psum]  # the out-projection's and the FFN's matmul_psum
    # the last position's logits gathered over the vocabulary (bf16), then the rows
    want += [("all-gather", ("model",), tp, B // 2 * cfg.padded_vocab * 2),
             ("all-gather", ("data",), 2, B * cfg.padded_vocab * 2)]
    assert _prefill_log(cfg, (2, 4)) == want


def test_jamba_prefill_collectives_by_hand():
    cfg = get_config("jamba-1.5-large-398b").reduced()
    rows, d, tp = B // 2 * S, cfg.d_model, 4
    psum = ("all-reduce", ("model",), tp, rows * d * 4)
    x_proj = ("all-reduce", ("model",), tp, rows * (cfg.dt_rank_actual + 2 * cfg.ssm_state) * 4)
    want = [psum]
    for i in range(cfg.n_layers):
        mixer, _, ffn = M.slot_kinds(cfg, i % cfg.group_size)
        want += [psum] if mixer == "attn" else [x_proj, psum]
        want += [psum]  # the FFN's partial sums: dense, or the experts' combine
        if ffn == "moe":  # the balance loss averaged over model, then over data
            want += [("all-reduce", ("model",), tp, 4), ("all-reduce", ("data",), 2, 4)]
    want += [("all-gather", ("model",), tp, B // 2 * cfg.padded_vocab * 2),
             ("all-gather", ("data",), 2, B * cfg.padded_vocab * 2)]
    assert _prefill_log(cfg, (2, 4)) == want


def _layer_weights(cfg) -> int:
    h, kv, dh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    return cfg.n_layers * (2 * d * h * dh + 2 * d * kv * dh + 3 * d * cfg.d_ff)


def test_flops_at_one_rank_by_hand():
    cfg = get_config("llama3-8b").reduced()
    mesh = ctx.Mesh(("data", "model"), (1, 1), 0)
    T, W = B * S, _layer_weights(cfg)
    attn = cfg.n_layers * 4 * cfg.head_dim * B * cfg.n_heads * (S * (S + 1) // 2)
    prefill, _ = dryrun.profile_cell(cfg, ShapeConfig("p", S, B, "prefill"), mesh)
    assert prefill.flops == 2 * T * W + 2 * B * cfg.d_model * cfg.padded_vocab + attn
    assert prefill.kernels["flash_attention"] == {
        "calls": cfg.n_layers, "flops": attn,
        "bytes": cfg.n_layers * 2 * 2 * T * (cfg.n_heads + cfg.n_kv_heads) * cfg.head_dim}
    train, meta = dryrun.profile_cell(cfg, ShapeConfig("t", S, B, "train"), mesh)
    assert meta["accum"] == 2
    forward = 2 * T * (W + cfg.d_model * cfg.padded_vocab)  # the layers' products, the head
    gradients = 2 * forward  # each product's two gradient products
    # the backward recomputes each layer group (one layer in llama3): its
    # products once more but the group's last, w_down (T x d_ff x d_model)
    recomputed = 2 * T * W - cfg.n_layers * 2 * T * cfg.d_ff * cfg.d_model
    # K1: the forward, its recompute, and the backward at 2.5 times the forward
    kernels = attn + attn + 2.5 * attn
    assert train.flops == forward + gradients + recomputed + kernels
    assert not prefill.collectives and not train.collectives


def test_hbm_bytes_of_one_product_and_one_layer():
    a, w = _empty((32, 64)), _empty((64, 128))
    c = count_program(torch.matmul, a, w)
    assert c.hbm_bytes == 2 * (32 * 64 + 64 * 128 + 32 * 128)
    assert c.flops == 2 * 32 * 64 * 128
    assert c.memory == {"argument_size_in_bytes": 2 * (32 * 64 + 64 * 128),
                        "output_size_in_bytes": 2 * 32 * 128,
                        "temp_size_in_bytes": 2 * 32 * 128}
    # a SwiGLU layer: three products; silu and the product of the halves fuse
    from repro_torch.models.layers import swiglu

    T, d, f = 16, 64, 128
    x, wg, wu, wd = _empty((2, T // 2, d)), _empty((d, f)), _empty((d, f)), _empty((f, d))
    c = count_program(swiglu, x, wg, wu, wd)
    assert c.hbm_bytes == 2 * (2 * (T * d + d * f + T * f) + (T * f + f * d + T * d))
    assert c.flops == 2 * T * d * f * 3
    # its widest point: silu's (T, f) result, up's and their product
    assert c.memory["temp_size_in_bytes"] == 3 * 2 * T * f


# ---------------------------------------------------------------------------
# Kernel wrappers on meta, and their own counts
# ---------------------------------------------------------------------------


def test_kernel_wrappers_allocate_on_meta_and_count_their_work():
    Bq, H, Kv, Sq, dh = 2, 4, 2, 24, 16
    q, k, v = _empty((Bq, H, Sq, dh)), _empty((Bq, Kv, Sq, dh)), _empty((Bq, Kv, Sq, dh))
    lse = _empty((Bq, H, Sq), torch.float32)
    launches = k1.flash_attention.launches, k1.flash_attention_bwd.launches
    with ctx.record("simulate") as rec:
        out = k1.flash_attention(q, k, v, window=8, lse=lse)
        dq, dk, dv = k1.flash_attention_bwd(q, k, v, out, _empty(q.shape), lse, window=8)
    assert (out.device, out.shape, out.dtype) == (META, q.shape, q.dtype)
    assert [t.shape for t in (dq, dk, dv)] == [q.shape, k.shape, v.shape]
    pairs = k1.attention_pairs(Sq, Sq, True, 8)
    assert pairs == sum(min(r + 1, 8) for r in range(Sq))
    ops = 4 * dh * Bq * H * pairs
    qb, kb = 2 * q.numel(), 2 * k.numel()
    assert rec.kernels == [
        ctx.KernelWork("flash_attention", ops, 2 * qb + 2 * kb + 4 * Bq * H * Sq),
        ctx.KernelWork("flash_attention_bwd", 2.5 * ops, 4 * qb + 4 * kb + 4 * Bq * H * Sq)]

    Bs, L, di, n = 2, 40, 96, 8
    f32 = torch.float32
    dt, x = _empty((Bs, L, di), f32), _empty((Bs, L, di), f32)
    a, b, c = _empty((di, n), f32), _empty((Bs, L, n), f32), _empty((Bs, L, n), f32)
    with ctx.record("simulate") as rec:
        y, states = k2.selective_scan(dt, a, b, c, x, save_states=True)
        grads = k2.selective_scan_bwd(dt, a, b, c, x, _empty((Bs, L, di), f32), states)
    assert y.shape == x.shape and states.shape == (Bs, 3, di, n)  # ceil(40 / 16) chunks
    assert [g.shape for g in grads] == [dt.shape, a.shape, b.shape, c.shape, x.shape]
    assert k2.bwd_slices(di, n) == 4  # two blocks of 64 channels, 2 slices each
    elems = Bs * L * di
    assert rec.kernels == [
        ctx.KernelWork("selective_scan", 7 * elems * n + elems,
                       4 * (3 * elems + 2 * Bs * L * n + di * n + Bs * 3 * di * n)),
        ctx.KernelWork("selective_scan_bwd", 26 * elems * n,
                       4 * (5 * elems + 4 * Bs * L * n + 2 * di * n))]
    assert (k1.flash_attention.launches, k1.flash_attention_bwd.launches) == launches


def test_cpu_plain_version_counts_as_its_kernel():
    """On the CPU the wrapper runs the plain version, whose own products
    the kernel's count stands for."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.as_tensor(rng.standard_normal((1, 8, 2, 16)), dtype=torch.float32)
               for _ in range(3))
    from repro_torch.kernels.flash_attention.ops import mha_flash

    c = count_program(mha_flash, q, k, v, mode="observe")
    assert c.flops == 4 * 16 * 1 * 2 * k1.attention_pairs(8, 8, True, 0)
    assert c.kernels["flash_attention"]["calls"] == 1


# ---------------------------------------------------------------------------
# (iii) FLOPs against the reference's analyser
# ---------------------------------------------------------------------------

HB, HS = 2, 16


def test_prefill_flops_match_the_references_hlo_outside_attention():
    """One device: the reference's prefill dots are the port's products
    plus its blocked attention's two einsums over whole blocks (one block
    at 16 rows: masked pairs computed too); K1 is taken out of the
    port's count."""
    from repro.launch import steps as ref_steps
    from repro.models import model as RM

    rcfg, cfg = ref_base.get_config("llama3-8b").reduced(), get_config("llama3-8b").reduced()
    params = RM.cast_for_compute(rcfg, RM.init_params(rcfg, jax.random.PRNGKey(0)))
    tokens = jnp.zeros((HB, HS), jnp.int32)
    text = jax.jit(ref_steps.make_prefill_step(rcfg)).lower(params, {"tokens": tokens})
    ref_flops = analyze_hlo(text.compile().as_text()).flops
    p = M.init_params(cfg, torch.Generator(), device=META, compute=True)
    c = count_program(steps.make_prefill_step(cfg), p,
                      {"tokens": _empty((HB, HS), torch.int32)})
    outside_k1 = c.flops - c.kernels["flash_attention"]["flops"]
    ref_attention = cfg.n_layers * 2 * (2 * HB * cfg.n_heads * HS * HS * cfg.head_dim)
    assert outside_k1 == pytest.approx(ref_flops - ref_attention, rel=1e-6)


def test_train_flops_match_the_references_hlo_outside_attention():
    """One device, two micro-batches: the reference's train-step dots
    are the port's products plus its attention's einsums (forward 2, the
    rematerialised forward 2, backward 4, over whole blocks).  Both
    recompute each layer group but its last product, ``w_down``, whose
    result no gradient reads."""
    _train_flops_against_hlo("llama3-8b")


def test_train_flops_of_two_layer_groups_match_the_references_hlo():
    """As above for reduced gemma2, whose groups hold two layers: the
    first layer's ``w_down`` is recomputed, the second's is not."""
    _train_flops_against_hlo("gemma2-9b")


def _train_flops_against_hlo(arch):
    from repro.launch import steps as ref_steps
    from repro.models import model as RM
    from repro.optim import adamw as ref_adamw

    rcfg, cfg = ref_base.get_config(arch).reduced(), get_config(arch).reduced()
    params = RM.init_params(rcfg, jax.random.PRNGKey(0))
    opt = ref_adamw.init(params, moment_dtype=rcfg.moment_dtype)
    tokens = jnp.zeros((HB, HS), jnp.int32)
    lowered = jax.jit(ref_steps.make_train_step(rcfg, accum=2)).lower(
        params, opt, {"tokens": tokens, "labels": tokens}, jnp.int32(0))
    ref_flops = analyze_hlo(lowered.compile().as_text()).flops
    pt = M.train_mode(M.init_params(cfg, torch.Generator(), device=META))
    batch = {k: _empty((HB, HS), torch.int32) for k in ("tokens", "labels")}
    c = count_program(steps.make_train_step(cfg, accum=2), pt,
                      adamw.init(steps.param_tree(pt)), batch, 0)
    outside_k1 = c.flops - sum(c.kernels[k]["flops"]
                               for k in ("flash_attention", "flash_attention_bwd"))
    ref_attention = cfg.n_layers * 8 * (2 * HB * cfg.n_heads * HS * HS * cfg.head_dim)
    assert outside_k1 == pytest.approx(ref_flops - ref_attention, rel=1e-6)


# ---------------------------------------------------------------------------
# (iv) The validation experiment on reduced llama3
# ---------------------------------------------------------------------------


def _reference_record_keys() -> tuple[set, set]:
    """The keys the reference's ``run_validation`` writes: the record's
    and each validation mesh's."""
    source = REF_VALIDATE.read_text()
    tree = ast.parse(source)
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "run_validation")
    body = ast.get_source_segment(source, fn)
    top = set(re.findall(r'record\["(\w+)"\] =', body)) | {"arch", "shape", "meshes"}
    per_mesh = set(re.findall(r'"(\w+)": (?:pred|meas|mesh_errs|round)', body))
    return top, per_mesh


def test_validation_on_reduced_llama3(monkeypatch):
    # as many KV heads as the fit meshes' model ranks, as full-size llama3
    # has: no rank shares a head with another (whose gradients would add
    # weight-sized gathers over model)
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(), n_layers=1, n_heads=8,
                              n_kv_heads=8)
    monkeypatch.setattr(port_validate, "get_config", lambda arch: cfg)
    # the reference's train_4k batch at 16 tokens: one row a rank on (64, 4)
    monkeypatch.setattr(port_validate, "SHAPES", {"train_4k": ShapeConfig("train_4k", 16, 256,
                                                                          "train")})
    rec = port_validate.run_validation("llama3-8b", "train_4k")
    top, per_mesh = _reference_record_keys()
    assert top <= rec.keys() and len(top) == 10
    assert set(rec["meshes"]) == {"8x32", "4x64", "16x16"}
    for name, m in rec["meshes"].items():
        assert per_mesh <= m.keys() and len(per_mesh) == 4, (name, m)
    assert np.isfinite(rec["median_error_pct"]) and rec["max_error_pct"] >= rec["median_error_pct"]
    assert sorted(rec["advisor_order"]) == sorted(rec["measured_order"])
    # On its own two runs the fit gives back the model axis (activation
    # sums and gathers, which scale with 1/batch shards) but for the
    # global norm's one all-reduce over the whole mesh (4 bytes a leaf),
    # a constant that the fit attributes to both axes.  The data axis's
    # FSDP gathers and gradient sums scale with 1/model ranks, which no
    # (beta, e) term expresses: the fit splits the difference.
    leaves = len(list(M.init_params(cfg, torch.Generator(), device=META).parameters()))
    for check in rec["fit_meshes_check"].values():
        gap = abs(check["predicted_axis_bytes"]["model"] - check["measured_axis_bytes"]["model"])
        assert 0 < gap <= 2 * 4 * leaves
        assert check["error_pct_of_total"]["data"] > 0.1


# ---------------------------------------------------------------------------
# (v) What must raise
# ---------------------------------------------------------------------------


def test_a_real_tensor_reaching_a_simulated_collective_raises():
    mesh = ctx.Mesh(("data", "model"), (2, 4), 0)
    with ctx.use_mesh(mesh), ctx.record("simulate"):
        with pytest.raises(RuntimeError, match="meta tensors"):
            ctx.psum(torch.ones(3), ("model",))
        assert ctx.psum(_empty((3,), torch.float32), ("model",)).device == META
    with ctx.use_mesh(mesh), pytest.raises(RuntimeError, match="layout-only"):
        ctx.psum(_empty((3,), torch.float32), ("model",))  # no recording: a real collective


def test_a_cuda_request_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("llama3-8b").reduced()
    with mesh_lib.cell_context(ctx.Mesh(("data", "model"), (1, 1), 0), cfg,
                               ShapeConfig("p", S, B, "prefill")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            dryrun.build_cell(cfg, ShapeConfig("p", S, B, "prefill"), device="cuda")


def test_the_dry_run_writes_its_records_under_build(tmp_path):
    assert dryrun.DEFAULT_OUT.parts[-2:] == ("build", "dryrun")
    rec = dryrun.run_cell("llama3-8b", "long_500k", "multi", out_dir=tmp_path)
    assert rec["status"] == "skipped" and (tmp_path / "llama3-8b__long_500k__multi.json").exists()
