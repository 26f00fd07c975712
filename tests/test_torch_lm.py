"""The port's LM serving path against the reference, on the reduced
configs of every decoder-only arch: llama3-8b, gemma2-9b,
h2o-danube-1.8b, deepseek-7b (attention + dense FFN), falcon-mamba-7b
(mamba), jamba-1.5-large-398b (attention + mamba + MoE), mixtral-8x22b
and qwen3-moe-30b-a3b (attention + MoE).

The reference's ``init_params`` tree is carried into the port by
``lm_params_from_reference`` (numpy, value for value); token inputs are
numpy-seeded.  Both sides then run ``forward``, ``prefill``, a sequence
of ``decode_step``s against a bf16 cache and ``generate``:

* float32 ``compute_dtype``: logits within rel 1e-4 of the largest
  reference logit, tokens equal;
* bfloat16 ``compute_dtype``: logits within 2e-2 elementwise (atol and
  rtol, the repo's bf16 tolerance, ``tests/test_kernels.py``).  Each side
  rounds its bf16 activations in its own places: XLA on the CPU rounds
  every op of ``silu``'s ``1 / (1 + exp(-x))`` to bf16, torch computes
  ``silu`` in float32 and rounds once, so gemma2's decode logits drift
  up to 2.0e-2 of their scale from the reference.
* An arch with a mamba slot holds ``forward`` and ``prefill`` at 2e-2
  even in float32: the reference's prefill scan stores its states in
  bf16 (``repro/models/mamba.py``), the port's (K2's plain version) in
  float32.  Its decode step is float32 on both sides, so decode and
  generate keep rel 1e-4 and equal tokens.  ``tests/test_torch_mamba.py``
  holds the mixer at rel 1e-4 against the reference's float32 pieces.
* jamba, whose MoE routing feeds its mamba states
  (``model.routing_feeds_state``), runs in bf16 with its routers zeroed
  on both sides.  With a random router, bf16 rounding flips near-tied
  top-k choices (even one layer on identical inputs does), and the mamba
  state carries a flipped token's change to every later position: the
  reference itself moves by 17% of its logits' scale when only its
  scan's precision changes.  A zero router makes every choice a tie that
  both sides break by index; capacity still drops tokens.  float32 keeps
  the random routers.

The reference's attention core on this path is ``blocked_attention``;
the port's is K1's plain version (the CPU path of ``mha_flash``), and
its scan K2's plain version.  The enc-dec and ViT archs (whisper-medium,
internvl2-2b) are held in ``tests/test_torch_encdec_vit.py``.  The
configs themselves (all ten, published and reduced) and the
cross-attention pieces are held against the reference too.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_rel_to_scale
from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import get_config as ref_get_config
from repro.configs.base import list_configs as ref_list_configs
from repro.launch import serve as ref_serve
from repro.launch import steps as ref_steps
from repro.models import attention as RA
from repro.models import model as RM
from repro_torch.configs.base import SHAPES, get_config, list_configs
from repro_torch.convert import lm_params_from_reference
from repro_torch.launch import steps
from repro_torch.launch.serve import generate
from repro_torch.models import attention as PA
from repro_torch.models import model as M

ARCHS = ["llama3-8b", "gemma2-9b", "h2o-danube-1.8b", "deepseek-7b", "falcon-mamba-7b",
         "jamba-1.5-large-398b", "mixtral-8x22b", "qwen3-moe-30b-a3b"]
F32_RTOL = 1e-4
BF16_TOL = 2e-2
# jamba's reduced stack (14 mamba layers, 8 MoE layers) in bf16: with its
# routers zeroed, the port's logits lie up to 1.7x the repo's bf16
# tolerance from the reference's (3.4e-2); the reference's own logits
# move by 0.84x of it when only its scan's precision changes
BF16_TOL_DEEP_HYBRID = 4e-2
B, S = 2, 40  # S > the reduced sliding window (32): the SWA ring wraps
PROMPT, GEN = 16, 8
DECODE_STEPS = 36


def _has_mamba(cfg) -> bool:
    return any(M.slot_kinds(cfg, s)[0] == "mamba" for s in range(cfg.group_size))


def _has_moe(cfg) -> bool:
    return any(M.slot_kinds(cfg, s)[2] == "moe" for s in range(cfg.group_size))


def _tol(cfg, compute_dtype, *, bf16_scan=False) -> float:
    """float32: rel 1e-4 of the largest reference logit, or the bf16
    tolerance where the reference's output went through its bf16 prefill
    scan (``bf16_scan``); bfloat16: the bf16 tolerance, elementwise."""
    if compute_dtype == "float32":
        return BF16_TOL if bf16_scan else F32_RTOL
    return BF16_TOL_DEEP_HYBRID if M.routing_feeds_state(cfg) else BF16_TOL


def _assert_logits(got, want, cfg, compute_dtype, what, *, bf16_scan=False):
    tol = _tol(cfg, compute_dtype, bf16_scan=bf16_scan)
    if tol == F32_RTOL:
        assert_rel_to_scale(got, want, rtol=tol, what=what)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol, err_msg=what)


def _decode_cache_dtype(cfg):
    """The decode test's cache dtype: bf16, as served, except for jamba
    (``routing_feeds_state``).  Its bf16 conv window rounds each side's
    last-bit differences across bf16 rounding boundaries, the state
    carries each flip forward and the routers turn it into other expert
    choices: jamba's float32 logits drift to 4.7e-4 of their scale over
    36 steps with a bf16 window, 1.1e-5 with a float32 one (bf16
    attention caches alone).  falcon-mamba-7b, with no MoE, keeps the
    served bf16 window within rel 1e-4 (2.2e-5 over 36 steps).
    ``generate`` keeps the bf16 cache for every arch."""
    return "float32" if M.routing_feeds_state(cfg) else "bfloat16"


def _configs(name, compute_dtype):
    ref = dataclasses.replace(ref_get_config(name).reduced(), compute_dtype=compute_dtype)
    port = dataclasses.replace(get_config(name).reduced(), compute_dtype=compute_dtype)
    return ref, port


def _zero_routers(params):
    """The tree with every MoE router zeroed (see the module docstring)."""
    groups = {
        slot: {**p, "ffn": {**p["ffn"], "router": jnp.zeros_like(p["ffn"]["router"])}}
        if "router" in p.get("ffn", {}) else p
        for slot, p in params["groups"].items()
    }
    return {**params, "groups": groups}


@functools.lru_cache(maxsize=None)
def _case(name, compute_dtype):
    """The reference's results for one (arch, compute dtype), computed
    once per test process, with the tokens and parameters they used."""
    rcfg, pcfg = _configs(name, compute_dtype)
    rparams = RM.init_params(rcfg, jax.random.PRNGKey(0))
    if compute_dtype == "bfloat16" and M.routing_feeds_state(pcfg):
        rparams = _zero_routers(rparams)
    tokens = np.random.default_rng(1).integers(0, rcfg.vocab_size, (B, S)).astype(np.int32)

    logits, aux = jax.jit(lambda p, t: RM.forward(rcfg, p, {"tokens": t}))(rparams, tokens)
    last = jax.jit(ref_steps.make_prefill_step(rcfg))(rparams, {"tokens": tokens})
    step = jax.jit(ref_steps.make_decode_step(rcfg))
    cache = RM.init_cache(rcfg, B, S, jnp.dtype(_decode_cache_dtype(pcfg)))
    decoded = []
    for t in range(DECODE_STEPS):
        nxt, lg, cache = step(rparams, cache, tokens[:, t : t + 1], jnp.asarray(t, jnp.int32))
        decoded.append((np.asarray(nxt), np.asarray(lg, np.float32)))
    seqs = ref_serve.generate(
        rcfg, RM.cast_for_compute(rcfg, rparams), jnp.asarray(tokens[:, :PROMPT]), PROMPT + GEN, GEN
    )
    port_params = lm_params_from_reference(pcfg, jax.tree.map(np.asarray, rparams), device="cpu")
    return dict(
        pcfg=pcfg, params=port_params, tokens=tokens,
        logits=np.asarray(logits, np.float32), aux=float(aux), prefill=np.asarray(last, np.float32),
        decoded=decoded, seqs=np.asarray(seqs),
    )


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ARCHS)
def test_forward_matches_reference(name, compute_dtype):
    c = _case(name, compute_dtype)
    cfg = c["pcfg"]
    logits, aux = M.forward(cfg, c["params"], {"tokens": torch.as_tensor(c["tokens"])})
    assert logits.dtype == getattr(torch, compute_dtype)
    assert aux.dtype == torch.float32 and aux.shape == ()
    if _has_moe(cfg):  # the summed balance loss, at the logits' tolerance
        tol = _tol(cfg, compute_dtype, bf16_scan=_has_mamba(cfg))
        assert float(aux) == pytest.approx(c["aux"], rel=tol)
    else:
        assert float(aux) == c["aux"] == 0.0
    _assert_logits(logits, c["logits"], cfg, compute_dtype, name, bf16_scan=_has_mamba(cfg))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ARCHS)
def test_prefill_matches_reference(name, compute_dtype):
    c = _case(name, compute_dtype)
    step = steps.make_prefill_step(c["pcfg"])
    got = step(c["params"], {"tokens": torch.as_tensor(c["tokens"])})
    assert got.shape == (B, c["pcfg"].padded_vocab)
    _assert_logits(got, c["prefill"], c["pcfg"], compute_dtype, name,
                   bf16_scan=_has_mamba(c["pcfg"]))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ARCHS)
def test_decode_steps_match_reference(name, compute_dtype):
    """Teacher-forced decode through the cache (``_decode_cache_dtype``),
    past the SWA window: every step's logits, and in float32 its argmax
    token."""
    c = _case(name, compute_dtype)
    cfg = c["pcfg"]
    cache = M.init_cache(cfg, B, S, getattr(torch, _decode_cache_dtype(cfg)), device="cpu")
    step = steps.make_decode_step(cfg)
    tokens = torch.as_tensor(c["tokens"])
    for t, (want_tok, want_logits) in enumerate(c["decoded"]):
        nxt, logits, cache = step(c["params"], cache, tokens[:, t : t + 1], t)
        assert nxt.dtype == torch.int32
        _assert_logits(logits, want_logits, cfg, compute_dtype, f"{name} step {t}")
        if compute_dtype == "float32":
            np.testing.assert_array_equal(nxt.numpy(), want_tok)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ARCHS)
def test_generate_matches_reference(name, compute_dtype):
    c = _case(name, compute_dtype)
    cfg = c["pcfg"]
    params = M.cast_for_compute(cfg, c["params"])
    seqs = generate(cfg, params, torch.as_tensor(c["tokens"][:, :PROMPT]), PROMPT + GEN, GEN, device="cpu")
    assert seqs.dtype == torch.int32 and seqs.shape == (B, PROMPT + GEN)
    np.testing.assert_array_equal(seqs[:, :PROMPT].numpy(), c["tokens"][:, :PROMPT])
    if compute_dtype == "float32":
        np.testing.assert_array_equal(seqs.numpy(), c["seqs"])


# leaves each arch's tree must hold, beside the shared ones
_MIRROR_LEAVES = {
    "gemma2-9b": ("layers.0.mixer.wq", "layers.3.ffn.w_down", "layers.3.norm2"),
    "falcon-mamba-7b": ("layers.1.mixer.A_log", "layers.1.mixer.conv_b", "layers.1.ffn.w_up"),
    "jamba-1.5-large-398b": ("layers.8.mixer.wq", "layers.9.mixer.dt_bias", "layers.9.ffn.router",
                             "layers.10.ffn.w_gate", "layers.15.ffn.w_down"),
    "mixtral-8x22b": ("layers.1.mixer.wo", "layers.1.ffn.router", "layers.1.ffn.w_down"),
    "qwen3-moe-30b-a3b": ("layers.0.mixer.wk", "layers.0.ffn.router", "layers.0.ffn.w_gate"),
}


def test_params_mirror_reference_tree_and_count():
    """For gemma2 and each arch with a mamba or MoE slot: names, shapes
    and dtypes of the converted tree; the port's own ``init_params`` has
    the same leaves and as many parameters as the reference's tree
    (``tree_param_count``: ``cfg.param_count()`` where no mamba layer
    makes them differ); ``cast_for_compute`` keeps the norms, the SSM
    dynamics and the routers in float32 and is the identity on an
    already cast tree."""
    for name, leaves in _MIRROR_LEAVES.items():
        c = _case(name, "bfloat16")
        cfg, params = c["pcfg"], c["params"]
        names = dict(params.named_parameters())
        assert ("lm_head" in names) == (not cfg.tie_embeddings), name
        assert {"embed.table", "final_norm", "layers.0.norm1", *leaves} <= set(names), name
        own = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        assert {n: p.shape for n, p in own.named_parameters()} == {
            n: p.shape for n, p in names.items()}, name
        assert {n: p.dtype for n, p in own.named_parameters()} == {
            n: p.dtype for n, p in names.items()}, name
        count = sum(p.numel() for p in own.parameters())
        assert count == M.tree_param_count(cfg), name
        assert (count == cfg.param_count()) == (not _has_mamba(cfg)), name
        cast = M.cast_for_compute(cfg, own)
        kept = {n for n, p in cast.named_parameters() if p.dtype == torch.float32}
        assert kept == {n for n in names if n.rsplit(".", 1)[-1] in (
            "norm1", "norm2", "final_norm", "A_log", "D", "router", "dt_bias")}, name
        assert all(p.dtype == torch.bfloat16 for n, p in cast.named_parameters() if n not in kept)
        assert cast.final_norm is own.final_norm
        assert all(p.dtype == torch.float32 for p in own.parameters())  # the master is untouched
        assert M.cast_for_compute(cfg, cast) is cast
        compute = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu", compute=True)
        for (n, a), (_, b) in zip(cast.named_parameters(), compute.named_parameters()):
            assert a.dtype == b.dtype, n
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_llama3_8b_full_size_counts():
    cfg = get_config("llama3-8b")
    assert cfg.param_count() == 8_030_261_248
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.group_size) == (32, 8, 128, 1)


@pytest.mark.parametrize("name,count,tree", [
    # falcon's tree holds 64 conv_b (8,192) that param_count omits and no
    # norm2 (4,096) in its FFN-free layers, which param_count counts
    ("falcon-mamba-7b", 7_272_402_944, 7_272_665_088),
    ("qwen3-moe-30b-a3b", 30_532_634_624, 30_532_634_624),
])
def test_full_size_counts(name, count, tree):
    """The configs served at full size on one card: ``param_count()``, the
    reference's tree (shapes only, nothing allocated) and the port's
    ``tree_param_count``, and the widths the card runs."""
    cfg = get_config(name)
    assert cfg.param_count() == count
    shapes = jax.eval_shape(lambda k: RM.init_params(ref_get_config(name), k),
                            jax.random.PRNGKey(0))
    assert sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(shapes)) == tree
    assert M.tree_param_count(cfg) == tree
    if name == "falcon-mamba-7b":
        assert (cfg.n_layers, cfg.d_inner, cfg.ssm_state, cfg.dt_rank_actual) == (64, 8192, 16, 256)
        assert {M.slot_kinds(cfg, 0)} == {("mamba", "full", "none")}
    else:
        assert (cfg.n_layers, cfg.n_experts, cfg.experts_per_token) == (48, 128, 8)
        assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff) == (32, 4, 128, 768)


def test_routing_feeds_state_only_in_jamba():
    """The one decoder-only arch whose MoE routing feeds mamba states,
    where bf16 comparisons zero the routers."""
    assert [n for n in ARCHS if M.routing_feeds_state(get_config(n).reduced())] == [
        "jamba-1.5-large-398b"]
    assert M.routing_feeds_state(get_config("jamba-1.5-large-398b"))


ALL_ARCHS = ["deepseek-7b", "falcon-mamba-7b", "gemma2-9b", "h2o-danube-1.8b", "internvl2-2b",
             "jamba-1.5-large-398b", "llama3-8b", "mixtral-8x22b", "qwen3-moe-30b-a3b",
             "whisper-medium"]


# fields the port's ModelConfig has and the reference's has not, at their
# defaults (AI21-Jamba2-Mini, a benchmark configuration, sets them)
PORT_ONLY_FIELDS = {"rotary": True, "moe_renormalize": True, "moe_dropless": False,
                    "ssm_inner_norms": False, "attn_offset": 0}


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_configs_match_reference(name):
    """Every field, the derived layer pattern and the parameter count of
    the published and the reduced config; the port's own fields (those of
    models the reference does not hold) at the defaults that keep the
    reference's behaviour."""
    assert list_configs() == ref_list_configs() == sorted(ALL_ARCHS)
    for ref, port in [(ref_get_config(name), get_config(name)),
                      (ref_get_config(name).reduced(), get_config(name).reduced())]:
        port_fields, ref_fields = dataclasses.asdict(port), dataclasses.asdict(ref)
        assert {k: port_fields[k] for k in ref_fields} == ref_fields
        assert {k: v for k, v in port_fields.items() if k not in ref_fields} == PORT_ONLY_FIELDS
        assert port.param_count() == ref.param_count()
        assert (port.group_size, port.n_groups, port.head_dim, port.padded_vocab) == (
            ref.group_size, ref.n_groups, ref.head_dim, ref.padded_vocab)
        assert [M.slot_kinds(port, s) for s in range(port.group_size)] == [
            RM.slot_kinds(ref, s) for s in range(ref.group_size)]
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()}


def test_cross_attention_pieces_match_reference():
    """``cross_kv``, ``mha`` over given K/V (non-causal, no rotary) and
    ``mha_decode`` against a static cross cache, in float32."""
    rcfg, pcfg = _configs("llama3-8b", "float32")
    rng = np.random.default_rng(3)
    d, h, kv, dh = pcfg.d_model, pcfg.n_heads, pcfg.n_kv_heads, pcfg.head_dim
    w = {n: (rng.standard_normal(s) * d**-0.5).astype(np.float32)
         for n, s in (("wq", (d, h * dh)), ("wk", (d, kv * dh)), ("wv", (d, kv * dh)),
                      ("wo", (h * dh, d)))}
    enc = rng.standard_normal((2, 12, d)).astype(np.float32)
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    pp = PA.Attention(*(torch.as_tensor(w[n]) for n in ("wq", "wk", "wv", "wo")))

    k, v = PA.cross_kv(pcfg, pp, torch.as_tensor(enc))
    rk, rv = RA.cross_kv(rcfg, w, jnp.asarray(enc))
    assert_rel_to_scale(k, rk, rtol=1e-5)
    assert_rel_to_scale(v, rv, rtol=1e-5)
    positions = np.arange(5)
    got = PA.mha(pcfg, pp, torch.as_tensor(x), torch.as_tensor(positions), causal=False,
                 use_rope=False, kv_override=(k, v))
    want = RA.mha(rcfg, w, jnp.asarray(x), jnp.asarray(positions), causal=False,
                  use_rope=False, kv_override=(rk, rv))
    assert_rel_to_scale(got, want, rtol=1e-5)

    cache = PA.KVCache(k.clone(), v.clone())
    got, same = PA.mha_decode(pcfg, pp, torch.as_tensor(x[:, :1]), cache, 3, cross=True,
                              use_rope=False)
    want, _ = RA.mha_decode(rcfg, w, jnp.asarray(x[:, :1]), RA.KVCache(rk, rv),
                            jnp.asarray(3, jnp.int32), cross=True, use_rope=False)
    assert same is cache and torch.equal(cache.k, k)  # a cross cache is read, not written
    assert_rel_to_scale(got, want, rtol=1e-5)
