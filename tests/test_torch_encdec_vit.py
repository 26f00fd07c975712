"""The port's encoder-decoder (whisper-medium) and ViT-patch frontend
(internvl2-2b) against the reference, on their reduced configs.

The reference's ``init_params`` tree is carried into the port by
``lm_params_from_reference`` (numpy, value for value); tokens, encoder
frames and patch embeddings are numpy-seeded and handed to both sides.
Both run the encoder (``encode`` against the reference's
``_embed_decoder_inputs``), ``forward``, ``prefill``, ``loss_fn`` with
every leaf's gradient (the port's through ``lm_params_to_reference``
against ``jax.grad``), and teacher-forced ``decode_step``s with the cross
cache filled on both sides from the reference's encoder output:

* float32 compute: within rel 1e-4 of the largest reference value
  (gradients of each leaf's largest magnitude), decoded tokens equal;
* bfloat16 compute: logits, encoder output and loss within 2e-2 (the
  repo's bf16 tolerance); each leaf's gradient within 2e-2 of its scale,
  or within twice the reference's own bf16 error for that leaf (its bf16
  gradient's distance from its float32 one), whichever is larger.  Each
  side rounds its bf16 activations and their cotangents in its own
  places, and two stacked layers carry that into the gradients: the
  reference's own bf16 gradients lie up to 3.5e-2 of a leaf's scale from
  its float32 gradients (internvl2's ``wk``; whisper's ``norm2`` 2.8e-2),
  and the port's up to 3.5e-2 from the reference's (whisper's ``norm2``),
  at most 1.9 times the reference's own error on any leaf.  float32 holds
  every gradient at 1e-4, which is where a wrong derivative would show.

Encoder lengths stay at most 1,024: the reference's ``blocked_attention``
takes a longer sequence only in whole 1,024-row blocks.  One whisper case
is ragged (40 frames, 24 decoder tokens); its decode runs past the
reduced ``max_target_len`` (32), where both sides clamp the position into
the ``dec_pos`` table and the cache.  internvl2 decodes tokens only, as
the reference does.  The attention core is K1's plain version (the CPU
path of ``mha_flash``).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_rel_to_scale
from repro.configs.base import get_config as ref_get_config
from repro.launch import serve as ref_serve
from repro.launch import steps as ref_steps
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import model as RM
from repro_torch.configs.base import get_config
from repro_torch.convert import lm_params_from_reference, lm_params_to_reference
from repro_torch.launch import serve, steps
from repro_torch.models import attention as PA
from repro_torch.models import layers as PL
from repro_torch.models import model as M

F32_RTOL = 1e-4
BF16_TOL = 2e-2
BF16_GRAD_GAPS = 2.0  # see the module docstring
B = 2
# name, (encoder frames, decoder tokens); internvl2's 8 reduced patches
# come before its tokens
CASES = [
    ("whisper-medium", 64, 16),
    ("whisper-medium", 40, 24),  # ragged: no length a multiple of a tile
    ("internvl2-2b", 0, 24),
]
CASE_IDS = ["whisper-64x16", "whisper-40x24", "internvl2"]
DTYPES = ["float32", "bfloat16"]
WHISPER_DECODE_STEPS = 36  # past the reduced max_target_len (32)


def _configs(name, compute_dtype):
    ref = dataclasses.replace(ref_get_config(name).reduced(), compute_dtype=compute_dtype)
    port = dataclasses.replace(get_config(name).reduced(), compute_dtype=compute_dtype)
    return ref, port


def _batch(cfg, frames, tokens):
    """numpy-seeded inputs: ``tokens`` and ``labels`` (B, tokens + 1 drawn,
    shifted), and ``enc_frames`` (B, frames, D) or ``patch_embeds`` (B,
    frontend_tokens, D)."""
    rng = np.random.default_rng(1)
    tok = rng.integers(0, cfg.vocab_size, (B, tokens + 1)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    if cfg.is_encoder_decoder:
        batch["enc_frames"] = rng.standard_normal((B, frames, cfg.d_model)).astype(np.float32)
    else:
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _assert_close(got, want, compute_dtype, what):
    if compute_dtype == "float32":
        assert_rel_to_scale(got, want, rtol=F32_RTOL, what=what)
    else:
        np.testing.assert_allclose(np.asarray(got.float() if isinstance(got, torch.Tensor)
                                              else got, np.float32),
                                   np.asarray(want, np.float32),
                                   atol=BF16_TOL, rtol=BF16_TOL, err_msg=what)


def _ref_enc_out(rcfg, rparams, batch):
    """The reference's encoder output (its ``_embed_decoder_inputs``)."""
    fn = jax.jit(lambda p, b: RM._embed_decoder_inputs(rcfg, RM.cast_for_compute(rcfg, p), b)[2])
    return np.asarray(fn(rparams, batch), np.float32)


@functools.lru_cache(maxsize=None)
def _case(name, frames, tokens, compute_dtype):
    """The reference's results for one case, computed once per process,
    with the inputs and parameters they used."""
    rcfg, pcfg = _configs(name, compute_dtype)
    rparams = RM.init_params(rcfg, jax.random.PRNGKey(0))
    batch = _batch(rcfg, frames, tokens)
    fwd = {k: v for k, v in batch.items() if k != "labels"}
    logits, aux = jax.jit(lambda p, b: RM.forward(rcfg, p, b))(rparams, fwd)
    last = jax.jit(ref_steps.make_prefill_step(rcfg))(rparams, fwd)
    enc = _ref_enc_out(rcfg, rparams, fwd) if rcfg.is_encoder_decoder else None
    tree = jax.tree.map(np.asarray, rparams)
    return dict(
        rcfg=rcfg, pcfg=pcfg, rparams=rparams, tree=tree, batch=batch,
        params=lm_params_from_reference(pcfg, tree, device="cpu"),
        logits=np.asarray(logits, np.float32), aux=float(aux),
        prefill=np.asarray(last, np.float32), enc=enc,
    )


def _case_of(case, compute_dtype):
    name, frames, tokens = case
    return _case(name, frames, tokens, compute_dtype)


@pytest.mark.parametrize("length,dim", [(40, 64), (1024, 1024), (1500, 1024), (7, 10)])
def test_sinusoidal_positions_match_reference(length, dim):
    got = PL.sinusoidal_positions(length, dim)
    assert got.dtype == torch.float32 and got.shape == (length, dim)
    assert_rel_to_scale(got, RL.sinusoidal_positions(length, dim), rtol=F32_RTOL)
    # sines then cosines, not interleaved: position 0 is (0, ..., 0, 1, ..., 1)
    np.testing.assert_array_equal(got[0].numpy(), np.r_[np.zeros(dim // 2), np.ones(dim // 2)])


@pytest.mark.parametrize("compute_dtype", DTYPES)
@pytest.mark.parametrize("case", CASES[:2], ids=CASE_IDS[:2])
def test_encode_matches_reference(case, compute_dtype):
    c = _case_of(case, compute_dtype)
    got = M.encode(c["pcfg"], c["params"], torch.as_tensor(c["batch"]["enc_frames"]))
    assert got.dtype == getattr(torch, compute_dtype)
    assert got.shape == (B, case[1], c["pcfg"].d_model)
    _assert_close(got, c["enc"], compute_dtype, f"{case} encoder")


@pytest.mark.parametrize("compute_dtype", DTYPES)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_forward_matches_reference(case, compute_dtype):
    c = _case_of(case, compute_dtype)
    cfg = c["pcfg"]
    batch = {k: v for k, v in _torch_batch(c["batch"]).items() if k != "labels"}
    logits, aux = M.forward(cfg, c["params"], batch)
    s_total = case[2] + (cfg.frontend_tokens if cfg.frontend == "vit_patches" else 0)
    assert logits.shape == (B, s_total, cfg.padded_vocab)
    assert logits.dtype == getattr(torch, compute_dtype)
    assert float(aux) == c["aux"] == 0.0
    _assert_close(logits, c["logits"], compute_dtype, f"{case} logits")


@pytest.mark.parametrize("compute_dtype", DTYPES)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_prefill_matches_reference(case, compute_dtype):
    c = _case_of(case, compute_dtype)
    batch = {k: v for k, v in _torch_batch(c["batch"]).items() if k != "labels"}
    got = steps.make_prefill_step(c["pcfg"])(c["params"], batch)
    assert got.shape == (B, c["pcfg"].padded_vocab)
    _assert_close(got, c["prefill"], compute_dtype, f"{case} prefill")


@functools.lru_cache(maxsize=None)
def _ref_value_and_grad(case, compute_dtype):
    c = _case_of(case, compute_dtype)
    rcfg = c["rcfg"]
    fn = jax.jit(jax.value_and_grad(lambda p, b: RM.loss_fn(rcfg, p, b), has_aux=True))
    (loss, parts), grads = fn(c["rparams"], c["batch"])
    return float(loss), {k: float(v) for k, v in parts.items()}, jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("compute_dtype", DTYPES)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_loss_and_gradients_match_reference(case, compute_dtype):
    """``loss_fn`` (internvl2: over the text positions only) and every
    leaf's gradient, encoder, cross-attention, ``dec_pos`` and
    ``frontend.proj`` included."""
    c = _case_of(case, compute_dtype)
    cfg = c["pcfg"]
    want, want_parts, want_grads = _ref_value_and_grad(case, compute_dtype)
    lm = M.train_mode(lm_params_from_reference(cfg, c["tree"], device="cpu"))
    loss, parts = M.loss_fn(cfg, lm, _torch_batch(c["batch"]))
    tol = F32_RTOL if compute_dtype == "float32" else BF16_TOL
    assert abs(loss.item() - want) <= tol * abs(want), (float(loss), want)
    for k in ("nll", "lse"):
        assert abs(parts[k].item() - want_parts[k]) <= tol * abs(want_parts[k]), k
    loss.backward()
    got = lm_params_to_reference(cfg, {n: p.grad for n, p in lm.named_parameters()})
    got_flat = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    want_flat = jax.tree_util.tree_flatten_with_path(want_grads)[0]
    assert set(got_flat) == {p for p, _ in want_flat}
    if compute_dtype == "bfloat16":
        f32_flat = dict(jax.tree_util.tree_flatten_with_path(
            _ref_value_and_grad(case, "float32")[2])[0])
    for path, g in want_flat:
        if compute_dtype == "float32":
            grad_tol = F32_RTOL
        else:
            ref_err = np.abs(g - f32_flat[path]).max() / max(np.abs(g).max(), 1e-30)
            grad_tol = max(BF16_TOL, BF16_GRAD_GAPS * float(ref_err))
        assert_rel_to_scale(got_flat[path], g, rtol=grad_tol, what=jax.tree_util.keystr(path))


def _fill_cross(rcfg, rparams, enc, cache_dtype):
    """Each decoder layer's cross K and V, projected by the reference
    from its encoder output: ``(n_layers, B, S_enc, Kv, dh)`` numpy each,
    rounded to the cache dtype."""
    p = RM.cast_for_compute(rcfg, rparams)["groups"]["slot0"]["cross"]
    enc = jnp.asarray(enc).astype(jnp.dtype(rcfg.compute_dtype))
    ks, vs = zip(*(RA.cross_kv(rcfg, jax.tree.map(lambda x, g=g: x[g], p), enc)
                   for g in range(rcfg.n_groups)))
    return (np.asarray(jnp.stack(ks).astype(cache_dtype).astype(jnp.float32)),
            np.asarray(jnp.stack(vs).astype(cache_dtype).astype(jnp.float32)))


@pytest.mark.parametrize("compute_dtype", DTYPES)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_decode_steps_match_reference(case, compute_dtype):
    """Teacher-forced decode through a cache in the compute dtype (bf16 as
    served; float32 in float32, where a bf16 cache rounds each side's
    last-bit differences in K and V across bf16 boundaries and whisper's
    logits drift to 1.2e-4 of their scale by step 14); whisper's cross
    cache filled on both sides with the reference's projections of its
    encoder output, its decode past ``max_target_len``.  Every step's
    logits, and in float32 its argmax token."""
    c = _case_of(case, compute_dtype)
    rcfg, cfg = c["rcfg"], c["pcfg"]
    n_steps = WHISPER_DECODE_STEPS if cfg.is_encoder_decoder else case[2]
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, n_steps)).astype(np.int32)
    s_cache = case[1] if cfg.is_encoder_decoder else n_steps
    rdtype, dtype = jnp.dtype(compute_dtype), getattr(torch, compute_dtype)
    rcache = RM.init_cache(rcfg, B, s_cache, rdtype)
    cache = M.init_cache(cfg, B, s_cache, dtype, device="cpu")
    if cfg.is_encoder_decoder:
        assert isinstance(cache, M.EncDecCache)
        assert cache.layers[0].k.shape == (B, cfg.max_target_len, cfg.n_kv_heads, cfg.head_dim)
        ks, vs = _fill_cross(rcfg, c["rparams"], c["enc"], rdtype)
        rcache["cross"] = RA.KVCache(k=jnp.asarray(ks, rdtype), v=jnp.asarray(vs, rdtype))
        for i, entry in enumerate(cache.cross):
            assert entry.k.shape == ks[i].shape
            entry.k.copy_(torch.from_numpy(ks[i].copy()))
            entry.v.copy_(torch.from_numpy(vs[i].copy()))
    else:
        assert isinstance(cache, list) and len(cache) == cfg.n_layers
    rstep = jax.jit(ref_steps.make_decode_step(rcfg))
    step = steps.make_decode_step(cfg)
    for t in range(n_steps):
        want_tok, want, rcache = rstep(c["rparams"], rcache, tokens[:, t : t + 1],
                                       jnp.asarray(t, jnp.int32))
        nxt, got, cache = step(c["params"], cache, torch.as_tensor(tokens[:, t : t + 1]), t)
        _assert_close(got, np.asarray(want, np.float32), compute_dtype, f"{case} step {t}")
        if compute_dtype == "float32":
            np.testing.assert_array_equal(nxt.numpy(), np.asarray(want_tok))


@pytest.mark.parametrize("compute_dtype", DTYPES)
def test_internvl2_generate_matches_reference(compute_dtype):
    """``generate`` on tokens alone, as the reference's serve CLI runs the
    arch: equal prompts, and in float32 equal generated tokens."""
    c = _case_of(CASES[2], compute_dtype)
    cfg = c["pcfg"]
    prompts = c["batch"]["tokens"][:, :8]
    want = ref_serve.generate(c["rcfg"], RM.cast_for_compute(c["rcfg"], c["rparams"]),
                              jnp.asarray(prompts), 16, 8)
    got = serve.generate(cfg, M.cast_for_compute(cfg, c["params"]), torch.as_tensor(prompts),
                         16, 8, device="cpu")
    assert got.shape == (B, 16)
    np.testing.assert_array_equal(got[:, :8].numpy(), prompts)
    if compute_dtype == "float32":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


_NEW_LEAVES = {
    "whisper-medium": ("encoder.layers.0.mixer.wq", "encoder.layers.1.ffn.w_down",
                       "encoder.layers.1.norm2", "encoder.final_norm", "layers.0.norm_cross",
                       "layers.1.cross.wo", "dec_pos"),
    "internvl2-2b": ("frontend.proj", "lm_head"),
}


@pytest.mark.parametrize("name", ["whisper-medium", "internvl2-2b"])
def test_params_round_trip_and_mirror_reference(name):
    """The reference's tree through ``lm_params_from_reference`` and back
    through ``lm_params_to_reference`` equals itself leaf for leaf; the
    port's own ``init_params`` has the same names, shapes and dtypes, as
    many parameters as ``tree_param_count``; ``cast_for_compute`` keeps
    the norms (``norm_cross`` and the encoder's included) in float32 and
    casts ``frontend.proj``, ``dec_pos`` and the cross projections."""
    c = _case(name, 64 if name.startswith("whisper") else 0, 16 if name.startswith("whisper")
              else 24, "bfloat16")
    cfg, tree, params = c["pcfg"], c["tree"], c["params"]
    back = lm_params_to_reference(cfg, params)
    want_flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    back_flat = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(back_flat) == {p for p, _ in want_flat}
    for path, leaf in want_flat:
        np.testing.assert_array_equal(back_flat[path], leaf, err_msg=jax.tree_util.keystr(path))
    names = dict(params.named_parameters())
    assert set(_NEW_LEAVES[name]) <= set(names)
    own = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert {n: (p.shape, p.dtype) for n, p in own.named_parameters()} == {
        n: (p.shape, p.dtype) for n, p in names.items()}
    assert sum(p.numel() for p in own.parameters()) == M.tree_param_count(cfg)
    cast = M.cast_for_compute(cfg, own)
    kept = {n for n, p in cast.named_parameters() if p.dtype == torch.float32}
    assert kept == {n for n in names if "norm" in n.rsplit(".", 1)[-1]}
    assert {"layers.0.norm_cross", "encoder.final_norm"} & set(names) <= kept
    compute = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu", compute=True)
    for (n, a), (_, b) in zip(cast.named_parameters(), compute.named_parameters()):
        assert a.dtype == b.dtype, n
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("name,count,tree", [
    # the tree holds the encoder's final_norm (1,024), which param_count omits
    ("whisper-medium", 959_767_552, 959_768_576),
    # and internvl2's patch projection (2,048 x 2,048): param_count tests
    # frontend == "vlm", which no config has
    ("internvl2-2b", 1_889_634_304, 1_893_828_608),
])
def test_full_size_counts(name, count, tree):
    """``param_count()``, the reference's tree (shapes only, nothing
    allocated) and the port's ``tree_param_count`` at full size, and the
    widths the card runs."""
    cfg = get_config(name)
    assert cfg.param_count() == count
    shapes = jax.eval_shape(lambda k: RM.init_params(ref_get_config(name), k),
                            jax.random.PRNGKey(0))
    assert sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(shapes)) == tree
    assert M.tree_param_count(cfg) == tree
    if name == "whisper-medium":
        assert (cfg.n_layers, cfg.encoder_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                cfg.head_dim, cfg.max_target_len) == (24, 24, 1024, 16, 16, 64, 448)
    else:
        assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                cfg.frontend_tokens, cfg.tie_embeddings) == (24, 2048, 16, 8, 128, 256, False)


def test_serve_cli_serves_internvl2_and_refuses_whisper(capsys):
    """The serving CLI runs reduced internvl2 on the CPU (tokens only) and
    refuses an encoder-decoder with the reference's message."""
    serve.main(["--arch", "internvl2-2b", "--reduced", "--device", "cpu", "--batch", "2",
                "--prompt-len", "4", "--gen", "4"])
    assert "generated 8 tokens on cpu" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="enc-dec needs audio frames"):
        serve.main(["--arch", "whisper-medium", "--reduced", "--device", "cpu"])


def test_mha_over_encoder_frames_matches_blocked_attention():
    """The cross-attention layer alone at Sq < Skv and Sq > Skv (no mask
    acts, so the right-aligned query offset must change nothing), float32."""
    rcfg, pcfg = _configs("whisper-medium", "float32")
    rng = np.random.default_rng(3)
    d, h, kv, dh = pcfg.d_model, pcfg.n_heads, pcfg.n_kv_heads, pcfg.head_dim
    w = {n: (rng.standard_normal(s) * d**-0.5).astype(np.float32)
         for n, s in (("wq", (d, h * dh)), ("wk", (d, kv * dh)), ("wv", (d, kv * dh)),
                      ("wo", (h * dh, d)))}
    pp = PA.Attention(*(torch.as_tensor(w[n]) for n in ("wq", "wk", "wv", "wo")))
    for sq, skv in ((24, 40), (40, 24)):
        enc = rng.standard_normal((2, skv, d)).astype(np.float32)
        x = rng.standard_normal((2, sq, d)).astype(np.float32)
        kv_p = PA.cross_kv(pcfg, pp, torch.as_tensor(enc))
        kv_r = RA.cross_kv(rcfg, w, jnp.asarray(enc))
        got = PA.mha(pcfg, pp, torch.as_tensor(x), torch.arange(sq), causal=False,
                     use_rope=False, kv_override=kv_p)
        want = RA.mha(rcfg, w, jnp.asarray(x), jnp.arange(sq), causal=False, use_rope=False,
                      kv_override=kv_r)
        assert_rel_to_scale(got, want, rtol=1e-5, what=f"{sq} x {skv}")
