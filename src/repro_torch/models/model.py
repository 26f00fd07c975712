"""Model assembly (port of ``repro.models.model``): parameters, forward
passes, the training loss, prefill and decode steps.

The reference stacks its layers into groups of ``cfg.group_size`` (the
period of the arch's layer pattern) and scans them; the port keeps a
``ModuleList`` of layers instead, where layer ``g * group_size + s`` is
group ``g``, slot ``s``, and takes its kinds from the slot: an attention
or a mamba mixer, and a dense, an MoE or no FFN (every decoder-only
arch: llama3-8b, gemma2-9b, h2o-danube-1.8b, deepseek-7b,
falcon-mamba-7b, jamba-1.5-large-398b, mixtral-8x22b,
qwen3-moe-30b-a3b).  An encoder-decoder or a ViT-patch frontend raises
``NotImplementedError`` naming its ROADMAP item.

Parameter names follow the reference tree (``embed.table``,
``layers.<i>.mixer.wq`` or ``layers.<i>.mixer.A_log``,
``layers.<i>.ffn.w_gate`` or ``layers.<i>.ffn.router``,
``layers.<i>.norm1``, ``final_norm``, ``lm_head``); a layer without an
FFN has neither ``norm2`` nor ``ffn``.  Compute follows its
mixed-precision policy: master parameters in ``param_dtype``, matmul
weights cast to ``compute_dtype`` at the step boundary
(:func:`cast_for_compute`), norm scales, SSM dynamics and router kept in
float32.

Leaves are inference-only parameters (``requires_grad=False``) until
:func:`train_mode` makes the floating ones trainable; the compute cast is
then differentiable, so gradients reach the float32 master leaves, and
:func:`loss_fn` is the reference's training loss.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import Embed, SwiGLU, embed, rms_norm, swiglu, unembed, weight

# Leaves kept in float32 regardless of the compute policy (besides the
# norm scales): SSM dynamics (A_log and D are exp'd) and router logits
# (top-k stability), as in the reference.
_KEEP_F32_KEYS = ("A_log", "D", "router", "dt_bias")


def slot_kinds(cfg: ModelConfig, slot: int) -> tuple[str, str, str]:
    """(mixer, attn_kind, ffn) for a slot position within a group."""
    mixer = cfg.mixer_kind(slot)
    akind = cfg.attn_kind(slot)
    ffn = cfg.ffn_kind(slot)
    if cfg.d_ff == 0 and ffn == "dense":
        ffn = "none"  # attention-free mamba archs: the mixer is the layer
    return mixer, akind, ffn


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a part of ``cfg`` the port does
    not run yet, naming its ROADMAP item."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models wait for ROADMAP §1 P14 (enc-dec)"
        )
    if cfg.frontend == "vit_patches":
        raise NotImplementedError(
            f"{cfg.name}: the ViT-patch frontend waits for ROADMAP §1 P14 (vit)"
        )


def routing_feeds_state(cfg: ModelConfig) -> bool:
    """Whether an MoE layer's expert choices feed a later mamba layer's
    state (jamba).  A top-k choice near a tie flips under a last-bit
    change of its inputs, and the state carries the flipped token's
    change to every later position; so two bf16 runs of such a model
    that round in different places (two devices, or the port and the
    reference) compare only with their routers zeroed, where every
    choice ties and both break ties by index."""
    kinds = {k for s in range(cfg.group_size) for k in slot_kinds(cfg, s)}
    return {"mamba", "moe"} <= kinds


def tree_param_count(cfg: ModelConfig) -> int:
    """The parameters :func:`init_params` makes, as many as the
    reference's tree holds.  ``cfg.param_count()`` (the reference's own
    count, kept as it is) differs from the tree in two places: it omits a
    mamba layer's ``conv_b`` (d_inner) and counts a ``norm2`` (d_model)
    in a layer without an FFN."""
    total = cfg.param_count()
    for i in range(cfg.n_layers):
        mixer, _, ffn = slot_kinds(cfg, i % cfg.group_size)
        total += (cfg.d_inner if mixer == "mamba" else 0) - (cfg.d_model if ffn == "none" else 0)
    return total


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


class Block(nn.Module):
    """One layer: ``norm1``, the ``mixer`` (an
    :class:`~repro_torch.models.attention.Attention` or a
    :class:`~repro_torch.models.mamba.Mamba`), and, unless the slot has
    no FFN, ``norm2`` and the ``ffn`` (a :class:`SwiGLU` or an
    :class:`~repro_torch.models.moe.MoE`)."""

    def __init__(self, norm1, mixer: nn.Module, norm2=None, ffn: nn.Module | None = None):
        super().__init__()
        self.norm1 = weight(norm1)
        self.mixer = mixer
        self.norm2 = None if norm2 is None else weight(norm2)
        self.ffn = ffn


class LM(nn.Module):
    """A decoder-only LM: ``embed``, ``layers``, ``final_norm`` and, unless
    the embeddings are tied, ``lm_head`` (D, padded vocab)."""

    def __init__(self, table, layers: list[Block], final_norm, lm_head=None):
        super().__init__()
        self.embed = Embed(table)
        self.layers = nn.ModuleList(layers)
        self.final_norm = weight(final_norm)
        self.lm_head = None if lm_head is None else weight(lm_head)


def _keeps_f32(name: str) -> bool:
    leaf = name.rsplit(".", 1)[-1]
    return "norm" in leaf or leaf in _KEEP_F32_KEYS


def cast_for_compute(cfg: ModelConfig, params: LM) -> LM:
    """The parameters as the step computes with them: every floating leaf
    but the norm scales and ``_KEEP_F32_KEYS`` in ``compute_dtype``.
    Returns ``params`` itself when nothing needs a cast; otherwise a new
    :class:`LM` that shares the leaves already in the right dtype.

    Inference (autograd off, or no leaf requiring a gradient) casts
    detached copies into new inference-only leaves, as serving always
    has.  Training (autograd on and a trainable leaf, :func:`train_mode`)
    keeps the casts in the autograd graph instead, so the gradients reach
    the master leaves in their own dtype."""
    compute = torch_dtype(cfg.compute_dtype)
    train = torch.is_grad_enabled() and any(p.requires_grad for p in params.parameters())
    leaves = {
        name: p.to(compute) if train else weight(p.detach().to(compute))
        for name, p in params.named_parameters()
        if not (_keeps_f32(name) or not p.dtype.is_floating_point or p.dtype == compute)
    }
    return _with_leaves(params, leaves) if leaves else params


def _with_leaves(module: nn.Module, leaves: dict[str, torch.Tensor], prefix: str = ""):
    """A shallow copy of ``module``'s tree whose parameters are
    ``leaves[name]`` (any tensor, an autograd graph's output included),
    the rest shared; nothing is detached or copied."""
    clone = copy.copy(module)
    clone._parameters = {k: leaves.get(prefix + k, v) for k, v in module._parameters.items()}
    clone._modules = {
        k: None if m is None else _with_leaves(m, leaves, f"{prefix}{k}.")
        for k, m in module._modules.items()
    }
    return clone


def train_mode(params: LM) -> LM:
    """Make every floating leaf of ``params`` trainable (in place);
    returns ``params``."""
    for p in params.parameters():
        if p.dtype.is_floating_point:
            p.requires_grad_(True)
    return params


def init_params(
    cfg: ModelConfig,
    generator: torch.Generator,
    *,
    device=DEFAULT_DEVICE,
    compute: bool = False,
) -> LM:
    """Random parameters with the reference's scales, drawn in float32
    from ``generator`` (a generator on ``device``).  With ``compute`` each
    leaf is cast to its compute dtype as soon as it is drawn, so the
    float32 tree is never held whole (``cast_for_compute(cfg,
    init_params(...))`` without its peak)."""
    check_supported(cfg)
    dev = resolve_device(device)
    master = torch_dtype(cfg.param_dtype)
    weights = torch_dtype(cfg.compute_dtype) if compute else master
    d, f, vocab = cfg.d_model, cfg.d_ff, cfg.padded_vocab

    def normal(shape, scale, dtype=weights):
        t = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
        return t.mul_(scale).to(dtype)

    def zeros():
        return torch.zeros(d, dtype=torch.float32, device=dev)

    layers = []
    for i in range(cfg.n_layers):
        mixer_kind, _, ffn_kind = slot_kinds(cfg, i % cfg.group_size)
        if mixer_kind == "attn":
            mixer = attn.init_attn_params(cfg, generator, weights, dev)
        else:
            mixer = mb.init_mamba_params(cfg, generator, weights, dev, master=master)
        if ffn_kind == "none":
            layers.append(Block(zeros(), mixer))
            continue
        if ffn_kind == "moe":
            ffn = moe_mod.init_moe_params(cfg, generator, weights, dev)
        else:
            ffn = SwiGLU(normal((d, f), d**-0.5), normal((d, f), d**-0.5),
                         normal((f, d), f**-0.5))
        layers.append(Block(zeros(), mixer, zeros(), ffn))
    table = normal((vocab, d), 0.02)
    lm_head = None if cfg.tie_embeddings else normal((d, vocab), 0.02)
    return LM(table, layers, zeros(), lm_head)


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------


def _embed_tokens(cfg: ModelConfig, params: LM, tokens: torch.Tensor) -> torch.Tensor:
    compute = torch_dtype(cfg.compute_dtype)
    x = embed(tokens, params.embed.table).to(compute)
    if cfg.name.startswith("gemma2"):
        # gemma convention; the factor is rounded to the compute dtype first
        x = x * torch.tensor(cfg.d_model**0.5, dtype=compute, device=x.device)
    return x


def _unembed(cfg: ModelConfig, params: LM, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return unembed(x, params.embed.table, transpose=True, cap=cfg.final_logit_softcap)
    return unembed(x, params.lm_head, transpose=False, cap=cfg.final_logit_softcap)


def _ffn(cfg: ModelConfig, layer: Block, x: torch.Tensor, kind: str):
    """The residual FFN half of a layer: ``(x, aux)``, where ``aux`` is an
    MoE's balance loss and ``None`` for any other FFN."""
    if kind == "none":
        return x, None
    h = rms_norm(x, layer.norm2, cfg.norm_eps)
    if kind == "moe":
        h, aux = moe_mod.moe_apply(cfg, layer.ffn, h)
        return x + h, aux
    return x + swiglu(h, layer.ffn.w_gate, layer.ffn.w_up, layer.ffn.w_down), None


def _hidden(cfg: ModelConfig, params: LM, tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    x = _embed_tokens(cfg, params, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, layer in enumerate(params.layers):
        mixer, akind, ffn = slot_kinds(cfg, i % cfg.group_size)
        h = rms_norm(x, layer.norm1, cfg.norm_eps)
        if mixer == "attn":
            x = x + attn.mha(cfg, layer.mixer, h, positions, kind=akind)
        else:
            x = x + mb.mamba_mixer(cfg, layer.mixer, h)
        x, a = _ffn(cfg, layer, x, ffn)
        if a is not None:
            aux = aux + a
    return rms_norm(x, params.final_norm, cfg.norm_eps), aux


def _step_params(cfg: ModelConfig, params: LM) -> LM:
    check_supported(cfg)
    return cast_for_compute(cfg, params)


def forward_hidden(cfg: ModelConfig, params: LM, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward up to the final norm; returns ``(hidden,
    aux)`` (aux is the MoE balance loss, 0 without MoE)."""
    return _hidden(cfg, _step_params(cfg, params), batch["tokens"])


def forward(cfg: ModelConfig, params: LM, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward; returns ``(logits (B, S, padded vocab),
    aux)``."""
    params = _step_params(cfg, params)
    x, aux = _hidden(cfg, params, batch["tokens"])
    return _unembed(cfg, params, x), aux


def loss_fn(
    cfg: ModelConfig, params: LM, batch: dict, *, z_loss: float = 1e-4, aux_weight: float = 1e-2
) -> tuple[torch.Tensor, dict]:
    """The reference's training loss: mean next-token NLL over
    ``batch["labels"]`` with the padded vocabulary masked out of the
    float32 softmax, plus ``z_loss * mean(lse**2)`` and ``aux_weight *
    aux`` (the MoE balance loss).  Returns ``(total, {"nll", "aux",
    "lse"})``, ``lse`` the mean log-sum-exp.  A ViT-patch frontend raises
    through :func:`check_supported`, as the forward does."""
    logits, aux = forward(cfg, params, batch)
    labels = batch["labels"]
    logits = logits.float()
    vocab_ok = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab_size
    logits = torch.where(vocab_ok, logits, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    true_logit = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = (lse - true_logit).mean()
    total = nll + z_loss * (lse**2).mean() + aux_weight * aux
    return total, {"nll": nll, "aux": aux, "lse": lse.mean()}


def prefill(cfg: ModelConfig, params: LM, batch: dict) -> torch.Tensor:
    """Prefill forward: full-sequence compute, last-position logits only
    ``(B, padded vocab)`` (serving never materializes the (B, S, vocab)
    logits)."""
    params = _step_params(cfg, params)
    x, _ = _hidden(cfg, params, batch["tokens"])
    return _unembed(cfg, params, x[:, -1:])[:, 0]


# ---------------------------------------------------------------------------
# Serving: decode
# ---------------------------------------------------------------------------


def init_cache(
    cfg: ModelConfig, batch: int, seq_len: int, dtype: torch.dtype, *, device=DEFAULT_DEVICE
) -> list[attn.KVCache | mb.MambaCache]:
    """Decode cache, one zeroed entry per layer: a
    :class:`~repro_torch.models.attention.KVCache` for an attention layer
    (an SWA layer's is a ring of ``sliding_window`` slots) or a
    :class:`~repro_torch.models.mamba.MambaCache` for a mamba layer (conv
    window in ``dtype``, state in float32)."""
    check_supported(cfg)
    dev = resolve_device(device)
    cache = []
    for i in range(cfg.n_layers):
        mixer, akind, _ = slot_kinds(cfg, i % cfg.group_size)
        if mixer == "attn":
            cache.append(
                attn.init_kv_cache(cfg, batch, seq_len, kind=akind, dtype=dtype, device=dev)
            )
        else:
            cache.append(mb.init_mamba_cache(cfg, batch, dtype, dev))
    return cache


def decode_step(
    cfg: ModelConfig,
    params: LM,
    cache: list[attn.KVCache | mb.MambaCache],
    tokens: torch.Tensor,  # (B, 1) int
    pos: int,  # position of this token
    *,
    cast: bool = True,
) -> tuple[torch.Tensor, list[attn.KVCache | mb.MambaCache]]:
    """One token for every sequence in the batch against the cache.
    Returns ``(logits (B, padded vocab), cache)``; the cache is updated in
    place (the reference returns a new one).  ``cast=False`` takes
    ``params`` as :func:`cast_for_compute` returned them, so a decode loop
    casts once rather than walking every parameter on every step."""
    if cast:
        params = _step_params(cfg, params)
    x = _embed_tokens(cfg, params, tokens)
    for i, layer in enumerate(params.layers):
        mixer, akind, ffn = slot_kinds(cfg, i % cfg.group_size)
        h = rms_norm(x, layer.norm1, cfg.norm_eps)
        if mixer == "attn":
            h, cache[i] = attn.mha_decode(cfg, layer.mixer, h, cache[i], pos, kind=akind)
        else:
            h, cache[i] = mb.mamba_decode(cfg, layer.mixer, h, cache[i])
        x, _ = _ffn(cfg, layer, x + h, ffn)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return _unembed(cfg, params, x)[:, 0], cache
