"""Model assembly (port of ``repro.models.model``): parameters, forward
passes, the training loss, prefill and decode steps.

The reference stacks its layers into groups of ``cfg.group_size`` (the
period of the arch's layer pattern) and scans them; the port keeps a
``ModuleList`` of layers instead, where layer ``g * group_size + s`` is
group ``g``, slot ``s``, and takes its kinds from the slot: an attention
or a mamba mixer, and a dense, an MoE or no FFN.  That covers all ten
archs: the decoder-only ones (llama3-8b, gemma2-9b, h2o-danube-1.8b,
deepseek-7b, falcon-mamba-7b, jamba-1.5-large-398b, mixtral-8x22b,
qwen3-moe-30b-a3b), the encoder-decoder whisper-medium (an encoder stack
over precomputed frames plus sinusoidal positions, non-causal and without
rotary embeddings; per decoder layer a cross-attention over the encoder
output; learned decoder positions, no rotary in the decoder) and
internvl2-2b (precomputed ViT patch embeddings projected and put before
the text tokens).  A config may also place a hybrid's attention at
another slot of its period (``attn_offset``) and leave out the rotary
embedding (``rotary=False``), as AI21-Jamba2-Mini does.  As in the
reference, the modality frontends are stubs: frames and patches arrive
as inputs (``batch["enc_frames"]``, ``batch["patch_embeds"]``).

Parameter names follow the reference tree (``embed.table``,
``layers.<i>.mixer.wq`` or ``layers.<i>.mixer.A_log``,
``layers.<i>.ffn.w_gate`` or ``layers.<i>.ffn.router``,
``layers.<i>.norm1``, ``final_norm``, ``lm_head``); a layer without an
FFN has neither ``norm2`` nor ``ffn``.  An encoder-decoder adds
``encoder.layers.<i>.*`` and ``encoder.final_norm``,
``layers.<i>.norm_cross`` and ``layers.<i>.cross.*`` and ``dec_pos``; a
ViT-patch frontend adds ``frontend.proj``.  Compute follows its
mixed-precision policy: master parameters in ``param_dtype``, matmul
weights cast to ``compute_dtype`` at the step boundary
(:func:`cast_for_compute`), norm scales, SSM dynamics and router kept in
float32.

Leaves are inference-only parameters (``requires_grad=False``) until
:func:`train_mode` makes the floating ones trainable; the compute cast is
then differentiable, so gradients reach the float32 master leaves, and
:func:`loss_fn` is the reference's training loss.

Under a mesh (:mod:`repro_torch.parallel.context`) ``params`` and the
decode cache are this rank's shards (``launch.mesh.shard_params``;
:func:`init_cache`, whose attention caches lie by sequence over
``cache_seq`` as the reference's ``cache_specs`` lays them, see
``launch.mesh.shard_cache``), while :func:`forward`, :func:`prefill` and
:func:`decode_step` take and return whole batches: each rank runs its
block of the rows (over :func:`~repro_torch.parallel.context.divisible_batch_axes`)
through its heads, channels, vocabulary and experts, and the outputs'
rows are gathered at the end.  Dense matrices may also be cut along
``d_model`` over ``fsdp`` (:func:`fsdp_dim`): :func:`cast_for_compute`
gathers them whole.  A mesh forward is differentiable: under autograd
the gathers' backwards sum the gradient over the ranks (each holds other
rows), every other leaf passes through ``context.fan_out`` over the batch
axes that do not cut it, and :func:`loss_fn` averages its terms over the
batch axes, so each rank's ``backward`` leaves the gradient of the whole
batch's loss on its shards.
"""

from __future__ import annotations

import contextlib
import copy
import functools
from typing import NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (
    Embed,
    SwiGLU,
    embed,
    rms_norm,
    sinusoidal_positions,
    swiglu,
    unembed,
    weight,
)
from repro_torch.parallel import context as ctx
from repro_torch.runtime.trace import span

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
    count, kept as it is) differs from the tree in four places: it omits
    a mamba layer's ``conv_b`` (d_inner), counts a ``norm2`` (d_model) in
    a layer without an FFN, omits the encoder's ``final_norm`` (d_model)
    and omits the ViT patch projection (d_model x d_model; it tests
    ``frontend == "vlm"``, which no config has)."""
    total = cfg.param_count()
    for i in range(cfg.n_layers):
        mixer, _, ffn = slot_kinds(cfg, i % cfg.group_size)
        total += (cfg.d_inner if mixer == "mamba" else 0) - (cfg.d_model if ffn == "none" else 0)
    if cfg.is_encoder_decoder:
        total += cfg.d_model
    if cfg.frontend == "vit_patches":
        total += cfg.d_model * cfg.d_model
    return total


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


class Block(nn.Module):
    """One layer: ``norm1``, the ``mixer`` (an
    :class:`~repro_torch.models.attention.Attention` or a
    :class:`~repro_torch.models.mamba.Mamba`), and, unless the slot has
    no FFN, ``norm2`` and the ``ffn`` (a :class:`SwiGLU` or an
    :class:`~repro_torch.models.moe.MoE`).  An encoder-decoder's decoder
    layer also has ``norm_cross`` and ``cross`` (an ``Attention`` over the
    encoder output)."""

    def __init__(self, norm1, mixer: nn.Module, norm2=None, ffn: nn.Module | None = None,
                 norm_cross=None, cross: nn.Module | None = None):
        super().__init__()
        self.norm1 = weight(norm1)
        self.mixer = mixer
        self.norm2 = None if norm2 is None else weight(norm2)
        self.ffn = ffn
        self.norm_cross = None if norm_cross is None else weight(norm_cross)
        self.cross = cross


class Encoder(nn.Module):
    """An encoder-decoder's encoder: ``layers`` and ``final_norm``."""

    def __init__(self, layers: list[Block], final_norm):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.final_norm = weight(final_norm)


class Frontend(nn.Module):
    """The ViT-patch frontend's projection ``proj`` (D, D)."""

    def __init__(self, proj):
        super().__init__()
        self.proj = weight(proj)


class LM(nn.Module):
    """An LM: ``embed``, ``layers``, ``final_norm`` and, unless the
    embeddings are tied, ``lm_head`` (D, padded vocab); an encoder-decoder
    also has ``encoder`` (an :class:`Encoder`) and ``dec_pos``
    (max_target_len, D), a ViT-patch frontend ``frontend`` (a
    :class:`Frontend`)."""

    def __init__(self, table, layers: list[Block], final_norm, lm_head=None, *,
                 encoder: Encoder | None = None, dec_pos=None, frontend: Frontend | None = None):
        super().__init__()
        self.embed = Embed(table)
        self.layers = nn.ModuleList(layers)
        self.final_norm = weight(final_norm)
        self.lm_head = None if lm_head is None else weight(lm_head)
        self.frontend = frontend
        self.encoder = encoder
        self.dec_pos = None if dec_pos is None else weight(dec_pos)


# The dim of each dense matrix that the reference's specs put on "fsdp"
# (its d_model dim): ``attention.py:53-56``, ``mamba.py:54, 62``,
# ``model.py:91, 214, 222`` of ``repro.models``.
_FSDP_DIMS = {"wq": 0, "wk": 0, "wv": 0, "wo": 1, "in_proj": 0, "out_proj": 1, "w_gate": 0,
              "w_up": 0, "w_down": 1, "table": 1, "lm_head": 0}


def fsdp_dim(name: str, ndim: int) -> int | None:
    """The ``d_model`` dim of the parameter ``name`` that lies over
    ``fsdp``, or ``None`` (norms, SSM leaves, routers, positions; MoE
    experts, 3-d, lie over ``efsdp`` instead)."""
    return _FSDP_DIMS.get(name.rsplit(".", 1)[-1]) if ndim == 2 else None


def batch_cut_axes(name: str, ndim: int) -> tuple[str, ...]:
    """The batch axes of the active mesh that cut the parameter ``name``
    (``fsdp`` for a dense matrix, ``efsdp`` for MoE experts): a forward
    gathers them, and the gather's backward sums the gradient over them."""
    if ctx.current_mesh() is None:
        return ()
    if ndim == 3 and name.rsplit(".", 1)[-1] in moe_mod.MoE.LEAVES:
        axes = ctx.physical_axes("efsdp")
    elif fsdp_dim(name, ndim) is not None:
        axes = ctx.physical_axes("fsdp")
    else:
        return ()
    return axes if ctx.current_mesh().axes_size(axes) > 1 else ()


def _whole_over_batch(cfg: ModelConfig, name: str, t: torch.Tensor, train: bool) -> torch.Tensor:
    """Under a mesh, the leaf ``t`` gathered along its ``fsdp`` dim
    (unless it is whole already) and, in training, passed through
    ``context.fan_out`` over the batch axes that do not cut it (each rank
    holds other rows); ``t`` itself without a mesh."""
    if ctx.current_mesh() is None:
        return t
    dim, cut = fsdp_dim(name, t.ndim), batch_cut_axes(name, t.ndim)
    if dim is not None and cut and t.shape[dim] != cfg.d_model:
        t = ctx.all_gather(t, cut, dim, adjoint="sum")
    if train:
        t = ctx.fan_out(t, [a for a in ctx.physical_axes("batch") if a not in cut])
    return t


def _keeps_f32(name: str) -> bool:
    leaf = name.rsplit(".", 1)[-1]
    return "norm" in leaf or leaf in _KEEP_F32_KEYS


def cast_for_compute(cfg: ModelConfig, params: LM) -> LM:
    """The parameters as the step computes with them: every floating leaf
    but the norm scales and ``_KEEP_F32_KEYS`` in ``compute_dtype`` and,
    under a mesh, the ``fsdp`` shards gathered whole along ``d_model``.
    Returns ``params`` itself when nothing changes; otherwise a new
    :class:`LM` that shares the leaves already as they should be.

    Inference (autograd off, or no leaf requiring a gradient) casts
    detached copies into new inference-only leaves, as serving always
    has.  Training (autograd on and a trainable leaf, :func:`train_mode`)
    keeps the casts and gathers in the autograd graph instead, so the
    gradients reach the master leaves in their own dtype, summed over the
    batch axes under a mesh (see :func:`_whole_over_batch`)."""
    compute = torch_dtype(cfg.compute_dtype)
    train = torch.is_grad_enabled() and any(p.requires_grad for p in params.parameters())
    leaves = {}
    with span("cast"):
        for name, p in params.named_parameters():
            t = p
            if not (_keeps_f32(name) or not p.dtype.is_floating_point or p.dtype == compute):
                t = _CastToCompute.apply(p, compute) if train else p.detach().to(compute)
            t = _whole_over_batch(cfg, name, t, train)
            if t is not p:
                leaves[name] = t if train else weight(t.detach())
    return _with_leaves(params, leaves) if leaves else params


class _CastToCompute(torch.autograd.Function):
    """The training cast of a master leaf to the compute dtype: ``p.to``
    forward; backward, the gradient cast back to the leaf's dtype (the
    bits of ``ToCopyBackward0``) under the span ``cast.backward``, so a
    trace tells it from the loss's own casts."""

    @staticmethod
    def forward(ctx_, p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        ctx_.set_materialize_grads(False)
        ctx_.master = p.dtype
        return p.to(dtype)

    @staticmethod
    def backward(ctx_, g: torch.Tensor | None):
        if g is None:
            return None, None
        with span("cast.backward"):
            return g.to(ctx_.master), None


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
    dev = resolve_device(device)
    master = torch_dtype(cfg.param_dtype)
    weights = torch_dtype(cfg.compute_dtype) if compute else master
    d, f, vocab = cfg.d_model, cfg.d_ff, cfg.padded_vocab

    def normal(shape, scale, dtype=weights):
        t = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
        return t.mul_(scale).to(dtype)

    def zeros():
        return torch.zeros(d, dtype=torch.float32, device=dev)

    def block(slot: int, cross: bool) -> Block:
        mixer_kind, _, ffn_kind = slot_kinds(cfg, slot)
        if mixer_kind == "attn":
            mixer = attn.init_attn_params(cfg, generator, weights, dev)
        else:
            mixer = mb.init_mamba_params(cfg, generator, weights, dev, master=master)
        norm2 = ffn = None
        if ffn_kind == "moe":
            norm2, ffn = zeros(), moe_mod.init_moe_params(cfg, generator, weights, dev)
        elif ffn_kind == "dense":
            norm2, ffn = zeros(), SwiGLU(normal((d, f), d**-0.5), normal((d, f), d**-0.5),
                                         normal((f, d), f**-0.5))
        if cross:
            return Block(zeros(), mixer, norm2, ffn, zeros(),
                         attn.init_attn_params(cfg, generator, weights, dev))
        return Block(zeros(), mixer, norm2, ffn)

    encdec = cfg.is_encoder_decoder
    layers = [block(i % cfg.group_size, encdec) for i in range(cfg.n_layers)]
    table = normal((vocab, d), 0.02)
    lm_head = None if cfg.tie_embeddings else normal((d, vocab), 0.02)
    extra = {}
    if cfg.frontend == "vit_patches":
        extra["frontend"] = Frontend(normal((d, d), d**-0.5))
    if encdec:
        # the reference's encoder stacks its slot 0 (attention + dense FFN)
        extra["encoder"] = Encoder([block(0, False) for _ in range(cfg.encoder_layers)], zeros())
        extra["dec_pos"] = normal((cfg.max_target_len, d), 0.02)
    return LM(table, layers, zeros(), lm_head, **extra)


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


def _ffn(cfg: ModelConfig, layer: Block, x: torch.Tensor, kind: str, *, decode: bool = False):
    """The residual FFN half of a layer: ``(x, aux)``, where ``aux`` is an
    MoE's balance loss and ``None`` for any other FFN."""
    if kind == "none":
        return x, None
    h = rms_norm(x, layer.norm2, cfg.norm_eps)
    if kind == "moe":
        h, aux = moe_mod.moe_apply(cfg, layer.ffn, h, decode=decode)
        return x + h, aux
    return x + swiglu(h, layer.ffn.w_gate, layer.ffn.w_up, layer.ffn.w_down), None


def _stack(cfg: ModelConfig, layers, x: torch.Tensor, *, causal: bool, use_rope: bool,
           enc_out: torch.Tensor | None = None, remat: bool = True,
           aux: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """``layers`` over ``x``: each layer's mixer, then (with ``enc_out``)
    its cross-attention over the encoder output, then its FFN.  Returns
    ``(x, aux)``, aux the summed MoE balance loss (added to ``aux`` when
    one is given).

    When autograd records (a leaf or ``x`` requires a gradient), each
    group of ``cfg.group_size`` layers, the reference's scan body, runs
    under ``torch.utils.checkpoint`` with ``remat`` (the reference's
    ``jax.checkpoint`` of the body), the balance loss carried from group
    to group: the backward keeps each group's input and recomputes its
    forward, K1's and K2's forward kernels included.  The recompute stops
    once the last tensor the backward reads is back, so each group's
    last product (its ``w_down``) is not recomputed, as XLA's is not.  It
    runs under the thread state of the forward
    (:func:`~repro_torch.parallel.context.thread_state`: mesh, rules, row
    axes, recording), on whichever thread autograd runs it; the MoE's
    drops it finds again are not tallied twice.  No layer draws random
    numbers, so no generator state is kept for it.  Without autograd the
    layers run one after the other, each activation freed as soon as the
    next layer no longer needs it."""
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if remat and torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in layers.parameters())):
        group = functools.partial(_stack, cfg, causal=causal, use_rope=use_rope, enc_out=enc_out,
                                  remat=False)
        for g in range(0, len(layers), cfg.group_size):
            x, aux = checkpoint(group, layers[g:g + cfg.group_size], x, aux=aux,
                                use_reentrant=False, preserve_rng_state=False,
                                context_fn=_recompute_as_forward)
        return x, aux
    positions = torch.arange(x.shape[1], device=x.device)
    for i, layer in enumerate(layers):
        mixer, akind, ffn = slot_kinds(cfg, i % cfg.group_size)
        h = rms_norm(x, layer.norm1, cfg.norm_eps)
        if mixer == "attn":
            x = x + attn.mha(cfg, layer.mixer, h, positions, kind=akind, causal=causal,
                             use_rope=use_rope)
        else:
            x = x + mb.mamba_mixer(cfg, layer.mixer, h)
        if enc_out is not None:
            h = rms_norm(x, layer.norm_cross, cfg.norm_eps)
            kv = attn.cross_heads(cfg, layer.cross, enc_out)
            x = x + attn.mha(cfg, layer.cross, h, positions, causal=False, use_rope=False,
                             kv_override=kv)
        x, a = _ffn(cfg, layer, x, ffn)
        if a is not None:
            aux = aux + a
    return x, aux


def _recompute_as_forward():
    """``checkpoint``'s contexts: none around the forward, the forward's
    thread state around the recompute (with a tally of its own, which the
    recompute's drops go to), inside the span ``recompute``."""
    state = ctx.thread_state()

    @contextlib.contextmanager
    def recompute():
        with ctx.use_thread_state(state), moe_mod.drop_tally(), span("recompute"):
            yield

    return contextlib.nullcontext(), recompute()


@contextlib.contextmanager
def _batch_rows(params: LM, n: int):
    """Run the body on this rank's block of a batch of ``n`` rows (all of
    them with no mesh); yields the axes the rows lie over.  A mesh forward
    that needs a gradient must split its rows over every batch axis (the
    gradients of leaves replicated over an axis are summed over it)."""
    with ctx.use_batch_rows(n) as axes:
        if (ctx.current_mesh() is not None and torch.is_grad_enabled()
                and set(axes) != set(ctx.physical_axes("batch"))
                and any(p.requires_grad for p in params.parameters())):
            raise ValueError(f"a mesh forward under autograd needs its {n} rows split over "
                             f"every batch axis {ctx.physical_axes('batch')}, not {axes}")
        yield axes


def _local(batch: dict) -> dict:
    return {k: ctx.local_rows(v) for k, v in batch.items()}


def _all_rows(x: torch.Tensor) -> torch.Tensor:
    """The rows of every rank (each rank then computes the same thing on
    them)."""
    return ctx.all_gather(x, ctx.batch_axes(), 0, adjoint="slice")


def encode(cfg: ModelConfig, params: LM, frames: torch.Tensor, *, cast: bool = True) -> torch.Tensor:
    """An encoder-decoder's encoder over precomputed ``frames`` (B,
    S_enc, D): the frames in the compute dtype plus sinusoidal positions,
    the encoder layers (non-causal, no rotary embeddings), its final norm.
    Returns the encoder output (B, S_enc, D), from which
    :func:`~repro_torch.models.attention.cross_kv` gives each decoder
    layer's cross-attention K and V.  ``cast=False`` takes ``params`` as
    :func:`cast_for_compute` returned them."""
    if cast:
        params = cast_for_compute(cfg, params)
    with _batch_rows(params, frames.shape[0]):
        return _all_rows(_encode(cfg, params, ctx.local_rows(frames)))


def _encode(cfg: ModelConfig, params: LM, frames: torch.Tensor) -> torch.Tensor:
    compute = torch_dtype(cfg.compute_dtype)
    frames = frames.to(compute)
    pos = sinusoidal_positions(frames.shape[1], cfg.d_model, device=frames.device).to(compute)
    h, _ = _stack(cfg, params.encoder.layers, frames + pos[None], causal=False, use_rope=False)
    return rms_norm(h, params.encoder.final_norm, cfg.norm_eps)


def _hidden(cfg: ModelConfig, params: LM, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """The decoder's hidden states after the final norm, and aux.  An
    encoder-decoder runs :func:`encode` over ``batch["enc_frames"]`` and
    adds ``dec_pos`` to the token embeddings; a ViT-patch frontend puts
    ``batch["patch_embeds"] @ frontend.proj`` before them."""
    enc_out = None
    x = _embed_tokens(cfg, params, batch["tokens"])
    if cfg.is_encoder_decoder:
        enc_out = _encode(cfg, params, batch["enc_frames"])
        x = x + params.dec_pos[None, : x.shape[1]].to(x.dtype)
    if cfg.frontend == "vit_patches":
        patches = batch["patch_embeds"].to(x.dtype) @ params.frontend.proj
        x = torch.cat([patches, x], dim=1)  # image tokens first
    x, aux = _stack(cfg, params.layers, x, causal=True,
                    use_rope=cfg.rotary and not cfg.is_encoder_decoder, enc_out=enc_out)
    return rms_norm(x, params.final_norm, cfg.norm_eps), aux


def forward_hidden(cfg: ModelConfig, params: LM, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward up to the final norm; returns ``(hidden,
    aux)`` (aux is the MoE balance loss, 0 without MoE)."""
    params = cast_for_compute(cfg, params)
    with _batch_rows(params, batch["tokens"].shape[0]):
        x, aux = _hidden(cfg, params, _local(batch))
        return _all_rows(x), aux


def forward(cfg: ModelConfig, params: LM, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward; returns ``(logits (B, S, padded vocab),
    aux)``, S counting a ViT frontend's patches."""
    params = cast_for_compute(cfg, params)
    with _batch_rows(params, batch["tokens"].shape[0]):
        x, aux = _hidden(cfg, params, _local(batch))
        return _all_rows(_unembed(cfg, params, x)), aux


def loss_fn(
    cfg: ModelConfig, params: LM, batch: dict, *, z_loss: float = 1e-4, aux_weight: float = 1e-2,
    cast: bool = True,
) -> tuple[torch.Tensor, dict]:
    """The reference's training loss: mean next-token NLL over
    ``batch["labels"]`` with the padded vocabulary masked out of the
    float32 softmax, plus ``z_loss * mean(lse**2)`` and ``aux_weight *
    aux`` (the MoE balance loss).  Returns ``(total, {"nll", "aux",
    "lse"})``, ``lse`` the mean log-sum-exp.  With a ViT-patch frontend
    the loss covers the text positions only.  ``cast=False`` takes
    ``params`` as :func:`cast_for_compute` returned them.

    Under a mesh each rank computes the terms on its rows (every rank the
    same number of tokens, no logits gathered across the batch axes) and
    averages them over the batch axes; ``aux`` arrives averaged already
    (``moe.moe_ffn``)."""
    if cast:
        params = cast_for_compute(cfg, params)
    with _batch_rows(params, batch["tokens"].shape[0]) as axes:
        x, aux = _hidden(cfg, params, _local(batch))
        logits = _unembed(cfg, params, x)
        labels = ctx.local_rows(batch["labels"])
    if cfg.frontend == "vit_patches":
        logits = logits[:, -labels.shape[1]:]
    logits = logits.float()
    vocab_ok = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab_size
    logits = torch.where(vocab_ok, logits, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    true_logit = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = (lse - true_logit).mean()
    total = ctx.pmean(nll + z_loss * (lse**2).mean(), axes) + aux_weight * aux
    return total, {"nll": ctx.pmean(nll, axes), "aux": aux, "lse": ctx.pmean(lse.mean(), axes)}


def prefill(cfg: ModelConfig, params: LM, batch: dict) -> torch.Tensor:
    """Prefill forward: full-sequence compute, last-position logits only
    ``(B, padded vocab)`` (serving never materializes the (B, S, vocab)
    logits)."""
    params = cast_for_compute(cfg, params)
    with _batch_rows(params, batch["tokens"].shape[0]):
        x, _ = _hidden(cfg, params, _local(batch))
        return _all_rows(_unembed(cfg, params, x[:, -1:])[:, 0])


# ---------------------------------------------------------------------------
# Serving: decode
# ---------------------------------------------------------------------------


class EncDecCache(NamedTuple):
    """An encoder-decoder's decode cache: each decoder layer's
    self-attention cache (``max_target_len`` slots) and its static cross
    cache of the encoder's K and V (``seq_len`` frames), which the caller
    fills from :func:`encode` and each layer's
    :func:`~repro_torch.models.attention.cross_kv`."""

    layers: list[attn.KVCache]
    cross: list[attn.KVCache]


def init_cache(
    cfg: ModelConfig, batch: int, seq_len: int, dtype: torch.dtype, *, device=DEFAULT_DEVICE
) -> list[attn.KVCache | mb.MambaCache] | EncDecCache:
    """Decode cache, one zeroed entry per layer: a
    :class:`~repro_torch.models.attention.KVCache` for an attention layer
    (an SWA layer's is a ring of ``sliding_window`` slots) or a
    :class:`~repro_torch.models.mamba.MambaCache` for a mamba layer (conv
    window in ``dtype``, state in float32).  An encoder-decoder gets an
    :class:`EncDecCache`: self-attention caches sized by
    ``max_target_len`` and zeroed cross caches of ``seq_len`` encoder
    frames.  Under a mesh it is this rank's part of that cache
    (``launch.mesh.shard_cache``: its rows, its block of each attention
    cache's slots with all KV heads, its mamba channels), allocated at
    that size: the whole cache is laid out on the ``meta`` device alone."""
    dev = resolve_device(device)
    if ctx.current_mesh() is not None:
        from repro_torch.launch.mesh import shard_cache

        with ctx.use_mesh(None):
            whole = _init_cache(cfg, batch, seq_len, dtype, torch.device("meta"))
        return _zeros_like_cache(shard_cache(cfg, whole), dev)
    return _init_cache(cfg, batch, seq_len, dtype, dev)


def _init_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype: torch.dtype, dev):
    size = cfg.max_target_len if cfg.is_encoder_decoder else seq_len
    cache = []
    for i in range(cfg.n_layers):
        mixer, akind, _ = slot_kinds(cfg, i % cfg.group_size)
        if mixer == "attn":
            cache.append(attn.init_kv_cache(cfg, batch, size, kind=akind, dtype=dtype, device=dev))
        else:
            cache.append(mb.init_mamba_cache(cfg, batch, dtype, dev))
    if not cfg.is_encoder_decoder:
        return cache
    cross = [attn.init_kv_cache(cfg, batch, seq_len, kind="full", dtype=dtype, device=dev)
             for _ in range(cfg.n_layers)]
    return EncDecCache(cache, cross)


def _zeros_like_cache(cache, dev):
    """``cache`` (a layout on any device) as zeros on ``dev``."""
    if isinstance(cache, EncDecCache):
        return EncDecCache(_zeros_like_cache(cache.layers, dev), _zeros_like_cache(cache.cross, dev))
    if isinstance(cache, list):
        return [_zeros_like_cache(c, dev) for c in cache]
    return cache._replace(**{
        f: torch.zeros(t.shape, dtype=t.dtype, device=dev)
        for f, t in cache._asdict().items() if isinstance(t, torch.Tensor)})


def decode_step(
    cfg: ModelConfig,
    params: LM,
    cache: list[attn.KVCache | mb.MambaCache] | EncDecCache,
    tokens: torch.Tensor,  # (B, 1) int
    pos: int,  # position of this token
    *,
    cast: bool = True,
) -> tuple[torch.Tensor, list[attn.KVCache | mb.MambaCache] | EncDecCache]:
    """One token for every sequence in the batch against the cache.
    Returns ``(logits (B, padded vocab), cache)``; the cache is updated in
    place (the reference returns a new one).  ``cast=False`` takes
    ``params`` as :func:`cast_for_compute` returned them, so a decode loop
    casts once rather than walking every parameter on every step.  An
    encoder-decoder adds ``dec_pos[pos]``, uses no rotary embeddings and
    attends each layer's cross cache after its self-attention.  A ViT
    frontend's decode sees tokens only, as the reference's does.  Under a
    mesh ``cache`` is this rank's part and ``tokens`` the whole batch."""
    if cast:
        params = cast_for_compute(cfg, params)
    with _batch_rows(params, tokens.shape[0]):
        return _all_rows(_decode(cfg, params, cache, ctx.local_rows(tokens), pos)), cache


def _decode(cfg: ModelConfig, params: LM, cache, tokens: torch.Tensor, pos: int) -> torch.Tensor:
    encdec = cfg.is_encoder_decoder
    x = _embed_tokens(cfg, params, tokens)
    if encdec:
        # the reference's dynamic_slice clamps pos into the table, so a
        # position past max_target_len - 1 reads the last row; so does this
        x = x + params.dec_pos[min(pos, cfg.max_target_len - 1)].to(x.dtype)
    layer_cache = cache.layers if encdec else cache
    for i, layer in enumerate(params.layers):
        mixer, akind, ffn = slot_kinds(cfg, i % cfg.group_size)
        h = rms_norm(x, layer.norm1, cfg.norm_eps)
        if mixer == "attn":
            h, layer_cache[i] = attn.mha_decode(cfg, layer.mixer, h, layer_cache[i], pos,
                                                kind=akind, use_rope=cfg.rotary and not encdec)
        else:
            h, layer_cache[i] = mb.mamba_decode(cfg, layer.mixer, h, layer_cache[i])
        x = x + h
        if encdec:
            h = rms_norm(x, layer.norm_cross, cfg.norm_eps)
            h, _ = attn.mha_decode(cfg, layer.cross, h, cache.cross[i], pos, cross=True,
                                   use_rope=False)
            x = x + h
        x, _ = _ffn(cfg, layer, x, ffn, decode=True)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return _unembed(cfg, params, x)[:, 0]
