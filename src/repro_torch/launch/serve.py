"""Serving launcher (port of ``repro.launch.serve``): batched
teacher-forced prefill through the decode path, then greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
        --reduced --batch 4 --prompt-len 16 --gen 16 [--device cpu]
    PYTHONPATH=src torchrun --standalone --nproc-per-node 8 \\
        -m repro_torch.launch.serve --reduced --mesh single --device cpu

Any decoder-only arch serves (attention, mamba and MoE layers), and so
does internvl2-2b on its tokens alone (its decode step never sees the
patches, as in the reference); an encoder-decoder (whisper-medium) is
refused with the reference's message, since the demo has no audio
frames.  At full size falcon-mamba-7b and qwen3-moe-30b-a3b fit one
H100.  The default
device is the card (``cuda``); without one it raises.  The weights are
random, drawn from a seeded ``torch.Generator`` on the device and cast
to the compute dtype leaf by leaf.

``--mesh single|multi`` serves across ranks (``launch.mesh``): it joins
torchrun's job (gloo on ``--device cpu``, NCCL on ``cuda:LOCAL_RANK``),
builds the production mesh, draws the whole model on every rank and keeps
this rank's shards under the decode cell's rules: the decode cache lies by
sequence (each rank a block of the slots, all KV heads), and a model too
large to replicate over ``data`` takes 2-D tensor parallelism
(``launch.mesh.serve_decode_param_rules``); rank 0 draws the prompts and
broadcasts them, and prints.
"""

from __future__ import annotations

import argparse
import time

import torch

import contextlib

import torch.distributed as dist

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.models import model as M


def generate(cfg, params, prompts, max_len, gen_tokens, *, device=DEFAULT_DEVICE):
    """Teacher-forced prefill through the decode path (fills the cache:
    K/V for an attention layer, the conv window and state for a mamba
    layer), then greedy generation.  Returns ``(B, P + gen_tokens)`` int32
    tokens: the prompts followed by the generated ones.  The cache is
    bfloat16 whatever the compute dtype (a mamba state float32), as in
    the reference."""
    dev = resolve_device(device)
    prompts = prompts.to(dev)
    B, P = prompts.shape
    cache = M.init_cache(cfg, B, max_len, torch.bfloat16, device=dev)
    params = M.cast_for_compute(cfg, params)  # once, not per step
    step = steps_lib.make_decode_step(cfg, cast=False)
    tok = prompts[:, :1]
    out = [tok[:, 0]]
    for t in range(P + gen_tokens - 1):
        nxt, _, cache = step(params, cache, tok, t)
        tok = prompts[:, t + 1 : t + 2] if t + 1 < P else nxt[:, None]
        out.append(tok[:, 0])
    return torch.stack(out, dim=1).to(torch.int32)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--mesh", default="none", choices=["none", "single", "multi"])
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.is_encoder_decoder:
        raise SystemExit("use an LM arch for this demo (enc-dec needs audio frames)")
    dev, owns_group = resolve_device(args.device), False
    cell = contextlib.nullcontext()
    if args.mesh != "none":
        dev, owns_group = mesh_lib.init_distributed(dev)
        mesh = mesh_lib.make_production_mesh(multi_pod=args.mesh == "multi")
        shape = ShapeConfig("serve", args.prompt_len + args.gen, args.batch, "decode")
        cell = mesh_lib.cell_context(mesh, cfg, shape)
    try:
        with cell:
            seqs, dt = _serve(cfg, args, dev)
        lead = args.mesh == "none" or dist.get_rank() == 0
    finally:
        if owns_group:
            dist.destroy_process_group()
    if lead:
        n_new = args.batch * args.gen
        print(f"generated {n_new} tokens on {dev} in {dt:.1f}s ({n_new / dt:.1f} tok/s)")
        print("first sequence:", seqs[0].tolist())


def _serve(cfg, args, dev):
    """Random weights (this rank's shards under a mesh) and prompts,
    then :func:`generate`; returns the sequences on the host and the
    seconds generation took."""
    gen = torch.Generator(device=dev)
    params = mesh_lib.shard_params(
        cfg, M.init_params(cfg, gen.manual_seed(0), device=dev, compute=True))
    shape = (args.batch, args.prompt_len)
    if args.mesh == "none" or dist.get_rank() == 0:
        prompts = torch.randint(0, cfg.vocab_size, shape, generator=gen.manual_seed(1),
                                device=dev, dtype=torch.int32)
    else:
        prompts = torch.empty(shape, device=dev, dtype=torch.int32)
    if args.mesh != "none":
        dist.broadcast(prompts, src=0)
    t0 = time.perf_counter()
    seqs = generate(cfg, params, prompts, args.prompt_len + args.gen, args.gen, device=dev)
    seqs = seqs.cpu()  # waits for the device
    return seqs, time.perf_counter() - t0


if __name__ == "__main__":
    main()
