"""Training launcher (port of ``repro.launch.train``).

Reduced configs run on the CPU; on a card the same entry point takes the
full config.  Fault tolerance: checkpoints every ``--save-every`` steps
(async), resumes automatically, EWMA straggler monitoring, deterministic
data replay.

``--mesh single|multi`` trains across ranks: it joins torchrun's job
(gloo on ``--device cpu``, NCCL on ``cuda:LOCAL_RANK``), builds the
production mesh and the training cell's rules, draws the whole model on
every rank from the seed and keeps this rank's shards.  Every rank draws
the whole global batch (one host's stream, as the reference's CLI does)
and the model cuts its rows; rank 0 writes the checkpoints and prints.

    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \\
        --steps 20 --batch 8 --seq 128
    PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
        --steps 6 --batch 4 --seq 2048 --accum 2
    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.train --reduced --mesh single --device cpu --steps 3
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.data.pipeline import TokenStream
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.runtime.fault_tolerance import StragglerMonitor, TrainLoop


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--reduced", action="store_true", help="smoke-scale config")
    ap.add_argument("--d-model", type=int, default=0, help="override width")
    ap.add_argument("--layers", type=int, default=0, help="override depth")
    ap.add_argument("--vocab", type=int, default=0, help="override vocab")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--compute-dtype", choices=["bfloat16", "float32"],
                    help="override the config's compute dtype")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--mesh", default="none", choices=["none", "single", "multi"])
    ap.add_argument("--ckpt-dir", default="build/train_ckpt")
    ap.add_argument("--save-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    overrides = {}
    if args.d_model:
        h = max(args.d_model // 64, 1)
        overrides.update(
            d_model=args.d_model, d_ff=4 * args.d_model,
            n_heads=h, n_kv_heads=max(h // 4, 1), d_head=64,
        )
    if args.layers:
        overrides["n_layers"] = args.layers * cfg.group_size
    if args.vocab:
        overrides["vocab_size"] = args.vocab
    if args.compute_dtype:
        overrides["compute_dtype"] = args.compute_dtype
    if overrides:
        cfg = dataclasses.replace(cfg, name=cfg.name + "-custom", **overrides)

    owns_group, cell = False, contextlib.nullcontext()
    if args.mesh != "none":
        dev, owns_group = mesh_lib.init_distributed(dev)
        mesh = mesh_lib.make_production_mesh(multi_pod=args.mesh == "multi")
        cell = mesh_lib.cell_context(mesh, cfg, ShapeConfig("train", args.seq, args.batch, "train"))
    try:
        with cell:
            _train(cfg, args, dev, lead=args.mesh == "none" or dist.get_rank() == 0)
    finally:
        if owns_group:
            dist.destroy_process_group()


def _train(cfg, args, dev, *, lead: bool) -> None:
    """Draw the model (this rank's shards under a mesh), train
    ``args.steps`` steps through :class:`TrainLoop`, and print on the
    ``lead`` rank."""
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    whole = M.init_params(cfg, gen, device=dev)
    n_params = sum(p.numel() for p in whole.parameters())
    params = M.train_mode(mesh_lib.shard_params(cfg, whole))
    del whole
    tree = steps_lib.param_tree(params)
    opt = adamw.init(tree, cfg.moment_dtype)
    if lead:
        print(f"arch={cfg.name} params={n_params/1e6:.1f}M steps={args.steps} device={dev}")

    schedule = adamw.cosine_schedule(args.lr, max(args.steps // 10, 1), args.steps)
    train_step = steps_lib.make_train_step(cfg, accum=args.accum, lr_schedule=schedule)
    stream = TokenStream(cfg, args.seq, args.batch, seed=args.seed, device=dev)

    def step_fn(state, step):
        _, opt = state
        _, opt, metrics = train_step(params, opt, stream.batch_at(step), step)
        return (tree, opt), {k: float(v) for k, v in metrics.items()}

    loop = TrainLoop(step_fn=step_fn, ckpt_dir=args.ckpt_dir, save_every=args.save_every,
                     monitor=StragglerMonitor(), cfg=cfg)
    t0 = time.time()
    (_, opt), step, history = loop.run((tree, opt), args.steps)
    dt = time.time() - t0
    if not lead:
        return
    first = history[0]["loss"] if history else float("nan")
    last = history[-1]["loss"] if history else float("nan")
    print(
        f"done: step={step} loss {first:.3f} -> {last:.3f} "
        f"({dt:.1f}s, {dt/max(len(history),1):.2f}s/step, "
        f"stragglers={len(loop.monitor.flagged)})"
    )
    print("losses:", [h["loss"] for h in history])


if __name__ == "__main__":
    main()
