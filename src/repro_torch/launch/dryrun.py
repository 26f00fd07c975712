"""The multi-pod dry run (port of ``repro.launch.dryrun``): every (arch x
shape) cell profiled as one rank of the single-pod 16 x 16 mesh and of
the 2 x 16 x 16 multi-pod mesh, in one process.

The reference lowers and compiles each cell's step on 256 or 512 fake
devices and reads the compiled module (``memory_analysis``,
``cost_analysis`` and the HLO's collectives).  The port has no compiler
to ask: :func:`build_cell` sets up rank 0's step on ``meta`` tensors
under a layout-only ``Mesh`` (no process group) and the cell's rules,
and :func:`run_cell` runs it through the counter source
(``core.meshsig.counters.count_program`` in ``"simulate"`` mode), which
records every collective the rank calls and counts its FLOPs, bytes and
memory.  Rank 0 holds full blocks of every cut (GSPMD's padded size).

Each record keeps the reference's keys where their meaning holds
(``status``, ``skip_reason``, ``params``, ``active_params``, ``accum``,
``collectives``); ``flops``, ``hbm_bytes`` and ``hbm_bytes_raw`` stand
for the ``hlo_*`` keys, ``memory`` holds the rank's argument, output and
peak temporary bytes (``counters``' storage lifetimes for
``memory_analysis``), and ``profile_s`` the seconds the profile took (no
compile happens).  Records are cached as JSON under ``--out``
(``build/dryrun`` by default), so reruns only profile missing cells::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all --mesh both
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import (
    SHAPES,
    ModelConfig,
    ShapeConfig,
    cell_supported,
    get_config,
    list_configs,
)
from repro_torch.core.meshsig.counters import count_program
from repro_torch.data.pipeline import batch_struct, decode_struct
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.parallel import context as ctx

ROOT = Path(__file__).resolve().parents[3]
DEFAULT_OUT = ROOT / "build" / "dryrun"
MESHES = {
    "single": (("data", "model"), (16, 16)),
    "multi": (("pod", "data", "model"), (2, 16, 16)),
}
SEED = 0  # of the parameters and inputs drawn off ``meta``


def layout_mesh(kind: str) -> ctx.Mesh:
    """The production mesh ``kind`` (``"single"`` or ``"multi"``) as a
    layout-only mesh at rank 0: the reference's ``make_production_mesh``
    shapes."""
    names, sizes = MESHES[kind]
    return ctx.Mesh(names, sizes, 0)


def _inputs(specs: dict, cfg: ModelConfig, dev: torch.device, generator) -> dict:
    """Tensors of the given specs: empty on ``meta``, else tokens drawn
    uniformly over the vocabulary and 0.02-scaled normal frames."""
    if dev.type == "meta":
        return {k: torch.empty(s.shape, dtype=s.dtype, device=dev) for k, s in specs.items()}
    out = {}
    for k, s in specs.items():
        if s.dtype.is_floating_point:
            t = torch.randn(s.shape, generator=generator) * 0.02
        else:
            t = torch.randint(0, cfg.vocab_size, s.shape, generator=generator)
        out[k] = t.to(s.dtype).to(dev)
    return out


def build_cell(cfg: ModelConfig, shape: ShapeConfig, *, device="meta") -> tuple:
    """``(step, args, meta)`` of this rank's step of a cell under the
    active mesh and rules (``launch.mesh.cell_context``), the counterpart
    of the reference's ``lower_cell``: parameters from ``init_params`` cut
    by ``shard_params`` (training: float32 masters, trainable, with
    AdamW's state; serving: in the compute dtype), the whole batch
    (``batch_struct``; decode: ``decode_struct``, its cache from
    ``init_cache``, this rank's part of it, and the position of the
    cache's last slot) and the step (``make_train_step`` with
    ``auto_accum``'s factor, ``make_prefill_step`` or
    ``make_decode_step``).  ``meta`` holds ``accum`` for training.  On
    ``meta`` nothing is drawn; elsewhere the parameters and inputs are
    drawn from :data:`SEED`."""
    dev = resolve_device(device)
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev).manual_seed(SEED)
    inputs_gen = torch.Generator().manual_seed(SEED + 1)
    meta: dict = {}
    if shape.kind == "train":
        params = M.train_mode(mesh_lib.shard_params(cfg, M.init_params(cfg, gen, device=dev)))
        opt = adamw.init(steps.param_tree(params), cfg.moment_dtype)
        batch = _inputs(batch_struct(cfg, shape), cfg, dev, inputs_gen)
        accum = steps.auto_accum(cfg, shape.global_batch)
        meta["accum"] = accum
        return steps.make_train_step(cfg, accum=accum), (params, opt, batch, 0), meta
    params = mesh_lib.shard_params(cfg, M.init_params(cfg, gen, device=dev, compute=True))
    if shape.kind == "prefill":
        batch = _inputs(batch_struct(cfg, shape), cfg, dev, inputs_gen)
        return steps.make_prefill_step(cfg), (params, batch), meta
    cache = M.init_cache(cfg, shape.global_batch, shape.seq_len, torch.bfloat16, device=dev)
    d = decode_struct(cfg, shape)
    tokens = _inputs({"tokens": d["tokens"]}, cfg, dev, inputs_gen)["tokens"]
    return steps.make_decode_step(cfg), (params, cache, tokens, shape.seq_len - 1), meta


def profile_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: ctx.Mesh):
    """``(counters, meta)`` of this ``mesh`` rank's step of a cell,
    simulated on ``meta`` (:func:`build_cell` and ``count_program``
    under the cell's rules)."""
    with mesh_lib.cell_context(mesh, cfg, shape):
        fn, args, meta = build_cell(cfg, shape)
        counters = count_program(fn, *args)
    return counters, meta


def run_cell(arch: str, shape_name: str, mesh_kind: str, *, out_dir: Path = DEFAULT_OUT,
             force: bool = False) -> dict:
    """Profile one cell as rank 0 of ``mesh_kind``'s mesh and write its
    record to ``out_dir`` (a cached record is returned unless it failed
    or ``force``)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    out_path = Path(out_dir) / f"{arch}__{shape_name}__{mesh_kind}.json"
    if out_path.exists() and not force:
        cached = json.loads(out_path.read_text())
        if cached.get("status") != "failed":  # failures always retry
            return cached

    mesh = layout_mesh(mesh_kind)
    record: dict = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_kind,
        "mesh_shape": mesh.shape,
        "rank": mesh.rank,
        "family": cfg.family,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    }
    ok, why = cell_supported(cfg, shape)
    if not ok:
        record["status"] = "skipped"
        record["skip_reason"] = why
        _write(out_path, record)
        return record
    try:
        counters, meta = profile_cell(cfg, shape, mesh)
        record.update(meta)
        record["profile_s"] = round(counters.seconds, 2)
        record["flops"] = counters.flops  # per rank
        record["hbm_bytes"] = counters.hbm_bytes  # fusion-idealised model
        record["hbm_bytes_raw"] = counters.hbm_bytes_raw  # upper bound
        record["memory"] = counters.memory
        record["collectives"] = counters.collective_summary()
        record["kernels"] = counters.kernels
        record["status"] = "ok"
    except Exception as e:
        record["status"] = "failed"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
    _write(out_path, record)
    return record


def _write(path: Path, record: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(record, indent=1, default=str))


def peak_bytes(record: dict) -> int:
    """A profiled cell's per-rank peak: its arguments plus its
    temporaries' peak."""
    mem = record["memory"]
    return mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", choices=["all", *SHAPES])
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--out", type=Path, default=DEFAULT_OUT, help="record directory")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()

    archs = list_configs() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    n_fail = 0
    for arch in archs:
        for shape_name in shapes:
            for mesh_kind in meshes:
                t0 = time.time()
                rec = run_cell(arch, shape_name, mesh_kind, out_dir=args.out, force=args.force)
                status = rec.get("status")
                extra = ""
                if status == "ok":
                    link = rec["collectives"]["link_bytes_total"]
                    extra = (f"flops/rank={rec['flops']:.3e} link_bytes/rank={link:.3e} "
                             f"peak/rank={peak_bytes(rec) / 2**30:.2f} GiB "
                             f"of {mesh_lib.NOMINAL_CARD_BYTES / 2**30:.0f} GiB")
                elif status == "failed":
                    n_fail += 1
                    extra = rec.get("error", "")[:200]
                elif status == "skipped":
                    extra = rec.get("skip_reason", "")
                print(f"[{time.strftime('%H:%M:%S')}] {arch:24s} {shape_name:12s} {mesh_kind:6s} "
                      f"{status:8s} ({time.time() - t0:6.1f}s) {extra}", flush=True)
    if n_fail:
        raise SystemExit(f"{n_fail} cells failed")


if __name__ == "__main__":
    main()
