"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout and
drives the port's paths on ``cuda`` in phases, one JSON line each:

1. device — the card, its power limit and the float32 matmul settings;
2. build — nvcc of every kernel source, K1's two backward sources (bf16
   and float32), K2's backward and the mixer passes' source included (all
   started together), with
   each library's tensor-core (HGMMA, HMMA) and exp2 (MUFU.EX2)
   instructions counted in its SASS (both bf16 K1 libraries must hold
   HGMMA), and each kernel's registers, shared memory, stack and local
   bytes as the built library records them (no float32 K1 backward, no
   N = 16 K2 backward and no mixer pass kernel may spill);
3. selective_scan — the mamba-1 scan through ``ssm_scan`` at falcon-mamba-7b
   width (B=2, S=2048, d_inner=8192, N=16) and at a long prompt of one
   sequence (B=1, S=8192), each held against the plain version, with its
   time beside the bytes bound and the exp pipe's floor;
4. flash_attention — K1 against its plain version at llama3-8b's prefill
   shape (B=4, H=32, Kv=8, S=2048, dh=128) and at gemma2-9b's (B=1, H=16,
   Kv=8, S=8192, dh=256, window 4096, soft-cap 50, scores driven into the
   cap), each in bf16 (the tensor-core kernel) and float32 (the CUDA-core
   kernel), and at h2o-danube-1.8b's (B=1, H=32, Kv=8, S=8192, dh=80,
   window 4096) and qwen3-moe-30b-a3b's (B=2, H=32, Kv=4, S=2048,
   dh=128: GQA 8:1) in bf16, and whisper-medium's encoder (B=8, H=Kv=16,
   S=1500, dh=64, non-causal) and cross-attention (Sq=448 against
   Skv=1500, non-causal) in bf16 and float32, with its time, its bound and
   PyTorch's SDPA beside it;
   flash_attention_backward — K1's backward kernels (bf16 on the tensor
   cores, float32 register-blocked on CUDA cores) against the plain
   backward at llama3-8b's shape (bf16 and float32), h2o-danube-1.8b's
   training micro-batch (B=2 x 2,048) and long row (B=1 x 8,192, window
   4,096; bf16 and float32), gemma2-9b's (dh 256, window, soft-cap 50;
   bf16 and float32), qwen3-moe-30b-a3b's (GQA 8:1) and whisper-medium's
   cross-attention (bf16 and float32): float32 within
   rel 1e-4, bf16 2e-2 of each gradient's scale, two calls bit-equal, and
   dropping the window, the soft-cap or the GQA group sum moving the plain
   gradient past that; its time beside 2.5 times the forward's operations
   bound, the plain backward's, SDPA's and the first CUDA-core kernel's (a
   constant quoted from PERF.md);
   selective_scan_backward — K2's backward kernel against its plain
   backward at the two scan shapes, rel 1e-4, bit-equal, one launch a call,
   its time beside its bytes bound, its blocks an SM and the bytes its
   design adds;
   mamba_mixer — the mixer's three prefill passes around K2 (conv with
   its SiLU, dt softplus, D skip with the silu(z) gate) at
   falcon-mamba-7b's width in bf16, B = 1 x 1,024 and x 8,192, each
   against its plain version on the card within one bf16 ulp, one launch
   a call, its time beside its bytes bound and the plain version's;
5. quickstart — profile_pair -> fit_signature -> predict_counters on the
   E5-2699 v3 (the paper's pipeline; error < 5%);
6. sweeps — the three placement sweeps through ``evaluate_batch``, noisy
   median error against the committed values, placements/s, and the
   noise-free sweep held against the same code on the CPU;
7. placement_search — ``optimize_placement`` and ``branch_and_bound`` on
   E7-4830 v3 (24 threads) and E5-2699 v3 SNC-2 (16) against the card's
   exhaustive sweep (0% regret), on the 16-node snc2-8s at 32 threads
   (held against the CPU, one ascent step profiled), and the tight
   16-node machine's cold (4,000 nodes, no certificate) and warm (0
   nodes, certified) receipts;
8. schedule_search — the three schedule-search records, ``gain_pct``
   within 0.005 pp of the CPU's, the prohibitive case exactly 0;
9. service — the advisor service on E7-4830 v3 at 24 threads: batch tier,
   cache tier, a mixed stream, answers held against the CPU, concurrent
   answers held against serial ones; the search tier (snc2-8s at 32
   threads) and the schedule tier (E5-2630 v3) against the CPU; the
   advisor CLI's stream with 2% search queries;
10. calibration — blind 200-step fits (``fit_machine`` on the card) of
   E7-8860 v3 (157 probes) and E5-2699 v3 SNC-2 (49) from noise-free
   probe sweeps: every link within 5%, the refit machine's noisy sweep
   median within 0.25 pp of the truth's, the fitted parameters within rel
   1e-3 of the port's fit of the same samples on the CPU; then snc2-8s
   (565 probes, 36 links), its worst link within 0.01 of the CPU's; each
   fit's seconds and losses, and one AdamW step under the profiler (run
   first under ``torch.cuda.set_sync_debug_mode("error")``);
   meshsig — the mesh-domain link fit: the perturbed 4 x 4 ICI torus (32
   links, blind) and two hosts of 8 NVLink-switched devices (64 links, one
   parameter per link class), each from one noisy collective sweep fitted
   200 steps on the card and on the host CPU: links within rel 1e-3 of
   the CPU's, the worst within 5% of the truth, one step under the
   profiler; then ``advise_mesh_shape`` for 8 H100s on one NVLink island
   and 16 on two, each order equal to the CPU port's committed one, the
   island's routed step times equal to the scalar model's;
11. service_resilience — the three records of
   ``benchmarks/serve_resilience.py`` on the card: a 1,000-query chaos
   stream under injected batch stalls and failures, batcher deaths and
   search failures (no query past its 0.25 s deadline plus 1 s, every
   answer fidelity-tagged), the recovery time, and a live recalibration
   under a sustained stream (NaN rows rejected at ingest, one swap, one
   guard rollback, no torn read, epoch-1 objectives against the CPU port,
   the stream's p99 with and without the fit); the slowest chaos
   queries' wall time split into the wait for the exact tiers and the
   ladder; then each ladder rung forced once;
12. lm_reduced — the reduced llama3-8b, gemma2-9b, h2o-danube-1.8b,
   falcon-mamba-7b, jamba-1.5-large-398b, mixtral-8x22b,
   qwen3-moe-30b-a3b, whisper-medium (40 encoder frames) and internvl2-2b
   (8 patch embeddings): prefill and generate on the card against the
   port on the CPU with the same weights, K1 launched once per attention
   call (encoder, decoder and cross) and K2 once per mamba layer;
   lm_reduced_train — one float32 train step of each of those nine on the
   card against the port on the CPU with the same weights and batch: loss
   within rel 1e-4, gradient norm within rel 1e-3, K1 and K2 forward and
   backward once per attention call and mamba layer;
13. lm_danube — h2o-danube-1.8b at full width and depth (random bf16
   weights from a seed): prefill of 2 x 8192 tokens, where the 4096-token
   window acts, K1 (dh 80) launched once per layer;
   lm_whisper — whisper-medium at full size: prefill of 8 x 1,500
   encoder frames x 448 decoder tokens (K1 72 times), generation at B=4
   with the cross cache filled once from the encoder (4 prompt tokens +
   60 new), and the decode path's logits at the last prompt position
   held against the prefill's in bf16 and float32;
   lm_internvl2 — internvl2-2b at full size: prefill of 4 x (256 patch
   embeddings + 1,792 tokens) (K1 24 times), generation on tokens
   (4 x 64 + 32);
14. lm_serve — llama3-8b at full width and depth (random weights from a
   seed, bf16): init, prefill of 4 x 2048 tokens (K1 launched once per
   layer), generate (4 x 64 prompt + 32 tokens), and the prefill's
   logits held against the decode path's;
15. lm_falcon_mamba — falcon-mamba-7b at full width and depth (64 mamba
   layers, bf16): prefill of 2 x 2048 tokens (K2 and each mixer pass
   launched once per layer), generate (4 x 64 prompt + 32 tokens), and the prefill's
   logits held against the decode path's in float32 and bf16, with the
   bf16 gap read at 8, 16, 32 and 64 layers and each bf16 path's
   distance from its float32 run;
   lm_danube_train — h2o-danube-1.8b at full size in training: float32
   weights and moments, bf16 compute, 4 x 2,048 tokens in two
   micro-batches, six AdamW steps on one batch (the loss falls; K1 24
   times backward and 48 times forward per micro-batch, the layers'
   forwards recomputed in the backward), tokens/s, peak memory and one
   step under the profiler (K1 backward's share of the step's device time
   below 20%); the first two steps again keeping every activation
   (``remat=False``), their losses, gradient norms and parameters bit-equal
   to the recomputing run's, their peak and ms beside; then ``TrainLoop`` with a
   checkpoint at step 3 and a failure injected at step 4, whose resumed
   steps 4-6 and final parameters must equal the uninterrupted run's bit
   for bit;
   lm_falcon_mamba_train — falcon-mamba-7b at full width with 8 of its 64
   layers (AdamW's float32 state for all 64 would not fit on the card):
   four steps at 2 x 2,048, the loss falls, K2 16 times forward (8 of
   them the recompute) and 8 times backward a step;
16. lm_qwen3_moe — qwen3-moe-30b-a3b at full width and depth (48 layers
   of GQA 32:4 attention and 128 experts top-8, 61.1 GB of bf16 weights,
   alone on the card): prefill of 2 x 2048 tokens (K1 launched once per
   layer) with the count of (token, expert) assignments dropped over
   capacity, and generate (4 x 16 prompt + 16 tokens);
17. lm_mesh — serving across ranks at one rank: a process group of one
   (``cpu:gloo,cuda:nccl``) and ``--mesh single``'s mesh, the reduced
   llama3-8b, gemma2-9b, falcon-mamba-7b, qwen3-moe-30b-a3b and
   jamba-1.5-large-398b through the mesh code on the card against the same
   code on the CPU; the sequence-sharded decode cache at full size, each
   against ``--mesh none`` bit for bit: llama3-8b at B = 1 with a
   32,768-slot cache (4.29 GB) filled from a seeded generator, 8 decode
   steps from position 32,760 under the ``long`` decode cell (the
   sequence over every axis), and h2o-danube-1.8b at the ``long_500k``
   shape (B = 1, a 4,096-slot ring at positions 524,280-524,287); then
   qwen3-moe-30b-a3b at full size (lm_qwen3_moe runs here, after the long
   caches are freed): the gather path's prefill of 2 x 2048 against
   lm_qwen3_moe's ``--mesh none`` logits (K1 48 times), the all-to-all
   path's prefill with its dropped assignments beside the gather path's,
   and generate (4 x 16 prompt + 16 tokens) through 2-D decode tensor
   parallelism (its weights exceed a quarter of the card) and the
   no-gather MoE decode path, its tokens equal to lm_qwen3_moe's and its
   decode step's ms beside theirs;
18. lm_mesh_train — training across ranks at one rank, in a process group
   of one and the (1, 1) mesh under the training cell's rules: two
   float32 train steps of the five reduced archs of 17 through the mesh
   code on the card against the same code on the CPU (loss within rel
   1e-4, gradient norm within rel 1e-3); h2o-danube-1.8b at full size in
   lm_danube_train's cell (4 x 2,048, accum 2, from the same seed and
   batch), its two steps through the mesh train step held bit for bit
   against lm_danube_train's first two (losses, gradient norms and every
   parameter), K1's backward launches a step (48) and the step's wall
   time beside the no-mesh step's; lm_falcon_mamba_train's first step
   through the mesh code (K2's backward 8 times, the loss and gradient
   norm bit-equal);
   ``compressed_psum_mean`` at one rank returning its input;
19. dryrun — the counter source, the dry run and the mesh-signature
   validation: ``run_validation`` of llama3-8b's ``train_4k`` on ``meta``
   over the five meshes of 256 ranks (class fractions, each mesh's
   errors, the median and largest, the advisor's and the measured
   orders; the fit giving back its two runs' model-axis link bytes to
   1e-6 of their totals); llama3-8b's prefill (4 x 2,048) and
   h2o-danube-1.8b's train step (4 x 2,048, accum 2) counted on the card
   (``"observe"``) and on ``meta`` at one rank: FLOPs equal, argument
   bytes equal, the predicted peak within 2% of the card's, danube's
   FLOPs within 1% of its operations count (the recompute included), no
   collective; every arch's
   ``prefill_32k`` and ``decode_32k`` dry-run cells on the 16 x 16 mesh.

Every profile whose kernel has a launch counter is held to it
(``watched_complete``).  Then one line listing every kernel of the port
with its launches, error and times, the card's name and power limit as nvidia-smi prints them,
and, last, ``{"ok": true, "device": {...}}``.  Any failed check exits
non-zero before the last line; nothing is caught.  Without CUDA, or
without the repository's ``src/`` beside it, it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import json
import re
import shutil
import subprocess
import sys
import threading
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the kernels' own work rules, which the counter source uses too (fails
# outside a checkout of the repository)
from repro_torch.kernels.flash_attention.kernel import attention_pairs  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import flash_work as k1_work  # noqa: E402
from repro_torch.kernels.mamba_scan.kernel import scan_bwd_work, scan_work  # noqa: E402

# H100 SXM published peaks (NVIDIA's H100 datasheet): HBM bytes/s,
# float32 (no tensor core) and dense bf16 tensor-core operations/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
# exp2 results a clock on each SM (MUFU.EX2; CUDA C Programming Guide,
# arithmetic instruction throughput, compute capability 9.0)
EX2_PER_SM_CLOCK = 16

# committed median_error_pct of the three placement-sweep records
# (benchmarks/sweep_baseline.json), model outputs the port must reproduce
SWEEPS = (
    ("4-socket fully-connected", "E7_4830_V3", 24, None, 0.0545),
    ("8-socket glued (routed)", "E7_8860_V3", 32, 512, 0.0267),
    ("2-socket SNC-2 (4 nodes)", "E5_2699_V3_SNC2", 16, None, 0.0516),
)
SWEEP_BENCHMARKS = ("Swim", "CG", "EP", "NPO")
MEDIAN_TOL_PP = 0.25


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def sync() -> None:
    torch.cuda.synchronize()


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds of ``fn`` over ``iters`` calls, by CUDA events,
    after one warm-up call (a library's first call loads its kernels)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


PROFILE_TRIES = 3


def device_profile(fn, watch: str | None = None, top: int = 3,
                   expected: int | None = None) -> dict:
    """Where one call of ``fn`` spends its time: the host wall time (best
    of three unprofiled calls, each ending in a synchronise), the device
    time of the kernels one profiled call launched (the union of their
    intervals, from ``torch.profiler``), the device's busy share of the
    wall time, the ``top`` kernels with the most device time, the device
    time and count of the kernels whose name holds ``watch``, and the
    host's most frequent CUDA runtime calls (launches, synchronisations,
    copies).

    ``expected`` is the watched kernel's launches in one call, read from
    its wrapper's counter.  The profiler can drop kernels from a trace, so
    the profiled call is repeated, up to ``PROFILE_TRIES`` times, until
    the trace lists exactly that many; ``watched_complete`` says whether it
    did.  A trace that still lists another count fails the phase rather
    than report a short device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        sync()
        walls.append(time.perf_counter() - t0)
    wall_ms = 1e3 * min(walls)
    counts = []
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        events = prof.events()
        spans = sorted(  # the program's spans show on the device's timeline too
            (e.time_range.start, e.time_range.end, e.name)
            for e in events
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation
        )
        per_name = {}
        for start, stop, name in spans:
            ms, count = per_name.get(name, (0.0, 0))
            per_name[name] = (ms + (stop - start) / 1e3, count + 1)
        watched = [(ms, n) for name, (ms, n) in per_name.items() if watch and watch in name]
        counts.append(sum(n for _, n in watched))
        if expected is None or counts[-1] == expected:
            break
    complete = None if expected is None else counts[-1] == expected
    check(complete is not False,
          f"the profiler listed {counts} '{watch}' kernels in {len(counts)} traces of one "
          f"call; its counter says {expected}")
    busy_us, end = 0.0, float("-inf")
    for start, stop, _ in spans:
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:top]
    runtime = Counter(
        e.name for e in events
        if e.device_type == DeviceType.CPU and e.name.startswith("cuda")
    )
    device_ms = busy_us / 1e3 if spans else None
    return {
        "wall_ms": wall_ms,
        "device_ms": device_ms,
        "busy_share": device_ms / wall_ms if spans else None,
        "device_ops": len(spans),
        "top_kernels": [
            {"name": name[:80], "ms": ms, "count": count} for name, (ms, count) in ranked
        ],
        "watched": {"name": watch, "ms": sum(ms for ms, _ in watched),
                    "count": counts[-1], "expected": expected,
                    "counts_per_trace": counts} if watch else None,
        "watched_complete": complete,
        "runtime_calls": dict(runtime.most_common(5)),
    }


# ---------------------------------------------------------------------------


def nvidia_smi(query: str, *formats: str) -> str:
    """One ``nvidia-smi --query-gpu`` answer for the first card."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={','.join(('csv', 'noheader', *formats))}"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def phase_device() -> str:
    smi = nvidia_smi("name,power.limit")
    from repro_torch import resolve_device

    resolve_device("cuda")  # raises without CUDA; turns TF32 off
    emit(
        "device",
        nvidia_smi=smi,
        name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(),
        torch=torch.__version__,
        cuda=torch.version.cuda,
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
        float32_matmul_precision=torch.get_float32_matmul_precision(),
    )
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    return smi


def sass_counts(lib: Path) -> dict[str, int]:
    """Instructions in a library's SASS: HGMMA (wgmma) and HMMA (mma.sync)
    on the tensor cores, MUFU.EX2 (exp2) on the special-function unit."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    return {op: len(re.findall(rf"\b{re.escape(op)}\b", sass))
            for op in ("HGMMA", "HMMA", "MUFU.EX2")}


def resource_usage(lib: Path) -> list[dict]:
    """Each kernel's registers, static shared memory, stack frame and
    local (spill) bytes as the built library records them
    (``cuobjdump -res-usage``), so a library already built reports too."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([cuobjdump, "-res-usage", str(lib)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    kernels = []
    for line in text.splitlines():
        if m := re.search(r"Function (\S+?):?\s*$", line):
            kernels.append({"kernel": m.group(1)})
        elif kernels and (m := re.search(
                r"REG:(\d+) STACK:(\d+) SHARED:(\d+) LOCAL:(\d+)", line)):
            kernels[-1].update(registers=int(m.group(1)), stack_bytes=int(m.group(2)),
                               static_smem_bytes=int(m.group(3)), local_bytes=int(m.group(4)))
    return kernels


def phase_build() -> None:
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.mamba_mixer import kernel as mixer_kernel
    from repro_torch.kernels.mamba_scan import kernel as scan_kernel

    sources = [scan_kernel.SOURCE, scan_kernel.BWD_SOURCE, *flash_kernel.SOURCES.values(),
               *flash_kernel.BWD_SOURCES.values(), mixer_kernel.SOURCE]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = list(pool.map(build.build, sources))
    seconds = time.perf_counter() - t0
    for lib in libs:
        check(lib.exists(), f"{lib} was not built")
    sass = {src.name: sass_counts(lib) for src, lib in zip(sources, libs)}
    usage = {src.name: resource_usage(lib) for src, lib in zip(sources, libs)}
    emit(
        "build",
        seconds=round(seconds, 3),
        libraries=[str(p.relative_to(ROOT)) for p in libs],
        sass_instructions=sass,
        resource_usage=usage,
        selective_scan_tiles={n: scan_kernel.tiles(n) for n in scan_kernel.STATE_WIDTHS},
    )
    for bf16 in (flash_kernel.SOURCES[torch.bfloat16].name,
                 flash_kernel.BWD_SOURCES[torch.bfloat16].name):
        check(sass[bf16]["HGMMA"] > 0, f"{bf16} has no wgmma (HGMMA) in its SASS")
    scan = scan_kernel.SOURCE.name
    check(sass[scan]["MUFU.EX2"] > 0, f"{scan} has no MUFU.EX2 in its SASS")
    # the float32 K1 forward and backward (every instantiation) and K2's
    # backward at N = 16 keep nothing in local memory (a spill)
    f32_fwd = flash_kernel.SOURCES[torch.float32].name
    f32_bwd, scan_bwd = flash_kernel.BWD_SOURCES[torch.float32].name, scan_kernel.BWD_SOURCE.name
    for name in (f32_fwd, f32_bwd, scan_bwd):
        check(len(usage[name]) >= 2 and all("registers" in k for k in usage[name]),
              f"cuobjdump reported no resource usage for {name}: {usage[name]}")
    # one forward kernel for each head dim, with and without the soft-cap
    check(len(usage[f32_fwd]) == 2 * len(flash_kernel.HEAD_DIMS),
          f"{f32_fwd}: {len(usage[f32_fwd])} kernels in its resource usage, want "
          f"{2 * len(flash_kernel.HEAD_DIMS)}")
    # the mixer's three passes, each in two dtypes and two vector widths
    mixer = mixer_kernel.SOURCE.name
    check(len(usage[mixer]) == 12 and all("registers" in k for k in usage[mixer]),
          f"{mixer}: {len(usage[mixer])} kernels in its resource usage, want 12")
    checked = (usage[f32_fwd] + usage[f32_bwd] + usage[mixer]
               + [k for k in usage[scan_bwd] if "ILi16E" in k["kernel"]])
    check(any("ILi16E" in k["kernel"] for k in usage[scan_bwd]),
          f"{scan_bwd} has no N = 16 kernel in its resource usage")
    spilled = [k["kernel"] for k in checked if k["local_bytes"] or k["stack_bytes"]]
    check(not spilled, f"kernels spill registers: {spilled}")


def scan_inputs(B, S, di, n, seed, device):
    """The kernel test's input distribution, from a numpy seed."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a.astype(np.float32), device=device)

    dt = t(np.log1p(np.exp(rng.standard_normal((B, S, di)) - 2.0)))
    a = t(-np.exp(rng.standard_normal((di, n)) * 0.3))
    b = t(rng.standard_normal((B, S, n)) * 0.5)
    c = t(rng.standard_normal((B, S, n)) * 0.5)
    x = t(rng.standard_normal((B, S, di)))
    return dt, a, b, c, x


SCAN_SHAPES = (
    # label, (B, S, d_inner, N): falcon-mamba-7b's width (configs/falcon_mamba_7b.py)
    ("falcon-mamba-7b B=2", (2, 2048, 8192, 16)),
    ("falcon-mamba-7b long prompt B=1", (1, 8192, 8192, 16)),
)


def phase_selective_scan() -> dict:
    """K2 at each of ``SCAN_SHAPES`` through ``ssm_scan``, held against the
    plain version at atol = rtol = 1e-4, with bf16 inputs at 2e-2 at the
    first shape.  Its time stands beside the bytes bound (dt and x read, y
    written), the float32 operations bound and the exp pipe's floor (one
    exponential per (b, t, d, n) at 16 a clock on each SM at the card's
    highest SM clock).  Returns the first shape's numbers for the kernels
    line."""
    from repro_torch.kernels.mamba_scan.kernel import selective_scan, tiles
    from repro_torch.kernels.mamba_scan.ops import ssm_scan
    from repro_torch.kernels.mamba_scan.ref import selective_scan_ref

    sm_clock_hz = float(nvidia_smi("clocks.max.sm", "nounits")) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    row = None  # the first shape's, for the kernels line
    for label, (B, S, di, n) in SCAN_SHAPES:
        dt, a, b, c, x = scan_inputs(B, S, di, n, 0, "cuda")

        # the path run: counts from zero, read right after
        selective_scan.launches = 0
        y = ssm_scan(dt, a, b, c, x)
        sync()
        launches = selective_scan.launches
        check(launches == 1, f"{label}: ssm_scan launched the CUDA kernel {launches} times, not once")

        want, _ = selective_scan_ref(dt, a, b, c, x)
        sync()
        max_abs = float((y - want).abs().max())
        max_rel = max_abs / float(want.abs().max())
        used = tolerance_used(y, want, 1e-4, 1e-4)
        check(bool(torch.isfinite(y).all()), f"{label}: scan output is not finite")
        check(used <= 1.0, f"{label}: scan disagrees with the plain version: max abs {max_abs}")
        del y, want

        bf16_err = None
        if row is None:
            # bf16 inputs through the public wrapper, against the plain scan
            # of the same bf16-rounded inputs
            bf = [t.to(torch.bfloat16) for t in (dt, b, c, x)]
            y16 = ssm_scan(bf[0], a, bf[1], bf[2], bf[3])
            want16, _ = selective_scan_ref(*(t.float() for t in bf[:1]), a,
                                           *(t.float() for t in bf[1:]))
            sync()
            bf16_err = float((y16 - want16).abs().max())
            check(within(y16, want16, 2e-2, 2e-2), f"{label}: bf16 scan disagrees: max abs {bf16_err}")
            del bf, y16, want16

        for _ in range(3):
            selective_scan(dt, a, b, c, x)
        kernel_ms = cuda_ms(lambda: selective_scan(dt, a, b, c, x), 20)
        plain_ms = cuda_ms(lambda: selective_scan_ref(dt, a, b, c, x), 2)

        elems = B * S * di
        # per (b,t,d,n): dt*a, exp, *h, *b, +, *c, +; dt, x, y, b, c and a moved
        ops, bytes_moved = scan_work(B, S, di, n)
        bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_OPS_PER_S * 1e3
        exp_ms = elems * n / (sms * EX2_PER_SM_CLOCK * sm_clock_hz) * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        row = row or {
            "name": "selective_scan",
            "route": "cuda",
            "source": "src/repro_torch/kernels/mamba_scan/csrc/selective_scan.cu",
            "replaces": "src/repro/kernels/mamba_scan/kernel.py:61",
            "launches": launches,
            "max_abs_err": max_abs,
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,  # no single PyTorch call computes the scan
        }
        emit(
            "selective_scan",
            case=label,
            shape=[B, S, di, n],
            tiles=tiles(n),
            max_abs_err=max_abs,
            max_rel_err=max_rel,
            tolerance_used=used,
            bf16_max_abs_err=bf16_err,
            launches=launches,
            kernel_ms=kernel_ms,
            plain_ms=plain_ms,
            bound_ms=bound_ms,
            bytes_bound_ms=bytes_ms,
            ops_bound_ms=ops_ms,
            exp_floor_ms=exp_ms,
            exp_floor_inputs=dict(exps=elems * n, sms=sms, ex2_per_sm_clock=EX2_PER_SM_CLOCK,
                                  sm_clock_mhz=sm_clock_hz / 1e6),
            kernel_gb_per_s=bytes_moved / kernel_ms / 1e6,
            share_of_bound=bound_ms / kernel_ms,
        )
        del dt, a, b, c, x
        torch.cuda.empty_cache()
    return row


def flash_work(q, k, causal: bool, window: int) -> tuple[int, float, float]:
    """``(ops, bytes_ms, ops_ms)`` of one attention call: 4 * dh
    operations per visible (row, col) pair (QK^T and PV) at the peak rate
    of the inputs' type, against q, k, v read once and o written once
    (the kernel's own rule, ``kernel.flash_work``)."""
    ops, moved = k1_work(q, k, causal=causal, window=window)
    peak = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else F32_OPS_PER_S
    return ops, moved / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3


def tolerance_used(got: torch.Tensor, want: torch.Tensor, atol: float, rtol: float) -> float:
    """The largest ``|got - want| / (atol + rtol * |want|)``, in float32:
    at most 1 where ``got`` lies within the tolerance of ``want``."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def within(got: torch.Tensor, want: torch.Tensor, atol: float, rtol: float) -> bool:
    """Elementwise ``|got - want| <= atol + rtol * |want|``, in float32."""
    return tolerance_used(got, want, atol, rtol) <= 1.0


# K1's tolerances against its plain version (which also computes in float32
# and rounds to q's dtype): float32 that of tests/test_kernels.py; bf16 one
# output ulp (at most 2^-7 relative) plus twice the largest error read on
# the H100 at 0.5-scaled inputs (1.95e-3).  The bf16 kernel also rounds its
# probabilities to bf16 (2^-9 relative a weight) inside that tolerance.
FLASH_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (4e-3, 1e-2)}
# K1's float32 forward at each float32 case on the first CUDA-core kernel,
# before the register-blocked kernel replaced it (PERF.md §6, NVIDIA H100
# 80GB HBM3 at 700.00 W: chip_smoke for llama3 and gemma2; danube the mean
# of four turns of tools/flash_f32_ab.py with the first kernel's source)
CUDA_CORE_FWD_MS = {
    "llama3-8b prefill f32": 6.4259,
    "gemma2-9b prefill f32": 36.938,
    "h2o-danube-1.8b prefill f32": 13.487,
}


def chunked_ref(q, k, v, options: dict, rows: int) -> torch.Tensor:
    """The plain version over q's rows, ``rows`` at a time, for causal
    attention: chunk ``[a, b)`` sees the keys up to its last row's
    position, so right-aligning it against ``k[:, :, :b + Skv - Sq]`` puts
    its rows where they sit in the whole."""
    from repro_torch.kernels.flash_attention.ref import attention_ref

    sq, skv = q.shape[2], k.shape[2]
    out = torch.empty_like(q)
    for a in range(0, sq, rows):
        b = min(a + rows, sq)
        end = b + skv - sq
        out[:, :, a:b] = attention_ref(q[:, :, a:b], k[:, :, :end], v[:, :, :end], **options)
    return out


def plain_bf16_probabilities(q, k, v) -> torch.Tensor:
    """The plain version (causal, no window or cap) with the bf16 kernel's
    one rounding the plain version lacks: the unnormalised probabilities
    rounded to bf16 before the P V product, their row sums kept in
    float32."""
    H, sq, dh = q.shape[1], q.shape[2], q.shape[3]
    kv, skv = k.shape[1], k.shape[2]
    k, v = (t.repeat_interleave(H // kv, dim=1).float() for t in (k, v))
    logits = q.float() @ k.transpose(-1, -2) * dh**-0.5
    rows = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    logits = torch.where(torch.arange(skv, device=q.device) <= rows, logits, -1e30)
    w = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return ((w.to(torch.bfloat16).float() @ v) / w.sum(dim=-1, keepdim=True)).to(q.dtype)


def phase_flash_attention() -> dict:
    """K1 against its plain version at the shapes the LM path gives it.
    q and k are drawn at a scale that gives the scores a spread like a
    trained model's (llama3, danube) or that drives them into gemma2's
    soft-cap, and the check proves that the window and the cap each move
    the output past the tolerance.  danube's shape is held against the
    plain version run in 1,024-row chunks (whole, it would materialise
    8.6 GB of logits several times over).  whisper-medium's encoder
    (1,500 x 1,500) and cross-attention (448 x 1,500) run non-causal at
    dh 64.  SDPA is the library yardstick where it computes the same
    function: causal or not, alone, or with a window as a dense mask (no
    call takes the soft-cap).  At llama3's bf16 shape the
    plain version with bf16 probabilities shows what the kernel's rounding
    of P costs.  Each float32 case prints the first CUDA-core kernel's time
    beside the register-blocked kernel's.  Returns the llama3-8b bf16
    case's numbers for the kernels line."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    sdpa = torch.nn.functional.scaled_dot_product_attention
    gemma2 = dict(window=4096, logit_cap=50.0)
    danube = dict(window=4096)
    whisper = dict(causal=False)
    cases = [
        # label, (B, H, Kv, Sq, Skv, dh), dtype, options, std of q and k
        # (scores: std**2 after the dh**-0.5 scale), rows per plain-version chunk
        ("llama3-8b prefill bf16", (4, 32, 8, 2048, 2048, 128), torch.bfloat16, {}, 1.0, None),
        ("llama3-8b prefill f32", (4, 32, 8, 2048, 2048, 128), torch.float32, {}, 1.0, None),
        ("gemma2-9b prefill bf16", (1, 16, 8, 8192, 8192, 256), torch.bfloat16, gemma2, 5.0,
         None),
        ("gemma2-9b prefill f32", (1, 16, 8, 8192, 8192, 256), torch.float32, gemma2, 5.0, None),
        ("h2o-danube-1.8b prefill bf16", (1, 32, 8, 8192, 8192, 80), torch.bfloat16, danube, 1.0,
         1024),
        ("h2o-danube-1.8b prefill f32", (1, 32, 8, 8192, 8192, 80), torch.float32, danube, 1.0,
         1024),
        # GQA 8:1, the widest query-head group on a served path
        ("qwen3-moe-30b-a3b prefill bf16", (2, 32, 4, 2048, 2048, 128), torch.bfloat16, {}, 1.0,
         None),
        # whisper-medium's encoder self-attention (non-causal, MHA at dh 64,
        # 1,500 frames: no multiple of a KV tile) and its decoder's
        # cross-attention (448 rows against the 1,500 frames, non-causal)
        ("whisper-medium encoder bf16", (8, 16, 16, 1500, 1500, 64), torch.bfloat16, whisper, 1.0,
         None),
        ("whisper-medium encoder f32", (8, 16, 16, 1500, 1500, 64), torch.float32, whisper, 1.0,
         None),
        ("whisper-medium cross bf16", (8, 16, 16, 448, 1500, 64), torch.bfloat16, whisper, 1.0,
         None),
        ("whisper-medium cross f32", (8, 16, 16, 448, 1500, 64), torch.float32, whisper, 1.0,
         None),
    ]
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for label, (B, H, Kv, Sq, Skv, dh), dtype, options, std, chunk in cases:
        atol, rtol = FLASH_TOL[dtype]

        def normal(shape, scale):
            return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

        def plain():
            if chunk:
                return chunked_ref(q, k, v, options, chunk)
            return attention_ref(q, k, v, **options)

        q, k = normal((B, H, Sq, dh), std), normal((B, Kv, Skv, dh), std)
        v = normal((B, Kv, Skv, dh), 0.5)
        causal = options.get("causal", True)
        # SDPA has no soft-cap; a window it takes as a dense (S, S) mask,
        # built here, outside the timed call
        library = None
        if options.get("window") and not options.get("logit_cap"):
            pos = torch.arange(Sq, device="cuda")
            mask = (pos[None] <= pos[:, None]) & (pos[None] > pos[:, None] - options["window"])
            library = lambda: sdpa(q, k, v, attn_mask=mask, enable_gqa=True)
        elif not options.get("logit_cap"):
            library = lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=True)
        got = flash_attention(q, k, v, **options)
        sync()
        want = plain()
        sync()
        max_abs = float((got.float() - want.float()).abs().max())
        used = tolerance_used(got, want, atol, rtol)
        library_err = None
        if library is not None:
            library_err = float((library().float() - want.float()).abs().max())
        p_rounding = {}
        if dtype == torch.bfloat16 and not options:
            # what rounding P to bf16 alone moves the plain version by, and
            # how far the kernel lies from the plain version that does so
            rounded = plain_bf16_probabilities(q, k, v)
            p_rounding = dict(
                max_abs_err=float((rounded.float() - want.float()).abs().max()),
                tolerance_used=tolerance_used(rounded, want, atol, rtol),
                kernel_max_abs_err=float((got.float() - rounded.float()).abs().max()),
            )
            del rounded
        del want
        check(bool(torch.isfinite(got).all()), f"{label}: K1 output is not finite")
        check(used <= 1.0, f"{label}: K1 disagrees with the plain version "
                           f"(max abs {max_abs}, atol {atol}, rtol {rtol})")
        # a kernel that ignored an option would fail the check above: on
        # the last 512 rows, which the window reaches, the plain version
        # without that option (causal=False dropped: causal) lies outside
        # the tolerance
        tail = q[:, :, -512:]
        want_tail = attention_ref(tail, k, v, **options)
        moved = {}
        for name in options:
            without = attention_ref(tail, k, v, **{o: x for o, x in options.items() if o != name})
            moved[name] = float((without.float() - want_tail.float()).abs().max())
            check(not within(without, want_tail, atol, rtol),
                  f"{label}: dropping {name} moves the output by {moved[name]}, within tolerance")
        del tail, want_tail

        kernel_ms = cuda_ms(lambda: flash_attention(q, k, v, **options), 5)
        plain_ms = cuda_ms(plain, 1)
        library_ms = None if library is None else cuda_ms(library, 10)
        ops, bytes_ms, ops_ms = flash_work(q, k, causal, options.get("window", 0))
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        torch.cuda.empty_cache()
        results[label] = dict(
            max_abs_err=max_abs, ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=library_ms,
        )
        first_ms = CUDA_CORE_FWD_MS.get(label)
        emit(
            "flash_attention",
            case=label,
            shape=dict(B=B, H=H, Kv=Kv, Sq=Sq, Skv=Skv, dh=dh),
            dtype=str(dtype).removeprefix("torch."),
            options=options,
            qk_std=std,
            atol=atol,
            rtol=rtol,
            plain_rows_per_chunk=chunk,
            max_abs_err=max_abs,
            tolerance_used=used,
            bf16_probabilities=p_rounding or None,
            option_moves_output_by=moved,
            kernel_ms=kernel_ms,
            plain_ms=plain_ms,
            library_ms=library_ms,
            library_max_abs_err=library_err,
            bound_ms=bound_ms,
            bound_by=bound_by,
            bytes_bound_ms=bytes_ms,
            ops_bound_ms=ops_ms,
            kernel_tflops=ops / kernel_ms / 1e9,
            share_of_bound=bound_ms / kernel_ms,
            route="wgmma+tma" if dtype == torch.bfloat16 else "cuda cores",
            cuda_core_kernel_ms=first_ms,
            speedup_vs_cuda_core_kernel=None if first_ms is None else first_ms / kernel_ms,
        )
    return results["llama3-8b prefill bf16"]


# K1's backward against its plain backward: each gradient within this share
# of its largest magnitude (float32 products in both; bf16 gradients are
# rounded once to bf16, 2^-8 relative, and recomputed from bf16 q, k, v;
# the bf16 kernel also rounds P and dS to bf16, 2^-9 relative, for its
# tensor-core products)
FLASH_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# K1 backward's time at each case on the first CUDA-core kernel, which
# computed bf16 too before the tensor-core kernel took that dtype and
# float32 until the register-blocked kernel replaced it (PERF.md §6, on an
# NVIDIA H100 80GB HBM3 at 700.00 W: chip_smoke for the bf16 cases and
# llama3's float32 one; for danube long and gemma2 in float32 the mean of
# two turns of tools/kernel_ab.py, commit eb47592, against the tree before
# the register-blocked kernel)
CUDA_CORE_BWD_MS = {
    "llama3-8b bf16": 40.641,
    "llama3-8b f32": 40.608,
    "h2o-danube-1.8b train bf16": 13.412,
    "h2o-danube-1.8b long bf16": 62.622,
    "h2o-danube-1.8b long f32": 59.564,
    "gemma2-9b bf16": 287.72,
    "gemma2-9b f32": 256.733,
    "qwen3-moe-30b-a3b bf16": 24.701,
}


def phase_flash_attention_backward() -> dict:
    """K1's backward kernel against its plain backward (``attention_bwd_ref``,
    chunked over rows where the whole score matrix would not fit) at the
    shapes the LM path gives it: llama3-8b's prefill shape in bf16 and
    float32, h2o-danube-1.8b's training micro-batch (B=2 x 2,048, dh 80; its
    4,096-token window then acts as causal) and a long danube row (B=1 x
    8,192, where the window acts), gemma2-9b's (dh 256, window 4,096,
    soft-cap 50, scores driven into the cap), qwen3-moe-30b-a3b's (GQA
    8:1) and whisper-medium's cross-attention (448 rows against 1,500
    frames, non-causal, dh 64; bf16 and float32).  Two calls must give
    equal bits.  Each option that acts (window, soft-cap, causal=False)
    must move the plain gradient past the tolerance when dropped,
    and so must GQA: the dk and dv of each group's first q-head alone, what
    a backward that did not sum the group would give.  The time stands
    beside 2.5 times the forward's operations bound (the backward's five
    products, two of them recomputed, against the forward's two), the
    plain backward's and SDPA's backward where SDPA computes the same
    function (no soft-cap; a window as a dense mask).  Returns the danube
    training case's numbers for the kernels line."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention, flash_attention_bwd
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

    sdpa = torch.nn.functional.scaled_dot_product_attention
    danube = dict(window=4096)
    gemma2 = dict(window=4096, logit_cap=50.0)
    cases = [
        # label, (B, H, Kv, S, dh), dtype, options, std of q and k, plain rows a chunk
        ("llama3-8b bf16", (4, 32, 8, 2048, 128), torch.bfloat16, {}, 1.0, None),
        ("llama3-8b f32", (4, 32, 8, 2048, 128), torch.float32, {}, 1.0, None),
        ("h2o-danube-1.8b train bf16", (2, 32, 8, 2048, 80), torch.bfloat16, danube, 1.0, None),
        ("h2o-danube-1.8b long bf16", (1, 32, 8, 8192, 80), torch.bfloat16, danube, 1.0, 1024),
        ("h2o-danube-1.8b long f32", (1, 32, 8, 8192, 80), torch.float32, danube, 1.0, 1024),
        ("gemma2-9b bf16", (1, 16, 8, 8192, 256), torch.bfloat16, gemma2, 5.0, 1024),
        ("gemma2-9b f32", (1, 16, 8, 8192, 256), torch.float32, gemma2, 5.0, 1024),
        ("qwen3-moe-30b-a3b bf16", (2, 32, 4, 2048, 128), torch.bfloat16, {}, 1.0, None),
        # whisper-medium's cross-attention: 448 rows against 1,500 frames
        ("whisper-medium cross bf16", (8, 16, 16, (448, 1500), 64), torch.bfloat16,
         dict(causal=False), 1.0, None),
        ("whisper-medium cross f32", (8, 16, 16, (448, 1500), 64), torch.float32,
         dict(causal=False), 1.0, None),
    ]
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for label, (B, H, Kv, S, dh), dtype, options, std, rows in cases:
        tol = FLASH_BWD_TOL[dtype]
        Sq, Skv = S if isinstance(S, tuple) else (S, S)
        causal = options.get("causal", True)

        def normal(shape, scale):
            return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

        q, k = normal((B, H, Sq, dh), std), normal((B, Kv, Skv, dh), std)
        v, dout = normal((B, Kv, Skv, dh), 0.5), normal((B, H, Sq, dh), 1.0)
        lse = torch.empty((B, H, Sq), device="cuda")
        out = flash_attention(q, k, v, lse=lse, **options)

        def kernel():
            return flash_attention_bwd(q, k, v, out, dout, lse, **options)

        def plain(opts=options):
            return attention_bwd_ref(q, k, v, dout, rows=rows, **opts)

        flash_attention_bwd.launches = 0
        got, again = kernel(), kernel()
        sync()
        launches = flash_attention_bwd.launches
        bit_equal = all(torch.equal(a, b) for a, b in zip(got, again))
        del again
        want = plain()
        errs = {n: rel_gap(g, w) for n, g, w in zip(("dq", "dk", "dv"), got, want)}
        max_abs = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
        finite = all(bool(torch.isfinite(g.float()).all()) for g in got)
        moved = {}
        for name in options:
            if name == "window" and options[name] >= Skv:
                continue  # the window reaches past the sequence: no row loses a key
            without = plain({o: x for o, x in options.items() if o != name})
            moved[name] = max(rel_gap(a, b) for a, b in zip(without, want))
            del without
        if Kv < H:
            G = H // Kv
            _, dk1, dv1 = attention_bwd_ref(q[:, ::G], k, v, dout[:, ::G], rows=rows, **options)
            moved["gqa"] = max(rel_gap(dk1, want[1]), rel_gap(dv1, want[2]))
            del dk1, dv1
        del want, got
        check(launches == 2, f"{label}: two backward calls counted {launches} launches")
        check(finite, f"{label}: K1 backward gradients are not finite")
        check(all(e <= tol for e in errs.values()),
              f"{label}: K1 backward disagrees with the plain backward: {errs}, tolerance {tol}")
        check(bit_equal, f"{label}: two K1 backward calls differ")
        for name, gap in moved.items():
            check(gap > tol, f"{label}: dropping {name} moves the plain gradient by {gap}, "
                             f"within the tolerance {tol}")

        kernel_ms = cuda_ms(kernel, 3)
        plain_ms = cuda_ms(plain, 1)
        library_ms = None
        if not options.get("logit_cap"):
            qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
            window = options.get("window", 0)
            if window and window < Skv:
                pos = torch.arange(Skv, device="cuda")
                mask = (pos[None] <= pos[:, None]) & (pos[None] > pos[:, None] - window)
                o = sdpa(qs, ks, vs, attn_mask=mask, enable_gqa=True)
            else:
                o = sdpa(qs, ks, vs, is_causal=causal, enable_gqa=True)
            library_ms = cuda_ms(
                lambda: torch.autograd.grad(o, (qs, ks, vs), dout, retain_graph=True), 3)
            del o, qs, ks, vs
        fwd_ops, _, fwd_ops_ms = flash_work(q, k, causal, options.get("window", 0))
        # q, o, dO read and dq written; k, v read and dk, dv written; the lse
        moved_bytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() + 4 * lse.numel()
        ops_ms = 2.5 * fwd_ops_ms
        bytes_ms = moved_bytes / HBM_BYTES_PER_S * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
        results[label] = dict(max_abs_err=max_abs, ms=kernel_ms, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
        first_ms = CUDA_CORE_BWD_MS.get(label)
        emit(
            "flash_attention_backward",
            case=label,
            shape=dict(B=B, H=H, Kv=Kv, Sq=Sq, Skv=Skv, dh=dh),
            dtype=str(dtype).removeprefix("torch."),
            options=options,
            qk_std=std,
            tolerance=tol,
            plain_rows_per_chunk=rows,
            rel_err_to_scale=errs,
            max_abs_err=max_abs,
            bit_equal=bit_equal,
            dropping_moves_gradient_by=moved,
            kernels_per_call=3,
            route="wgmma+tma" if dtype == torch.bfloat16 else "cuda cores",
            kernel_ms=kernel_ms,
            cuda_core_kernel_ms=first_ms,
            speedup_vs_cuda_core_kernel=None if first_ms is None else first_ms / kernel_ms,
            plain_ms=plain_ms,
            library_ms=library_ms,
            library="sdpa backward" if library_ms is not None else None,
            bound_ms=bound_ms,
            bound_by=bound_by,
            ops_bound_ms=ops_ms,
            bytes_bound_ms=bytes_ms,
            kernel_tflops=2.5 * fwd_ops / kernel_ms / 1e9,
            share_of_bound=bound_ms / kernel_ms,
        )
        del q, k, v, dout, out, lse
        torch.cuda.empty_cache()
    return results["h2o-danube-1.8b train bf16"]


def scan_bwd_bytes(B: int, S: int, di: int, n: int) -> int:
    """The bytes K2's backward must move as a function: dt, x and dy read
    and ddt and dx written (B, S, di); B and C read and dB and dC written
    (B, S, N); A read and dA written (di, N); all float32
    (``kernel.scan_bwd_work``)."""
    return int(scan_bwd_work(B, S, di, n)[1])


def scan_bwd_design_bytes(B: int, S: int, di: int, n: int) -> int:
    """The bytes this kernel's design adds to :func:`scan_bwd_bytes`: the
    forward's saved chunk states read, and the per-row dA and per-slice
    dB and dC partials written by the kernel and read back by the
    wrapper's sums."""
    from repro_torch.kernels.mamba_scan.kernel import bwd_layout

    layout = bwd_layout(di, n)
    chunks = -(-S // layout["time_chunk"])
    return 4 * (B * chunks * di * n + 2 * (B * di * n + 2 * layout["slices"] * B * S * n))


def phase_selective_scan_backward() -> dict:
    """K2's backward kernel against its plain backward (the reverse
    recurrence, ``selective_scan_bwd_ref``) at each of ``SCAN_SHAPES``, in
    float32: every gradient within rel 1e-4 of its scale, two calls equal
    bit for bit.  Its time (the wrapper's call: the kernel and the
    partials' sums) stands beside its bytes bound (the function's inputs
    and outputs, :func:`scan_bwd_bytes`), its operations bound and the exp
    pipe's floor (one exponential per (b, t, d, n)); the traffic its
    design adds (saved states, partials) and its residency (blocks an SM,
    registers, shared memory) are printed beside them.  Returns the first
    shape's numbers for the kernels line."""
    from repro_torch.kernels.mamba_scan.kernel import (
        bwd_layout,
        bwd_occupancy,
        selective_scan,
        selective_scan_bwd,
    )
    from repro_torch.kernels.mamba_scan.ref import selective_scan_bwd_ref

    sm_clock_hz = float(nvidia_smi("clocks.max.sm", "nounits")) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    row = None
    for label, (B, S, di, n) in SCAN_SHAPES:
        dt, a, b, c, x = scan_inputs(B, S, di, n, 0, "cuda")
        dy = scan_inputs(B, S, di, n, 1, "cuda")[4]
        _, states = selective_scan(dt, a, b, c, x, save_states=True)
        selective_scan_bwd.launches = 0
        got = selective_scan_bwd(dt, a, b, c, x, dy, states)
        again = selective_scan_bwd(dt, a, b, c, x, dy, states)
        sync()
        launches = selective_scan_bwd.launches / 2
        bit_equal = all(torch.equal(p, q) for p, q in zip(got, again))
        del again
        want = selective_scan_bwd_ref(dt, a, b, c, x, dy)
        names = ("ddt", "da", "db", "dc", "dx")
        errs = {k: rel_gap(g, w) for k, g, w in zip(names, got, want)}
        max_abs = max(float((g - w).abs().max()) for g, w in zip(got, want))
        del got, want
        check(launches == 1, f"{label}: the scan backward launched {launches} kernels a call")
        check(all(e <= 1e-4 for e in errs.values()),
              f"{label}: K2 backward disagrees with the plain backward: {errs}")
        check(bit_equal, f"{label}: two K2 backward calls differ")

        kernel_ms = cuda_ms(lambda: selective_scan_bwd(dt, a, b, c, x, dy, states), 10)
        plain_ms = cuda_ms(lambda: selective_scan_bwd_ref(dt, a, b, c, x, dy), 1)
        layout = bwd_layout(di, n)
        elems = B * S * di
        moved_bytes = scan_bwd_bytes(B, S, di, n)
        design_bytes = scan_bwd_design_bytes(B, S, di, n)
        # per (b, t, d, n): 4 in the recomputed forward step, 22 in the
        # reverse step (the function's arithmetic, as PR 18 counted it)
        ops = scan_bwd_work(B, S, di, n)[0]
        bytes_ms = moved_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_OPS_PER_S * 1e3
        exp_ms = elems * n / (sms * EX2_PER_SM_CLOCK * sm_clock_hz) * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        row = row or {
            "name": "selective_scan_bwd",
            "route": "cuda",
            "source": "src/repro_torch/kernels/mamba_scan/csrc/selective_scan_bwd.cu",
            "replaces": "src/repro/kernels/mamba_scan/kernel.py:61",
            "gradient_of": "src/repro/models/mamba.py:109 (_linear_scan's custom VJP)",
            "max_abs_err": max_abs,
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,  # no single PyTorch call computes the scan's gradient
        }
        emit(
            "selective_scan_backward",
            case=label,
            shape=[B, S, di, n],
            layout=layout,
            rel_err_to_scale=errs,
            max_abs_err=max_abs,
            bit_equal=bit_equal,
            launches_per_call=launches,
            kernel_ms=kernel_ms,
            plain_ms=plain_ms,
            bound_ms=bound_ms,
            bytes_bound_ms=bytes_ms,
            ops_bound_ms=ops_ms,
            exp_floor_ms=exp_ms,
            design_bytes=design_bytes,
            design_bytes_ms=design_bytes / HBM_BYTES_PER_S * 1e3,
            occupancy=bwd_occupancy(n),
            kernel_gb_per_s=moved_bytes / kernel_ms / 1e6,
            share_of_bound=bound_ms / kernel_ms,
        )
        del dt, a, b, c, x, dy, states
        torch.cuda.empty_cache()
    return row


MIXER_SHAPES = (
    # label, (B, S, d_inner): falcon-mamba-7b's width at the prefill cell's
    # shortest and longest prompts, served in bf16
    ("falcon-mamba-7b B=1 x 1,024", (1, 1024, 8192)),
    ("falcon-mamba-7b B=1 x 8,192", (1, 8192, 8192)),
)
MIXER_PASSES = ("conv_silu", "dt_softplus", "mixer_gate")


def mixer_pass_bytes(B: int, S: int, di: int, elem: int) -> dict[str, int]:
    """Each mixer pass's inputs read once and outputs written once, at
    ``elem`` bytes an element of the compute dtype: the conv reads xin,
    its 4 taps and bias and writes x_conv and float32 xf; the dt pass
    reads dt_raw and the float32 bias and writes float32 dt; the gate
    reads float32 y, x_conv, z and float32 D and writes its output."""
    n = B * S * di
    return {
        "conv_silu": n * (2 * elem + 4) + 5 * di * elem,
        "dt_softplus": n * (elem + 4) + 4 * di,
        "mixer_gate": n * (3 * elem + 4) + 4 * di,
    }


def ulps_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest ``|got - want|`` over the spacing of got's dtype at
    ``want`` (the smallest normal's spacing at zero)."""
    fi = torch.finfo(got.dtype)
    got, want = got.double(), want.double()
    spacing = fi.eps * torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(fi.tiny))))
    return float(((got - want).abs() / spacing).max())


def phase_mamba_mixer() -> list[dict]:
    """The mixer's three prefill passes around K2 at each of
    ``MIXER_SHAPES`` in bf16, with in_proj's output as the model lays it
    out (x and z halves read in place): each against its plain version run
    on the card (the chain the model ran before them) within one bf16 ulp
    at every element, xf the exact widening of x_conv, one launch a call.
    Each time stands beside its bytes bound (:func:`mixer_pass_bytes`)
    and the plain version's.  Returns the rows of the kernels line (the
    longest shape's numbers; ``launches`` filled by the falcon prefill
    phase)."""
    from repro_torch.kernels.mamba_mixer import kernel as mk
    from repro_torch.kernels.mamba_mixer.ref import (
        conv_silu_ref,
        dt_softplus_ref,
        mixer_gate_ref,
    )

    dtype = torch.bfloat16
    rows = {}
    for label, (B, S, di) in MIXER_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(S)

        def rnd(shape, scale=1.0, shift=0.0):
            return torch.randn(shape, generator=gen, device="cuda") * scale + shift

        xz = rnd((B, S, 2 * di)).to(dtype)
        xin, z = xz.chunk(2, dim=-1)
        w, b = rnd((4, di), 0.5).to(dtype), rnd((di,), 0.1).to(dtype)
        dt_raw, dt_bias = rnd((B, S, di), 2.0).to(dtype), rnd((di,), 1.0, -4.6)
        y, D = rnd((B, S, di)), rnd((di,), 0.3, 1.0)
        x_conv, xf = mk.conv_silu(xin, w, b)
        calls = {
            "conv_silu": (lambda: mk.conv_silu(xin, w, b), lambda: conv_silu_ref(xin, w, b)),
            "dt_softplus": (lambda: mk.dt_softplus(dt_raw, dt_bias),
                            lambda: dt_softplus_ref(dt_raw, dt_bias)),
            "mixer_gate": (lambda: mk.mixer_gate(y, x_conv, D, z),
                           lambda: mixer_gate_ref(y, xf, D, z)),
        }
        moved = mixer_pass_bytes(B, S, di, 2)
        for name, (kernel_fn, plain_fn) in calls.items():
            counter = getattr(mk, name)
            counter.launches = 0
            got = kernel_fn()
            sync()
            launches = counter.launches
            want = plain_fn()
            got, want = (got[0], want[0]) if name == "conv_silu" else (got, want)
            ulps = ulps_gap(got, want.to(got.dtype)) if name != "dt_softplus" else \
                ulps_gap(got.to(dtype), want.to(dtype))
            equal_share = float((got == want).float().mean())
            check(launches == 1, f"{label}: {name} launched {launches} kernels a call")
            check(ulps <= 1.0, f"{label}: {name} lies {ulps} bf16 ulps from its plain version")
            del got, want
            kernel_ms = cuda_ms(kernel_fn, 50)
            plain_ms = cuda_ms(plain_fn, 10)
            bound_ms = moved[name] / HBM_BYTES_PER_S * 1e3
            emit("mamba_mixer", case=label, kernel=name, shape=[B, S, di], dtype="bfloat16",
                 max_ulps=ulps, bit_equal_share=equal_share, launches_per_call=launches,
                 kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
                 bytes=moved[name], kernel_gb_per_s=moved[name] / kernel_ms / 1e6,
                 share_of_bound=bound_ms / kernel_ms)
            rows[name] = {
                "name": name,
                "route": "cuda",
                "source": "src/repro_torch/kernels/mamba_mixer/csrc/mamba_mixer.cu",
                "replaces": None,  # the reference leaves the chain to XLA
                "shape": [B, S, di],
                "max_ulps": ulps,
                "ms": kernel_ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": "bytes",
                "library_ms": None,
            }
        check(torch.equal(xf, x_conv.float()), f"{label}: xf is not x_conv widened")
        del xz, xin, z, w, b, dt_raw, dt_bias, y, D, x_conv, xf
        torch.cuda.empty_cache()
    return [rows[name] for name in MIXER_PASSES]


def phase_quickstart() -> None:
    from repro_torch.core.bwsig import fit_signature, predict_counters
    from repro_torch.core.numa import E5_2699_V3, mixed_workload, profile_pair, simulate

    wl = mixed_workload(
        "worked-example", n_threads=16, read_mix=(0.2, 0.35, 0.3),
        static_socket=1, device="cuda",
    )
    sym, asym = profile_pair(E5_2699_V3, wl)
    sig = fit_signature(sym, asym)
    target = torch.tensor([11, 5], dtype=torch.int32, device="cuda")
    measured = simulate(E5_2699_V3, wl, target)
    demand = measured.read_flows.sum(dim=1)
    pred_local, pred_remote = predict_counters(sig.read, demand, target)
    total = float((measured.sample.local_read + measured.sample.remote_read).sum())
    err = float(
        (pred_local - measured.sample.local_read).abs().sum()
        + (pred_remote - measured.sample.remote_read).abs().sum()
    ) / total
    emit(
        "quickstart",
        static_fraction=float(sig.read.static_fraction),
        static_socket=int(sig.read.static_socket),
        local_fraction=float(sig.read.local_fraction),
        per_thread_fraction=float(sig.read.per_thread_fraction),
        error_pct=100 * err,
    )
    check(err < 0.05, f"quickstart prediction error {100 * err:.3f}% >= 5%")


def phase_sweeps() -> None:
    from repro_torch.core.numa import machine as machines
    from repro_torch.core.numa import simulate_grouped_batch, simulate_reference
    from repro_torch.core.numa import thread_class_starts
    from repro_torch.core.numa.benchmarks import benchmark_workload
    from repro_torch.core.numa.evaluate import evaluate_batch, placement_array
    from repro_torch.core.numa.simulator import default_generator

    for label, preset, n_threads, max_p, committed in SWEEPS:
        m = getattr(machines, preset)
        placements = placement_array(m, n_threads, max_placements=max_p)
        wls = [benchmark_workload(b, n_threads, device="cuda") for b in SWEEP_BENCHMARKS]

        def run():
            batch = evaluate_batch(
                m, wls, placements, noise_std=0.02,
                generator=default_generator("cuda", 0),
            )
            sync()
            return batch

        t0 = time.perf_counter()
        run()
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        batch = run()
        steady_s = time.perf_counter() - t0
        errors = batch.errors_combined.cpu().numpy().reshape(-1) * 100.0
        check(bool(np.isfinite(errors).all()), f"{label}: non-finite errors")
        median = float(np.median(errors))

        # noise-free: the card against the same port code on the CPU
        # (rel 1e-4: summation order differs between the two)
        clean = evaluate_batch(m, wls, placements)
        wls_cpu = [benchmark_workload(b, n_threads, device="cpu") for b in SWEEP_BENCHMARKS]
        clean_cpu = evaluate_batch(m, wls_cpu, placements)
        bw_rel = float(
            ((clean.total_bw.cpu() - clean_cpu.total_bw).abs() / clean_cpu.total_bw).max()
        )
        err_abs = float((clean.errors_combined.cpu() - clean_cpu.errors_combined).abs().max())

        # the grouped batch path against the per-thread reference solver on
        # 64 placements of the two-class Page-rank workload (<= 1e-5)
        pr = benchmark_workload("Page rank", n_threads, device="cuda")
        sub = placements[:: max(1, len(placements) // 64)][:64]
        grouped = simulate_grouped_batch(
            m, pr, sub, thread_classes=thread_class_starts(pr)
        )
        ref_flows = torch.stack([simulate_reference(m, pr, p).read_flows for p in sub])
        ref_rel = float(
            ((grouped.read_flows - ref_flows).abs()
             / ref_flows.abs().clamp(min=1.0)).max()
        )
        profile = device_profile(run)
        emit(
            "sweep",
            sweep=label,
            machine=m.name,
            n_threads=n_threads,
            placements=len(placements),
            benchmarks=len(wls),
            median_error_pct=median,
            committed_median_error_pct=committed,
            p95_error_pct=float(np.percentile(errors, 95)),
            first_call_s=first_s,
            steady_s=steady_s,
            placements_per_s=len(placements) * len(wls) / steady_s,
            noise_free_total_bw_max_rel_vs_cpu=bw_rel,
            noise_free_errors_max_abs_vs_cpu=err_abs,
            grouped_vs_reference_max_rel=ref_rel,
            profile=profile,
        )
        check(abs(median - committed) <= MEDIAN_TOL_PP,
              f"{label}: median {median:.4f}% vs committed {committed}%")
        check(bw_rel <= 1e-4, f"{label}: card vs cpu total_bw rel {bw_rel}")
        check(err_abs <= 1e-5, f"{label}: card vs cpu errors abs {err_abs}")
        check(ref_rel <= 1e-5, f"{label}: grouped vs reference rel {ref_rel}")


def phase_service() -> None:
    from repro_torch.core.numa import E7_4830_V3, simulate
    from repro_torch.launch.advisor_serve import drive_threads, mixed_stream, signature_pool
    from repro_torch.serve import AdvisorService
    from repro_torch.serve.service import _advise_batch

    n_threads = 24
    pool = signature_pool(32, seed=0)
    fresh = signature_pool(64, seed=7)
    tiers = {}
    with AdvisorService(device="cuda", max_batch=8) as svc:
        handle = svc.register(E7_4830_V3)
        t0 = time.perf_counter()
        svc.warmup(handle, n_threads)
        warm_s = time.perf_counter() - t0
        svc.metrics.reset(keep_traces=True)

        queries = [(handle, sig, n_threads) for sig in pool]
        batch_answers, wall = drive_threads(svc, queries, n_workers=8)
        snap = svc.metrics.snapshot()
        check(snap["tier_counts"]["batch"] == len(pool),
              f"batch tier answered {snap['tier_counts']['batch']} of {len(pool)}")
        tiers["batch"] = dict(queries=len(pool), qps=len(pool) / wall,
                              p50_ms=snap.get("batch_p50_ms"),
                              p99_ms=snap.get("batch_p99_ms"),
                              batch_size_hist=snap["batch_size_hist"])

        svc.metrics.reset(keep_traces=True)
        hits, wall = drive_threads(svc, queries * 10, n_workers=4)
        snap = svc.metrics.snapshot()
        check(snap["tier_counts"]["cache"] == 10 * len(pool), "cache tier missed")
        check(all(h is a for h, a in zip(hits, batch_answers * 10)),
              "a cache hit returned another object")
        tiers["cache"] = dict(queries=len(hits), qps=len(hits) / wall,
                              p50_ms=snap.get("cache_p50_ms"),
                              p99_ms=snap.get("cache_p99_ms"))

        svc.metrics.reset(keep_traces=True)
        stream = mixed_stream(pool, fresh, 256, sweep_target=(handle, n_threads))
        mixed, wall = drive_threads(svc, stream, n_workers=8)
        snap = svc.metrics.snapshot()
        check(snap["retraces"] == 0, f"{snap['retraces']} new batch shapes after warmup")
        tiers["mixed"] = dict(queries=len(stream), qps=len(stream) / wall,
                              p50_ms=snap.get("p50_ms"), p99_ms=snap.get("p99_ms"),
                              tier_counts=snap["tier_counts"])

        # one full micro-batch of the group, alone, under the profiler
        table = svc._table_for(E7_4830_V3, handle, n_threads)
        batch_wls = svc._stacked_workloads(fresh[:8], n_threads)
        batch_profile = device_profile(
            lambda: _advise_batch(E7_4830_V3, batch_wls, table, (0,))
        )

    # serial on the card: one query at a time against a fresh service
    with AdvisorService(device="cuda", max_batch=8) as serial_svc:
        serial = [serial_svc.query(E7_4830_V3, sig, n_threads) for sig in pool]
    check(serial == batch_answers, "concurrent answers differ from serial answers")

    # the same queries through the port on the CPU
    with AdvisorService(device="cpu", max_batch=8) as cpu_svc:
        cpu = [cpu_svc.query(E7_4830_V3, sig, n_threads) for sig in pool]
    obj_rel = max(abs(g.objective - c.objective) / abs(c.objective)
                  for g, c in zip(batch_answers, cpu))
    same_placement = sum(g.placement == c.placement for g, c in zip(batch_answers, cpu))
    # a card answer that differs from the CPU's must be a tie: its
    # placement scores the CPU's best objective when the CPU simulates it
    tie_rel = 0.0
    for sig, g, c in zip(pool, batch_answers, cpu):
        if g.placement != c.placement:
            placement = torch.tensor(g.placement, dtype=torch.int32)
            obj = float(simulate(E7_4830_V3, sig.workload(n_threads, device="cpu"),
                                 placement).sample.instructions.sum())
            tie_rel = max(tie_rel, abs(obj - c.objective) / abs(c.objective))
    emit(
        "service",
        machine=E7_4830_V3.name,
        n_threads=n_threads,
        max_batch=8,
        warmup_s=warm_s,
        tiers=tiers,
        objective_max_rel_vs_cpu=obj_rel,
        same_placement_as_cpu=same_placement,
        other_placement_objective_max_rel_vs_cpu=tie_rel,
        answers=len(pool),
        batch_profile=batch_profile,
    )
    check(obj_rel <= 1e-4, f"service objective differs from the CPU by rel {obj_rel}")
    check(tie_rel <= 1e-4, f"a card placement is no tie of the CPU's: rel {tie_rel}")
    phase_service_search_and_schedule()


def schedule_query():
    """The phased query of the service's schedule tier: the flip workload
    as two query signatures of 5 s each."""
    from repro_torch.serve import QuerySignature

    return [(QuerySignature((0.7, 0.1, 0.0), (0.0, 0.0, 0.0), read_bpi=5.0,
                            static_socket=s), 5.0) for s in (0, 1)]


def phase_service_search_and_schedule() -> None:
    """The search and schedule tiers on the card: one snc2-8s query at 32
    threads (tier ``search``), one phased query on E5-2630 v3 (tier
    ``schedule``, then a cache hit), each against the same service on the
    CPU; then the advisor CLI's stream with 2% search queries."""
    from repro_torch.core.numa import E5_2630_V3, MigrationModel
    from repro_torch.launch.advisor_serve import search_machine, serve_stream, signature_pool
    from repro_torch.serve import AdvisorService

    m16 = search_machine()
    sig = signature_pool(1, seed=77)[0]
    model = MigrationModel(thread_move_bytes=1e6, page_move_bytes=1e6)
    answers = {}
    for device in ("cuda", "cpu"):
        with AdvisorService(device=device) as svc:
            search, search_s = timed(lambda: svc.query(m16, sig, 32, timeout=600))
            sched, sched_s = timed(lambda: svc.query_schedule(
                E5_2630_V3, schedule_query(), 8, model=model, timeout=600))
            again = svc.query_schedule(E5_2630_V3, schedule_query(), 8, model=model)
            answers[device] = (search, search_s, sched, sched_s, again is sched,
                               svc.metrics.snapshot())
    search, search_s, sched, sched_s, hit, snap = answers["cuda"]
    search_cpu, _, sched_cpu, _, _, _ = answers["cpu"]
    obj_rel = abs(search.objective - search_cpu.objective) / search_cpu.objective
    emit(
        "service_search_schedule",
        search=dict(machine=m16.name, n_threads=32, tier=search.tier,
                    placement=list(search.placement), objective=search.objective,
                    predicted_bandwidth=search.predicted_bandwidth,
                    optimal=search.optimal, wall_s=search_s,
                    objective_rel_vs_cpu=obj_rel,
                    same_placement_as_cpu=search.placement == search_cpu.placement),
        schedule=dict(machine=E5_2630_V3.name, n_threads=8, tier=sched.tier,
                      placements=[list(p) for p in sched.placements],
                      gain_pct=sched.gain_pct, cpu_gain_pct=sched_cpu.gain_pct,
                      wall_s=sched_s, second_ask_is_cache_hit=hit),
        tier_counts=snap["tier_counts"],
        latency_ms={k: v for k, v in snap.items() if k.endswith(("_p50_ms", "_p99_ms"))},
    )
    check(search.tier == "search", f"the snc2-8s query was answered by tier {search.tier}")
    check(obj_rel <= 1e-4, f"search-tier objective rel {obj_rel} vs the CPU")
    check(sched.tier == "schedule" and hit, "the phased query missed the schedule tier or cache")
    check(abs(sched.gain_pct - sched_cpu.gain_pct) <= GAIN_TOL_PP,
          f"schedule gain {sched.gain_pct} vs the CPU's {sched_cpu.gain_pct}")
    check(snap["tier_counts"]["search"] == 1 and snap["tier_counts"]["schedule"] == 1,
          f"tier counts {snap['tier_counts']}")

    # the advisor CLI's stream: 1,000 queries, 80% hits, 2% on snc2-8s
    with AdvisorService(device="cuda") as svc:
        snap = serve_stream(svc, 1000, pool=32, hit_fraction=0.8, search_fraction=0.02)
    emit("service_stream", search_fraction=0.02, **snap)
    check(snap["queries"] == 1000, f"the stream answered {snap['queries']} of 1000")
    check(snap["search_queries"] > 0, "the stream held no search-tier queries")
    check(snap["retraces"] == 0, f"{snap['retraces']} new batch shapes after warmup")


# the calibration round trip (benchmarks/calibration_roundtrip.py): blind
# 200-step fits, every link within 5%, the refit sweep's median within
# 0.25 pp of the truth's; the card's fit held to the CPU port's
CALIBRATION_PRESETS = ("E7_8860_V3", "E5_2699_V3_SNC2")
CALIBRATION_STEPS = 200
LINK_GATE = 0.05
FIT_VS_CPU_REL = 1e-3
# snc2-8s's worst link error after the JAX reference's blind 200-step fit
# (a model output: the blind fit misses the 5% gate on this machine)
SNC2_8S_REFERENCE_WORST_LINK = 0.1076
SNC2_8S_WORST_LINK_TOL = 0.01


def fit_receipt(machine, samples, device: str) -> tuple[dict, object]:
    """A blind fit of ``samples`` (on their device) with its wall time,
    losses, the worst link error against ``machine`` and the fitted
    parameters as float64 numpy."""
    from repro_torch.core.numa import calibrate as C

    tmpl = C.blind_template(machine)
    res, seconds = timed(lambda: C.fit_machine(tmpl, samples, steps=CALIBRATION_STEPS))
    params = np.concatenate([np.exp(C._host(getattr(res.params, k)).astype(np.float64).ravel())
                             for k in ("log_link_bw", "log_local_read", "log_local_write")]
                            + [[res.machine.hop_attenuation]])
    return dict(device=device, fit_s=seconds, seed_loss=res.seed_loss,
                final_loss=res.final_loss,
                max_link_error=float(C.link_relative_errors(res.machine, machine).max()),
                hop_attenuation=res.machine.hop_attenuation), (res, params)


def fit_step_profile(machine, samples) -> dict:
    """One AdamW step (forward, backward, update) of the blind fit under
    the profiler: launches, device ms, busy share."""
    from repro_torch.core.numa import calibrate as C
    from repro_torch.core.numa.topology import link_groups
    from repro_torch.optim import adamw

    tmpl = C.blind_template(machine)
    groups = link_groups(tmpl.topology)
    sweep = C._prepare_sweep(tmpl, groups, samples, C._sample_classes(samples))
    seed = C.seed_parameters(tmpl, samples, groups)
    p = {k: getattr(seed, k) for k in C._PARAM_KEYS}
    state = adamw.init(p)
    lr = adamw.cosine_schedule(0.03, 20, CALIBRATION_STEPS)(state.step)
    return sync_free_step_profile(
        lambda: C._fit_step(tmpl, groups, sweep, p, state, lr, 0.25, None))


def sync_free_step_profile(step) -> dict:
    """``step`` run once under ``torch.cuda.set_sync_debug_mode("error")``
    (a synchronising call anywhere in it would raise), then under the
    profiler: launches, device ms, busy share."""
    sync()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    profile = device_profile(step, top=5)
    profile["launches"] = profile["runtime_calls"].get("cudaLaunchKernel")
    profile["host_syncs"] = 0
    return profile


def phase_calibration() -> None:
    """The calibration round trip on the card: blind 200-step fits of
    E7-8860 v3 (157 probes) and E5-2699 v3 SNC-2 (49) from noise-free
    sweeps, the refit sweep's median, each fit held against the port on
    the CPU fitting the same samples; then snc2-8s (565 probes, 36 links)
    blind, its worst link held to the CPU port's."""
    from repro_torch.core.numa import calibrate as C
    from repro_torch.core.numa import machine as machines
    from repro_torch.core.numa.benchmarks import benchmark_workload
    from repro_torch.core.numa.evaluate import evaluate_batch, placement_array
    from repro_torch.core.numa.simulator import default_generator
    from repro_torch.launch.advisor_serve import search_machine

    for preset in (*CALIBRATION_PRESETS, None):
        m = getattr(machines, preset) if preset else search_machine()
        samples, sweep_s = timed(lambda: C.collect_sweep(m, device="cuda"))
        card, (res, card_params) = fit_receipt(m, samples, "cuda")
        cpu, (_, cpu_params) = fit_receipt(m, samples.to("cpu"), "cpu")
        params_rel = float(np.max(np.abs(card_params - cpu_params) / np.abs(cpu_params)))
        record = dict(machine=m.name, probes=samples.n_samples, n_links=m.n_links,
                      steps=CALIBRATION_STEPS, sweep_s=sweep_s, card=card, cpu=cpu,
                      params_max_rel_vs_cpu=params_rel,
                      step_profile=fit_step_profile(m, samples))
        if preset is None:
            gap = abs(card["max_link_error"] - cpu["max_link_error"])
            emit("calibration", **record, worst_link_gap_vs_cpu=gap,
                 reference_worst_link_error=SNC2_8S_REFERENCE_WORST_LINK)
            check(gap <= SNC2_8S_WORST_LINK_TOL,
                  f"snc2-8s worst link {card['max_link_error']} vs the CPU's {cpu['max_link_error']}")
            continue
        # the benchmark's sweep, on the truth and on the refit machine,
        # with one generator seed for both
        n = 2 * m.cores_per_node
        n -= n % m.n_nodes
        placements = placement_array(m, n, max_placements=64)
        wls = [benchmark_workload(b, n, device="cuda") for b in SWEEP_BENCHMARKS]
        medians = {}
        for label, spec in (("truth", m), ("fit", res.machine)):
            batch = evaluate_batch(spec, wls, placements, noise_std=0.02,
                                   generator=default_generator("cuda", 0))
            errors = batch.errors_combined.cpu().numpy().reshape(-1) * 100.0
            check(bool(np.isfinite(errors).all()), f"{m.name}: non-finite sweep errors")
            medians[label] = float(np.median(errors))
        delta = abs(medians["fit"] - medians["truth"])
        local = C.local_bw_relative_errors(res.machine, m)
        emit("calibration", **record, sweep_median_error_pct=medians,
             sweep_median_delta_pp=delta,
             max_local_read_error=float(local["read"].max()),
             max_local_write_error=float(local["write"].max()))
        check(card["max_link_error"] <= LINK_GATE,
              f"{m.name}: worst link error {card['max_link_error']} > {LINK_GATE}")
        check(delta <= MEDIAN_TOL_PP, f"{m.name}: refit sweep median moved {delta} pp")
        check(params_rel <= FIT_VS_CPU_REL,
              f"{m.name}: the card's fit differs from the CPU's by rel {params_rel}")



# the mesh-domain link fit (tests/test_device_topology.py's round trips):
# blind 200-step fits, the worst link within 5% of the truth, the card's
# fitted links within rel 1e-3 of the CPU port's fit of the same samples
MESH_FIT_STEPS = 200
MESH_NOISE_STD = 0.01
ROUTED_VS_SCALAR_REL = 1e-6


def perturbed_torus(rows=4, cols=4, base=50e9, spread=0.3, seed=3):
    """A ``rows x cols`` ICI torus whose links lie within +-30% of
    ``base``, drawn from a numpy seed."""
    from repro_torch.core.graphtop import from_fit
    from repro_torch.core.meshsig.device_topology import DeviceTopology, ici_torus2d

    t = ici_torus2d(rows, cols, base)
    rng = np.random.default_rng(seed)
    bw = base * (1 + spread * rng.uniform(-1, 1, t.graph.n_links))
    return DeviceTopology(graph=from_fit(t.graph, bw), multipath=False)


def two_class_template(truth, island_size: int):
    """``truth``'s structure with one placeholder rate for the links
    inside an island and another for the glue links, so
    ``tie_equal_bw`` fits one parameter per class."""
    from repro_torch.core.graphtop import from_fit
    from repro_torch.core.meshsig.device_topology import DeviceTopology

    placeholder = [100e9 if i // island_size == j // island_size else 1e9
                   for i, j in truth.graph.link_ends]
    return DeviceTopology(graph=from_fit(truth.graph, placeholder))


def mesh_fit_cells():
    """``(name, truth, template, ring-probe axes, fit keywords)`` of the
    two link fits: the perturbed 4 x 4 torus (32 links) blind, and two
    hosts of 8 NVLink-switched devices (64 links) with one parameter per
    link class."""
    from repro_torch.core.meshsig import calibrate as MC
    from repro_torch.core.meshsig.device_topology import ring_of_islands

    torus = perturbed_torus()
    ring = ring_of_islands(2, 8)
    return (
        ("torus4x4", torus, MC.blind_template(torus),
         ({"data": 4, "model": 4}, {"data": 2, "model": 8}), {}),
        ("ring_of_islands2x8", ring, two_class_template(ring, 8),
         ({"data": 2, "model": 8}, {"model": 8, "data": 2}), {"tie_equal_bw": True}),
    )


def mesh_fit_step_profile(template, samples, fit_kwargs) -> dict:
    """One AdamW step (loss, backward, update) of the link fit from its
    seed, as ``sync_free_step_profile`` reads it."""
    from repro_torch.core.graphtop import link_groups
    from repro_torch.core.meshsig import calibrate as MC
    from repro_torch.optim import adamw

    groups = link_groups(template.graph, **fit_kwargs)
    index = MC._link_index(groups, samples.device)
    seed = MC.seed_link_bw(template, samples)
    p = {"log_bw": torch.log(torch.as_tensor(groups.pack(seed).astype(np.float32),
                                             device=samples.device))}
    state = adamw.init(p)
    lr = adamw.cosine_schedule(0.05, 20, MESH_FIT_STEPS)(state.step)

    return sync_free_step_profile(lambda: MC._fit_step(index, samples, p, state, lr))


def h100_chip():
    """The mesh advisor's roofline constants for one H100 SXM: the
    datasheet's bf16 and HBM peaks above, NVLink at the device-topology
    module's switched-island rate."""
    from repro_torch.core.meshsig.advisor import ChipSpec
    from repro_torch.core.meshsig.device_topology import NVLINK_BW

    return ChipSpec(name="h100-sxm", peak_flops=BF16_OPS_PER_S, hbm_bw=HBM_BYTES_PER_S,
                    ici_bw=NVLINK_BW)


def synth_profile(axes, *, grad_bytes=1e9, gather_bytes=5e8, a2a_base=2e9):
    """The reference tests' synthetic profile: the gradient all-reduce and
    the parameter all-gather on data, the MoE all-to-all on model scaling
    with 1 / batch shards."""
    from repro_torch.core.meshsig.fit import MeshProfile, class_factor

    b = axes.get("data", 1) * axes.get("pod", 1)
    kd, km = axes["data"], axes["model"]
    return MeshProfile(
        axis_sizes=dict(axes),
        class_axis_bytes={
            ("interleaved", "data"): class_factor("interleaved", kd) * grad_bytes,
            ("static", "data"): class_factor("static", kd) * gather_bytes,
            ("per_shard", "model"): class_factor("per_shard", km) * a2a_base / b,
        },
        local_bytes=1e10 / b,
        flops=1e13 / b,
    )


# the ranking cells: advise_mesh_shape for H100s on a fabric (a
# device_topology function and its arguments) with the signature fitted from
# synth_profile at (8, 2) and (4, 4), and the (data, model) order, best
# first, that the port gives on the CPU (tests/test_torch_meshsig.py holds
# the port and the reference to it); candidates whose step times tie share
# a set (on two hosts (4, 4)'s data ring and (1, 16)'s model ring both
# cross the glue: 0.075 s each)
MESH_RANK_CELLS = (
    ("nvlink_island", (8,), [{(4, 2)}, {(8, 1)}, {(2, 4)}, {(1, 8)}]),
    ("ring_of_islands", (2, 8), [{(2, 8)}, {(4, 4), (1, 16)}, {(8, 2)}, {(16, 1)}]),
)
TIE_REL = 1e-9


def rank_order(rankings) -> list[set]:
    """The rankings' axis sizes, best first, with candidates whose step
    times agree within rel ``TIE_REL`` in one set: a tie has no order, and
    a last bit of the host's sums may break it either way."""
    out, last = [], None
    for r in rankings:
        axes = tuple(r.axis_sizes.values())
        if last is not None and abs(r.step_s - last) <= TIE_REL * last:
            out[-1].add(axes)
        else:
            out.append({axes})
        last = r.step_s
    return out


def mesh_rankings(fabric: str, args: tuple, routed: bool = True):
    """``advise_mesh_shape`` for the cell's H100s, routed over its fabric
    (or the scalar model with ``routed=False``)."""
    from repro_torch.core.meshsig import device_topology
    from repro_torch.core.meshsig.fit import fit_mesh_signature
    from repro_torch.launch.mesh import advise_mesh_shape

    topology = getattr(device_topology, fabric)(*args)
    sig = fit_mesh_signature(synth_profile({"data": 8, "model": 2}),
                             synth_profile({"data": 4, "model": 4}))
    return advise_mesh_shape(sig, topology.n_devices, chip=h100_chip(),
                             topology=topology if routed else None)


def phase_meshsig() -> None:
    """The mesh-domain signature on the card: each link fit of
    ``mesh_fit_cells`` from one noisy sweep (its noise drawn once from a
    seeded generator on the card) for 200 steps on the card and again on
    the host CPU, the card's links within rel 1e-3 of the CPU's and the
    worst within 5% of the truth, its seconds and one step under the
    profiler; then ``advise_mesh_shape`` for 8 H100s on one NVLink island
    and 16 on two, each order equal to the committed CPU one, and the
    island's routed times equal to the scalar model's."""
    from repro_torch.core.meshsig import calibrate as MC

    for name, truth, template, axes, fit_kwargs in mesh_fit_cells():
        charges = MC.probe_suite(truth, axis_sizes_list=axes)
        gen = torch.Generator(device="cuda").manual_seed(7)
        noise = torch.randn((charges.shape[0],), generator=gen, device="cuda")
        samples = MC.collect_samples(truth, charges, noise_std=MESH_NOISE_STD, noise=noise,
                                     device="cuda")
        fits = {}
        for device in ("cuda", "cpu"):
            res, seconds = timed(lambda: MC.fit_device_topology(
                template, samples, steps=MESH_FIT_STEPS, device=device, **fit_kwargs))
            fits[device] = res
            fits[device + "_s"] = seconds
        card, cpu = fits["cuda"], fits["cpu"]
        vs_cpu = float(np.max(np.abs(card.link_bw - cpu.link_bw) / np.abs(cpu.link_bw)))
        worst = float(MC.link_relative_errors(card.topology, truth).max())
        emit("meshsig_fit", topology=name, n_links=truth.graph.n_links,
             probes=samples.n_samples, params=card.groups.n_params, steps=MESH_FIT_STEPS,
             noise_std=MESH_NOISE_STD, fit_s=fits["cuda_s"], cpu_fit_s=fits["cpu_s"],
             seed_loss=card.seed_loss, final_loss=card.final_loss,
             cpu_final_loss=cpu.final_loss, links_max_rel_vs_cpu=vs_cpu,
             max_link_error=worst,
             cpu_max_link_error=float(MC.link_relative_errors(cpu.topology, truth).max()),
             step_profile=mesh_fit_step_profile(template, samples, fit_kwargs))
        check(bool(np.isfinite(card.loss_history).all()), f"{name}: non-finite fit losses")
        check(vs_cpu <= FIT_VS_CPU_REL,
              f"{name}: the card's links differ from the CPU's by rel {vs_cpu}")
        check(worst <= LINK_GATE, f"{name}: worst link error {worst} > {LINK_GATE}")

    for fabric, args, want in MESH_RANK_CELLS:
        name = f"{fabric}{args}"
        routed = mesh_rankings(fabric, args)
        scalar = mesh_rankings(fabric, args, routed=False)
        order = rank_order(routed)
        record = dict(cell=name, n_devices=int(np.prod(list(routed[0].axis_sizes.values()))),
                      chip=h100_chip().name,
                      best=routed[0].axis_sizes, best_bottleneck=routed[0].bottleneck,
                      rankings=[dict(axes=r.axis_sizes, step_s=r.step_s,
                                     bottleneck=r.bottleneck, compute_s=r.compute_s,
                                     memory_s=r.memory_s, collective_s=r.collective_s)
                                for r in routed],
                      order=[sorted(g) for g in order],
                      scalar_order=[sorted(g) for g in rank_order(scalar)])
        if fabric == "nvlink_island":
            by_axes = {tuple(r.axis_sizes.items()): r for r in scalar}
            gap = max(abs(r.step_s / by_axes[tuple(r.axis_sizes.items())].step_s - 1.0)
                      for r in routed)
            record["routed_vs_scalar_max_rel"] = gap
            check(gap <= ROUTED_VS_SCALAR_REL,
                  f"{name}: routed step times differ from the scalar model's by rel {gap}")
            check(order == rank_order(scalar), f"{name}: routed order {order}")
        emit("meshsig_rank", **record)
        check(order == want, f"{name}: order {order}, the CPU port's {want}")

def percentile_ms(values, q: float):
    return float(np.percentile(values, q)) * 1e3 if len(values) else None


def ladder_timer(service):
    """Time each degraded query's ladder: wraps ``service._degrade`` so the
    calling thread's ``spans.ladder_s`` holds the seconds its last query
    spent there (the rest of the query's wall time is the wait for the
    exact tiers).  Instrumentation of this script; the service is
    unchanged."""
    spans = threading.local()
    degrade = service._degrade

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return degrade(*args, **kwargs)
        finally:
            spans.ladder_s = time.perf_counter() - t0

    service._degrade = timed
    return spans


def resilience_service(fi, deadline_s: float, device: str = "cuda"):
    """The chaos record's service: E7-4830 v3 (24 threads, the batch
    tier) and snc2-8s (32 threads, the search tier), both warmed, with the
    32 hot signatures cached.  Returns ``(service, sweep_fp, search_fp,
    hot, search_sigs)``."""
    from repro_torch.core.numa import E7_4830_V3
    from repro_torch.launch.advisor_serve import search_machine, signature_pool
    from repro_torch.serve import AdvisorService

    service = AdvisorService(device=device, max_batch=8, max_wait_s=0.002, faults=fi,
                             default_deadline_s=deadline_s)
    sweep_fp = service.register(E7_4830_V3)
    search_fp = service.register(search_machine())
    hot = signature_pool(32, seed=0)
    search_sigs = signature_pool(4, seed=13)
    service.warmup(sweep_fp, 24)
    service.warmup(search_fp, 32, search_sigs[0])
    for sig in hot:
        service.query(sweep_fp, sig, 24, deadline_s=60.0)
    service.metrics.reset(keep_traces=True)
    return service, sweep_fp, search_fp, hot, search_sigs


def chaos_record(service, fi, sweep_fp, search_fp, hot, search_sigs, *,
                 n_chaos: int = 1000) -> dict:
    """benchmarks/serve_resilience.py's chaos-mixed record: ``n_chaos``
    queries (60% hot) from 4 workers under 12 slow (0.3 s) and 8 failing
    batches, 2 batcher deaths and 2 search failures, while one snc2-8s
    search query runs.  Returns the answers,
    each query's wall seconds and the seconds of it spent in the
    degradation ladder, the wall time, the faults fired and the search's
    answer; the injector is cleared on return."""
    from repro_torch.launch.advisor_serve import signature_pool

    spans = ladder_timer(service)
    fresh = signature_pool(n_chaos, seed=7)
    fi.inject_slow("batch", 0.3, times=12)
    fi.inject_error("batch", times=8)
    fi.inject_error("batcher", times=2)
    fi.inject_error("search", times=2)
    rng = np.random.default_rng(3)
    fresh_iter = iter(fresh)
    stream = [hot[int(rng.integers(len(hot)))] if rng.random() < 0.6 else next(fresh_iter)
              for _ in range(n_chaos)]
    walls = [0.0] * n_chaos
    ladders = [0.0] * n_chaos
    answers = [None] * n_chaos
    counter = iter(range(n_chaos))
    lock = threading.Lock()

    def worker() -> None:
        while True:
            with lock:
                i = next(counter, None)
            if i is None:
                return
            spans.ladder_s = 0.0
            t0 = time.perf_counter()
            answers[i] = service.query(sweep_fp, stream[i], 24)
            walls[i] = time.perf_counter() - t0
            ladders[i] = spans.ladder_s

    threads = [threading.Thread(target=worker) for _ in range(4)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    search_adv = service.query(search_fp, search_sigs[1], 32, deadline_s=30.0)
    for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "a chaos worker hung")
    fired = {site: fi.fired(site) for site in ("batch", "batcher", "search")}
    fi.clear()
    service._degrade = type(service)._degrade.__get__(service)
    return dict(answers=answers, walls=walls, ladders=ladders, wall=wall, fired=fired,
                search_adv=search_adv)


def slowest_splits(chaos: dict, n: int = 5) -> list[dict]:
    """The ``n`` slowest chaos queries: wall ms split into the wait for
    the exact tiers and the ladder, with the answer's fidelity."""
    walls, ladders, answers = chaos["walls"], chaos["ladders"], chaos["answers"]
    order = sorted(range(len(walls)), key=lambda i: -walls[i])[:n]
    return [dict(query=i, wall_ms=walls[i] * 1e3, wait_ms=(walls[i] - ladders[i]) * 1e3,
                 ladder_ms=ladders[i] * 1e3, fidelity=answers[i].fidelity) for i in order]


def phase_service_resilience() -> None:
    """The three records of benchmarks/serve_resilience.py on the card,
    then each rung of the ladder forced once."""
    from repro_torch.core.numa import E7_4830_V3
    from repro_torch.core.numa import calibrate as C
    from repro_torch.launch.advisor_serve import signature_pool
    from repro_torch.serve import FIDELITIES, AdvisorService, FaultInjector, Recalibrator
    from repro_torch.serve.service import RANK_BUDGET_S

    deadline_s, grace_s, n_chaos = 0.25, 1.0, 1000
    fi = FaultInjector()
    service, sweep_fp, search_fp, hot, search_sigs = resilience_service(fi, deadline_s)
    try:
        # -- chaos-mixed: 1,000 queries from 4 workers while faults fire
        chaos = chaos_record(service, fi, sweep_fp, search_fp, hot, search_sigs,
                             n_chaos=n_chaos)
        t_cleared = time.perf_counter()
        answers, walls, wall = chaos["answers"], chaos["walls"], chaos["wall"]
        search_adv = chaos["search_adv"]
        snap = service.metrics.snapshot()
        degraded = sum(a.fidelity != "exact" for a in answers)
        hangs = sum(w > deadline_s + grace_s for w in walls)
        emit("service_resilience", record="chaos-mixed", queries=n_chaos, workers=4,
             qps=n_chaos / wall, wall_s=wall, deadline_ms=deadline_s * 1e3,
             degraded_queries=degraded, degraded_rate=degraded / n_chaos,
             max_degraded_rate=0.5, hangs=hangs, max_wall_ms=max(walls) * 1e3,
             slowest=slowest_splits(chaos),
             fidelity_counts=snap["fidelity_counts"], tier_counts=snap["tier_counts"],
             worker_restarts=snap["worker_restarts"], faults_fired=chaos["fired"],
             search_tier=search_adv.tier, search_fidelity=search_adv.fidelity)
        check(all(a is not None and a.fidelity in FIDELITIES for a in answers),
              "a chaos answer is missing or untagged")
        check(hangs == 0, f"{hangs} queries exceeded the deadline plus {grace_s} s")
        check(degraded / n_chaos <= 0.5, f"degraded rate {degraded / n_chaos} > 0.5")
        check(snap["worker_restarts"] >= 1, "the batcher deaths were not healed")
        check(search_adv.tier == "search" and search_adv.fidelity == "exact",
              f"the search query under faults answered {search_adv.tier}/{search_adv.fidelity}")

        # -- recovery: faults cleared, fresh queries until an exact answer
        recovery_s = None
        for sig in signature_pool(64, seed=23):
            if service.query(sweep_fp, sig, 24, deadline_s=deadline_s).fidelity == "exact":
                recovery_s = time.perf_counter() - t_cleared
                break
        emit("service_resilience", record="recovery", recovery_s=recovery_s,
             max_recovery_s=10.0)
        check(recovery_s is not None and recovery_s <= 10.0, f"recovery took {recovery_s} s")

        # -- hot-swap under a sustained stream of the 32 hot signatures
        #    (and a fresh one every 8th query, so the batch tier runs too)
        truth = E7_4830_V3._replace(remote_read_bw=E7_4830_V3.remote_read_bw * 0.75,
                                    remote_write_bw=E7_4830_V3.remote_write_bw * 0.75)
        prod = service.register(E7_4830_V3, machine_id="prod-e7")
        service.warmup(prod, 24)
        for sig in hot:
            service.query(prod, sig, 24, deadline_s=60.0)
        observed: list[tuple] = []
        stop = threading.Event()
        lock = threading.Lock()
        stream_fresh = iter(signature_pool(20_000, seed=41))

        def streamer() -> None:
            i = 0
            while not stop.is_set() and i < 100_000:
                with lock:
                    sig_id, sig = ((i % len(hot), hot[i % len(hot)]) if i % 8
                                   else (None, next(stream_fresh)))
                adv = service.query(prod, sig, 24, deadline_s=30.0)
                observed.append((sig_id, adv.epoch, adv.placement, adv.objective,
                                 adv.predicted_bandwidth, adv.fidelity))
                i += 1

        streamers = [threading.Thread(target=streamer) for _ in range(2)]
        for t in streamers:
            t.start()
        service.metrics.reset(keep_traces=True)
        time.sleep(2.0)
        quiet = service.metrics.snapshot()
        probes = C.probe_suite(truth, device="cuda")
        fi.inject_counter_corruption(fraction=0.25, times=1, seed=5)
        recal = Recalibrator(service, min_samples=16)  # 120 steps, Huber 0.05
        diag = recal.ingest(prod, C.collect_sweep(truth, probes, device="cuda"))
        service.metrics.reset(keep_traces=True)
        accept = recal.recalibrate(prod)
        during = service.metrics.snapshot()
        spec1 = service.machine_spec(prod)
        guard = Recalibrator(service, min_samples=16, fit_steps=20,
                             max_error_regression_pp=-100.0)
        guard.ingest(prod, C.collect_sweep(truth, probes, device="cuda"))
        reject = guard.recalibrate(prod)
        time.sleep(0.2)  # the stream straddles the post-rollback state too
        stop.set()
        for t in streamers:
            t.join(timeout=120)
        check(not any(t.is_alive() for t in streamers), "a hot-swap streamer hung")
        final = service.metrics.snapshot()
        by_key: dict = {}
        torn = 0
        for sig_id, epoch, placement, obj, bw, _ in observed:
            if sig_id is None:
                continue
            val = (placement, obj, bw)
            torn += by_key.setdefault((sig_id, epoch), val) != val
        with AdvisorService(device="cpu") as cpu_svc:
            epoch1 = {sid: val for (sid, e), val in by_key.items() if e == 1}
            obj_rel = max((abs(val[1] - cpu_svc.query(spec1, hot[sid], 24).objective)
                           / abs(val[1]) for sid, val in epoch1.items()), default=None)
        emit("service_resilience", record="hot-swap", stream_queries=len(observed),
             epochs_observed=sorted({o[1] for o in observed}),
             swaps=final["swaps"], rollbacks=final["rollbacks"],
             nan_rejected=diag.n_rejected, probes=diag.n_total,
             swap_accepted=accept.accepted, swap_epoch=accept.epoch,
             swap_error_pct=[accept.old_error_pct, accept.new_error_pct],
             refit_s=accept.fit_seconds, refit_steps=recal.fit_steps,
             huber_delta=recal.huber_delta,
             reject_reason=reject.reason, torn_reads=torn,
             epoch1_signatures=len(epoch1), epoch1_objective_max_rel_vs_cpu=obj_rel,
             non_exact_answers=sum(o[5] != "exact" for o in observed),
             p99_ms_without_fit={t: quiet.get(f"{t}_p99_ms") for t in ("cache", "batch")},
             p99_ms_during_fit={t: during.get(f"{t}_p99_ms") for t in ("cache", "batch")},
             queries_without_fit=quiet["queries"], queries_during_fit=during["queries"],
             quiet_window_s=2.0)
        check(diag.n_rejected >= 1, "no NaN-corrupted row was rejected at ingest")
        check(accept.accepted and accept.epoch == 1, f"the refit was not swapped in: {accept.reason}")
        check(not reject.accepted and "previous spec retained" in reject.reason,
              f"the guard did not reject: {reject.reason}")
        check(final["swaps"] == 1 and final["rollbacks"] == 1,
              f"{final['swaps']} swaps, {final['rollbacks']} rollbacks")
        check(torn == 0, f"{torn} torn reads")
        check({0, 1} <= {o[1] for o in observed}, "the stream did not straddle the swap")
        check(all(o[5] == "exact" for o in observed), "the hot-swap stream degraded")
        check(obj_rel is not None and obj_rel <= 1e-4,
              f"epoch-1 objectives vs the CPU port: rel {obj_rel}")

        # -- each rung of the ladder, forced once
        rungs = {}
        fi.inject_slow("batch", 0.5, times=1)
        rungs["ranked"] = service.query(sweep_fp, signature_pool(1, seed=51)[0], 24).fidelity
        time.sleep(0.5)  # let the slow batch finish
        fi.inject_error("batch", times=1)
        fi.inject_error("rank", times=1)
        rungs["stale"] = service.query(sweep_fp, signature_pool(1, seed=52)[0], 24).fidelity
        lone = service.register(E7_4830_V3, machine_id="never-answered")
        fi.inject_error("batch", times=1)
        fi.inject_error("rank", times=1)
        fallback = service.query(lone, signature_pool(1, seed=53)[0], 24)
        rungs["fallback"] = fallback.fidelity
        # the rung's budget cuts in: the batch and the rung held past it,
        # the answer comes stale by the deadline plus the budget
        fi.inject_slow("batch", 0.5, times=1)
        fi.inject_slow("rank", RANK_BUDGET_S + 0.5, times=1)
        t0 = time.perf_counter()
        rungs["budget"] = service.query(sweep_fp, signature_pool(1, seed=54)[0], 24).fidelity
        budget_wall = time.perf_counter() - t0
        time.sleep(1.0)  # the held rung and batch finish
        fi.clear()
        emit("service_resilience", record="ladder", rungs=rungs,
             fallback_placement=list(fallback.placement), budget_wall_ms=budget_wall * 1e3,
             budget_bound_ms=(deadline_s + RANK_BUDGET_S) * 1e3)
        check(rungs == {"ranked": "ranked", "stale": "stale", "fallback": "fallback",
                        "budget": "stale"}, f"ladder rungs {rungs}")
        check(fallback.placement == (6, 6, 6, 6), f"fallback {fallback.placement} is no even spread")
        check(budget_wall < deadline_s + RANK_BUDGET_S + 0.15,
              f"the held rung answered after {budget_wall} s")
    finally:
        service.close()


# the placement-search records' presets (benchmarks/sweep_baseline.json):
# CG over every one-thread-per-core placement of the two 4-node machines
SEARCH_PRESETS = (("E7_4830_V3", 24), ("E5_2699_V3_SNC2", 16))
# regret of a placement tied with the optimum in exact arithmetic: float32
# rounding of permuted placements (rel 1e-6)
REGRET_TOL_PCT = 1e-4
GAIN_TOL_PP = 0.005


def tight_machine():
    """The bandwidth-starved 16-node SNC machine of the reference's search
    tests (tests/test_placement_search.py): fast/slow node pairs, links
    and banks at 0.27 of snc2-8s's."""
    from repro_torch.core.numa import make_machine

    scale = 0.27
    return make_machine(
        "snc2-8s-tight", sockets=8, cores_per_socket=8, nodes_per_socket=2,
        qpi_bw=25.6e9 * scale, core_rate=(2.4e9, 1.6e9) * 8,
        local_read_bw=(52e9 * scale, 26e9 * scale) * 8,
        local_write_bw=(28e9 * scale, 14e9 * scale) * 8,
    )


def timed(fn):
    """``(result, seconds)`` of one call of ``fn``, ending in a synchronise."""
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def receipt(result, seconds: float) -> dict:
    return dict(placement=list(result.placement), objective=result.objective,
                evaluations=result.evaluations, nodes_expanded=result.nodes_expanded,
                optimal=result.optimal, wall_s=seconds)


def tie_gap(machine, wl_cpu, got, want) -> float:
    """0 when the card's placement is the CPU's; else how far the CPU
    scores the card's placement from the CPU's objective (a tie is 0 up
    to rounding)."""
    from repro_torch.core.numa import exact_objectives

    if tuple(got.placement) == tuple(want.placement):
        return 0.0
    obj = float(exact_objectives(machine, wl_cpu, np.asarray([got.placement]))[0])
    return abs(obj - want.objective) / abs(want.objective)


def phase_placement_search() -> None:
    """Placement search on the card, held against the port on the CPU:
    gradient ascent and branch and bound on the two 4-node presets against
    the card's own exhaustive sweep (0% regret), the 16-node snc2-8s at 32
    threads (too large to sweep) with one ascent step profiled, and the
    tight 16-node machine's cold and warm certificates."""
    from repro_torch.core.numa import (
        branch_and_bound,
        exact_objectives,
        optimize_placement,
    )
    from repro_torch.core.numa import machine as machines
    from repro_torch.core.numa.benchmarks import benchmark_workload
    from repro_torch.core.numa.evaluate import placement_array
    from repro_torch.core.numa.search import _ascend_starts, _classes_for
    from repro_torch.launch.advisor_serve import search_machine

    for preset, n in SEARCH_PRESETS:
        m = getattr(machines, preset)
        wl = benchmark_workload("CG", n, device="cuda")
        wl_cpu = benchmark_workload("CG", n, device="cpu")
        table = placement_array(m, n)
        exhaustive, sweep_s = timed(lambda: exact_objectives(m, wl, table))
        best = float(exhaustive.max())
        row = {tuple(int(v) for v in p): i for i, p in enumerate(table)}
        optimize_placement(m, wl)  # first call
        grad, grad_s = timed(lambda: optimize_placement(m, wl))
        bnb, bnb_s = timed(lambda: branch_and_bound(m, wl))
        regret = {k: 100.0 * (best - float(exhaustive[row[r.placement]])) / best
                  for k, r in (("gradient", grad), ("branch_and_bound", bnb))}
        grad_cpu, bnb_cpu = optimize_placement(m, wl_cpu), branch_and_bound(m, wl_cpu)
        ties = {"gradient": tie_gap(m, wl_cpu, grad, grad_cpu),
                "branch_and_bound": tie_gap(m, wl_cpu, bnb, bnb_cpu)}
        emit(
            "placement_search",
            machine=m.name, n_threads=n, benchmark="CG", search_space=len(table),
            exhaustive_s=sweep_s, exhaustive_best=best,
            gradient=receipt(grad, grad_s), branch_and_bound=receipt(bnb, bnb_s),
            regret_pct=regret,
            cpu_objective={"gradient": grad_cpu.objective,
                           "branch_and_bound": bnb_cpu.objective},
            same_placement_as_cpu={"gradient": grad.placement == grad_cpu.placement,
                                   "branch_and_bound": bnb.placement == bnb_cpu.placement},
            other_placement_objective_rel_vs_cpu=ties,
        )
        for k, v in regret.items():
            check(v <= REGRET_TOL_PCT, f"{m.name}: {k} regret {v}% vs the exhaustive sweep")
        check(bnb.optimal and bnb.nodes_expanded == bnb_cpu.nodes_expanded,
              f"{m.name}: branch and bound receipts differ from the CPU's")
        for k, v in ties.items():
            check(v <= 1e-4, f"{m.name}: {k} placement is no tie of the CPU's: rel {v}")

    # snc2-8s: 16 nodes, about 1.07e10 compositions at 32 threads
    m16 = search_machine()
    wl = benchmark_workload("CG", 32, device="cuda")
    wl_cpu = benchmark_workload("CG", 32, device="cpu")
    _, first_s = timed(lambda: optimize_placement(m16, wl))
    grad, grad_s = timed(lambda: optimize_placement(m16, wl))
    bnb, bnb_s = timed(lambda: branch_and_bound(
        m16, wl, gap=0.01, max_nodes=20_000, seed_placements=[grad.placement]))
    (grad_cpu, grad_cpu_s) = timed(lambda: optimize_placement(m16, wl_cpu))
    bnb_cpu = branch_and_bound(m16, wl_cpu, gap=0.01, max_nodes=20_000,
                               seed_placements=[grad_cpu.placement])
    obj_rel = abs(bnb.objective - bnb_cpu.objective) / bnb_cpu.objective
    ties = {"gradient": tie_gap(m16, wl_cpu, grad, grad_cpu),
            "branch_and_bound": tie_gap(m16, wl_cpu, bnb, bnb_cpu)}
    # one ascent step of optimize_placement's 16 starts, under the profiler
    logits0 = np.zeros((16, m16.n_nodes), np.float32)
    classes = _classes_for(wl, None)
    step_profile = device_profile(
        lambda: _ascend_starts(m16, wl, logits0, classes, 1, 0.25, 0.25), top=5)
    emit(
        "placement_search",
        machine=m16.name, n_nodes=m16.n_nodes, n_threads=32, benchmark="CG",
        gradient_first_call_s=first_s,
        gradient=receipt(grad, grad_s),
        branch_and_bound=receipt(bnb, bnb_s),
        cpu_gradient=receipt(grad_cpu, grad_cpu_s),
        cpu_branch_and_bound_objective=bnb_cpu.objective,
        branch_and_bound_objective_rel_vs_cpu=obj_rel,
        other_placement_objective_rel_vs_cpu=ties,
        ascent_steps=150,
        ascent_step_profile=step_profile,
    )
    check(obj_rel <= 1e-4, f"snc2-8s branch and bound objective rel {obj_rel} vs the CPU")
    for k, v in ties.items():
        check(v <= 1e-4, f"snc2-8s {k} placement is no tie of the CPU's: rel {v}")

    # the tight machine: cold B&B spends its budget, the warm start certifies
    tight = tight_machine()
    wl = benchmark_workload("CG", 48, device="cuda")
    cold, cold_s = timed(lambda: branch_and_bound(tight, wl, gap=0.0, max_nodes=4000))
    warm, warm_s = timed(lambda: branch_and_bound(
        tight, wl, gap=0.0, max_nodes=4000, advisor_seeds=8))
    emit("placement_search", machine=tight.name, n_nodes=tight.n_nodes, n_threads=48,
         benchmark="CG", cold=receipt(cold, cold_s), warm=receipt(warm, warm_s))
    check(not cold.optimal and cold.nodes_expanded == 4000,
          f"tight machine cold B&B: optimal={cold.optimal}, {cold.nodes_expanded} nodes")
    check(warm.optimal and warm.nodes_expanded == 0,
          f"tight machine warm B&B: optimal={warm.optimal}, {warm.nodes_expanded} nodes")


def flip_phases(device, n: int = 8):
    """Two static-heavy phases whose hot buffer flips between sockets
    (benchmarks/schedule_search.py's ``_flip_phases``)."""
    from repro_torch.core.numa import mixed_workload

    return [(mixed_workload(f"phase-s{s}", n, read_mix=(0.7, 0.1, 0.0), read_bpi=5.0,
                            static_socket=s, device=device), 5.0) for s in (0, 1)]


def tri_phases(device):
    """The 4-socket 3-phase record's phases (benchmarks/schedule_search.py)."""
    from repro_torch.core.numa import mixed_workload

    return [
        (mixed_workload("tri-s0", 24, read_mix=(0.7, 0.1, 0.0), read_bpi=4.0,
                        static_socket=0, device=device), 4.0),
        (mixed_workload("tri-s2", 24, read_mix=(0.7, 0.1, 0.0), read_bpi=4.0,
                        static_socket=2, device=device), 4.0),
        (mixed_workload("tri-local", 24, read_mix=(0.1, 0.6, 0.1), read_bpi=4.0,
                        device=device), 2.0),
    ]


# the three schedule-search records (benchmarks/sweep_baseline.json):
# label, machine, phases, bytes per moved thread and page, committed gain
SCHEDULE_RECORDS = (
    ("2-socket flip (cheap migration)", "E5_2630_V3", flip_phases, 1e6, 0.9125),
    ("2-socket flip (prohibitive migration)", "E5_2630_V3", flip_phases, 1e13, 0.0),
    ("4-socket 3-phase (cheap migration)", "E7_4830_V3", tri_phases, 1e6, 1.2227),
)


def phase_schedule_search() -> None:
    """The three schedule-search records on the card against the port on
    the CPU: ``gain_pct`` within 0.005 pp, the prohibitive case exactly 0
    with the static schedule."""
    from repro_torch.core.numa import MigrationModel, optimize_schedule, phased_workload
    from repro_torch.core.numa import machine as machines

    for label, preset, phases, cost, committed in SCHEDULE_RECORDS:
        m = getattr(machines, preset)
        model = MigrationModel(thread_move_bytes=cost, page_move_bytes=cost)
        pw = phased_workload(label, phases("cuda"))
        _, first_s = timed(lambda: optimize_schedule(m, pw, model=model))
        res, wall_s = timed(lambda: optimize_schedule(m, pw, model=model))
        cpu = optimize_schedule(m, phased_workload(label, phases("cpu")), model=model)
        emit(
            "schedule_search",
            record=label, machine=m.name, n_threads=pw.n_threads, phases=len(pw.phases),
            gain_pct=res.gain_pct, cpu_gain_pct=cpu.gain_pct,
            committed_gain_pct=committed,
            first_call_s=first_s, wall_s=wall_s,
            candidates=res.candidates, states_expanded=res.states_expanded,
            placements=[list(p) for p in res.schedule.placements],
            moved_threads=sum(res.schedule.moved_threads),
            moved_pages=sum(res.schedule.moved_pages),
        )
        check(abs(res.gain_pct - cpu.gain_pct) <= GAIN_TOL_PP,
              f"{label}: gain {res.gain_pct} vs the CPU's {cpu.gain_pct}")
        if committed == 0.0:
            check(res.gain_pct == 0.0, f"{label}: gain {res.gain_pct}, not exactly 0")
            check(len(set(res.schedule.placements)) == 1
                  and sum(res.schedule.moved_threads) == sum(res.schedule.moved_pages) == 0,
                  f"{label}: the schedule is not the static one")
        else:
            check(res.gain_pct > 0.0, f"{label}: no gain over the static schedule")


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|, in float32 on the CPU."""
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max() / want.abs().max())


def layer_kinds(cfg) -> tuple[int, int]:
    """``(attention layers, mamba layers)`` of a config."""
    from repro_torch.models.model import slot_kinds

    kinds = [slot_kinds(cfg, i % cfg.group_size)[0] for i in range(cfg.n_layers)]
    return kinds.count("attn"), kinds.count("mamba")


def path_run(fn):
    """One run of a main path: both kernels' launch counts set to 0 just
    before ``fn`` and read just after; returns ``(result, K1 launches, K2
    launches)``."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.mamba_scan.kernel import selective_scan

    flash_attention.launches = selective_scan.launches = 0
    out = fn()
    sync()
    return out, flash_attention.launches, selective_scan.launches


def free_card() -> float:
    """Release what earlier phases left cached; returns the GB still
    allocated."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated() / 1e9


def wall_times(fn, runs: int) -> list[float]:
    """Seconds of ``runs`` calls of ``fn``, each ending in a synchronise."""
    walls = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        sync()
        walls.append(time.perf_counter() - t0)
    return walls


def scan_bytes_ms(B: int, S: int, di: int, n: int) -> float:
    """K2's bytes bound: dt, x read and y written in float32, B and C read,
    A read once."""
    return 4 * (3 * B * S * di + 2 * B * S * n + di * n) / HBM_BYTES_PER_S * 1e3


def timed_generate(cfg, params, prompts, new: int) -> tuple[torch.Tensor, float]:
    """``generate`` (teacher-forced prompt, then greedy) after a short
    warm-up; returns the sequences and the seconds it took."""
    from repro_torch.launch.serve import generate

    generate(cfg, params, prompts[:, :2], 4, 2, device="cuda")
    sync()
    t0 = time.perf_counter()
    seqs = generate(cfg, params, prompts, prompts.shape[1] + new, new, device="cuda")
    sync()
    seconds = time.perf_counter() - t0
    check(seqs.shape == (prompts.shape[0], prompts.shape[1] + new)
          and bool(torch.equal(seqs[:, : prompts.shape[1]], prompts)),
          f"{cfg.name}: generate returned the wrong sequences")
    check(bool(((seqs >= 0) & (seqs < cfg.padded_vocab)).all()),
          f"{cfg.name}: token ids out of range")
    return seqs, seconds


REDUCED_ARCHS = ("llama3-8b", "gemma2-9b", "h2o-danube-1.8b", "falcon-mamba-7b",
                 "jamba-1.5-large-398b", "mixtral-8x22b", "qwen3-moe-30b-a3b",
                 "whisper-medium", "internvl2-2b")
# whisper's encoder frames in the reduced runs: no multiple of a tile
REDUCED_FRAMES = 40


def k1_calls(cfg) -> int:
    """K1's launches in one forward: one per attention layer, and for an
    encoder-decoder one per encoder layer and one cross-attention per
    decoder layer."""
    n_attn, _ = layer_kinds(cfg)
    return n_attn + (cfg.encoder_layers + cfg.n_layers if cfg.is_encoder_decoder else 0)


def frontend_inputs(cfg, B: int, rng: np.random.Generator) -> dict:
    """The batch entries of an arch's frontend stub, float32 normal draws
    from ``rng`` on the CPU: whisper's ``enc_frames`` (B, REDUCED_FRAMES, D),
    internvl2's ``patch_embeds`` (B, frontend_tokens, D), else none."""
    if cfg.is_encoder_decoder:
        shape = (B, REDUCED_FRAMES, cfg.d_model)
    elif cfg.frontend == "vit_patches":
        shape = (B, cfg.frontend_tokens, cfg.d_model)
    else:
        return {}
    key = "enc_frames" if cfg.is_encoder_decoder else "patch_embeds"
    return {key: torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)}


def fill_cross(cfg, params, cache, enc_out) -> None:
    """Each decoder layer's cross cache from the encoder output, as the
    reference's own test fills it (``cross_kv`` per layer)."""
    from repro_torch.models.attention import cross_kv

    for layer, entry in zip(params.layers, cache.cross):
        k, v = cross_kv(cfg, layer.cross, enc_out)
        entry.k.copy_(k)
        entry.v.copy_(v)


@torch.no_grad()
def encdec_generate(cfg, params, frames, prompts, new: int, device: str,
                    cache_dtype=torch.bfloat16):
    """An encoder-decoder's greedy generation: the cross cache filled once
    from ``encode``, the prompt teacher-forced through the decode path,
    then ``new`` greedy tokens, as ``launch.serve.generate`` runs a
    decoder-only arch.  Returns ``(sequences, the logits of the last
    prompt position, the step function, the cache, the last token)``."""
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models import model as M

    params = M.cast_for_compute(cfg, params)
    frames, prompts = frames.to(device), prompts.to(device)
    B, P = prompts.shape
    cache = M.init_cache(cfg, B, frames.shape[1], cache_dtype, device=device)
    fill_cross(cfg, params, cache, M.encode(cfg, params, frames, cast=False))
    step = make_decode_step(cfg, cast=False)
    tok, out, prompt_logits = prompts[:, :1], [prompts[:, 0]], None
    for t in range(P + new - 1):
        nxt, logits, cache = step(params, cache, tok, t)
        if t == P - 1:
            prompt_logits = logits
        tok = prompts[:, t + 1 : t + 2] if t + 1 < P else nxt[:, None]
        out.append(tok[:, 0])
    return torch.stack(out, dim=1).to(torch.int32), prompt_logits, (step, params, cache, tok)


def zero_routers(params):
    """A copy of ``params`` with every MoE router zeroed: every top-k
    choice then ties, and both devices break ties by index."""
    import copy

    params = copy.deepcopy(params)
    for layer in params.layers:
        if hasattr(layer.ffn, "router"):
            layer.ffn.router.zero_()
    return params


def phase_lm_reduced() -> None:
    """The reduced configs on the card against the port on the CPU, with
    the same weights and inputs (whisper's 40 encoder frames, internvl2's
    8 patch embeddings): bf16 prefill logits within rel 2e-2, K1 launched
    once per attention call (encoder, decoder and cross) and K2 once per
    mamba layer, and with a float32 compute dtype the generated tokens
    equal (whisper's with its cross cache filled from the encoder).  jamba, whose MoE
    routing feeds its mamba states (``routing_feeds_state``, the rule of
    the CPU tests too), holds its bf16 logits with its routers zeroed at
    rel 4e-2: with random routers the two devices' bf16 roundings flip
    near-tied top-k choices (rel 0.24 on an H100), and with them zeroed
    its 14 mamba states carry the roundings to rel 0.025."""
    import copy
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import model as M

    B, prompt, gen = 2, 16, 8
    for name in REDUCED_ARCHS:
        cfg = get_config(name).reduced()
        n_attn, n_mamba = layer_kinds(cfg)
        n_k1 = k1_calls(cfg)
        cpu_params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        card_params = copy.deepcopy(cpu_params).to("cuda")
        rng = np.random.default_rng(1)
        prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, prompt)), dtype=torch.int32)
        extra = frontend_inputs(cfg, B, rng)
        batch = {"tokens": prompts, **extra}
        hybrid = M.routing_feeds_state(cfg)
        tol = 4e-2 if hybrid else 2e-2
        cpu16, card16 = (zero_routers(p) if hybrid else p for p in (cpu_params, card_params))
        step = make_prefill_step(cfg)
        card_logits, k1, k2 = path_run(
            lambda: step(card16, {k: v.cuda() for k, v in batch.items()}))
        gap = rel_gap(card_logits, step(cpu16, batch))

        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        if cfg.is_encoder_decoder:  # the cross cache filled from the encoder
            frames = extra["enc_frames"]
            card_seqs = encdec_generate(cfg32, card_params, frames, prompts, gen, "cuda")[0].cpu()
            cpu_seqs = encdec_generate(cfg32, cpu_params, frames, prompts, gen, "cpu")[0]
        else:  # internvl2 decodes tokens alone, as the reference does
            card_seqs = generate(cfg32, card_params, prompts, prompt + gen, gen,
                                 device="cuda").cpu()
            cpu_seqs = generate(cfg32, cpu_params, prompts, prompt + gen, gen, device="cpu")
        equal = bool(torch.equal(card_seqs, cpu_seqs))
        emit(
            "lm_reduced",
            arch=cfg.name,
            batch=B, prompt=prompt, gen=gen,
            frontend={k: list(v.shape) for k, v in extra.items()},
            attention_layers=n_attn, mamba_layers=n_mamba, k1_calls_per_forward=n_k1,
            prefill_logits_rel_gap_vs_cpu=gap,
            prefill_tolerance=tol,
            prefill_routers_zeroed=hybrid,
            prefill_k1_launches=k1,
            prefill_k2_launches=k2,
            f32_tokens_equal_cpu=equal,
        )
        check(k1 == n_k1, f"{name}: K1 launched {k1} times for {n_k1} attention calls")
        check(k2 == n_mamba, f"{name}: K2 launched {k2} times for {n_mamba} mamba layers")
        check(gap <= tol, f"{name}: card prefill logits differ from the CPU by rel {gap}")
        check(equal, f"{name}: float32 tokens differ between the card and the CPU")


def phase_lm_danube() -> None:
    """h2o-danube-1.8b at full width and depth on one card: one prefill of
    2 x 8192 tokens, where the 4096-token window acts, with K1 at dh 80
    (padded to 128 by the bf16 kernel's TMA loads) once per layer."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import model as M

    cfg = get_config("h2o-danube-1.8b")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda")
    params = M.init_params(cfg, gen.manual_seed(0), device="cuda", compute=True)
    check(sum(p.numel() for p in params.parameters()) == cfg.param_count(), "parameter count")
    B, S = 2, 8192
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen.manual_seed(1),
                            device="cuda", dtype=torch.int32)
    batch = {"tokens": prompts}
    step = make_prefill_step(cfg)
    flash_attention.launches = 0  # this path's run
    logits = step(params, batch)
    sync()
    launches = flash_attention.launches
    check(launches == cfg.n_layers,
          f"danube prefill launched K1 {launches} times, not once per layer ({cfg.n_layers})")
    check(logits.shape == (B, cfg.padded_vocab), f"danube prefill logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "danube prefill logits are not finite")
    walls = wall_times(lambda: step(params, batch), 2)
    # least time: as llama3-8b's prefill below, with the window's pairs
    layer_weights = cfg.param_count() - 2 * cfg.padded_vocab * cfg.d_model - cfg.d_model
    attn_ops = 4 * cfg.head_dim * B * cfg.n_heads * attention_pairs(S, S, True, cfg.sliding_window)
    prefill_ops = (2 * B * S * layer_weights + 2 * B * cfg.d_model * cfg.padded_vocab
                   + cfg.n_layers * attn_ops)
    emit(
        "lm_danube_prefill",
        arch=cfg.name,
        params=cfg.param_count(),
        head_dim=cfg.head_dim,
        window=cfg.sliding_window,
        batch=B, seq=S,
        k1_launches_per_call=launches,
        prefill_s=min(walls),
        prefill_s_runs=walls,
        prefill_tokens_per_s=B * S / min(walls),
        prefill_bound_ms=prefill_ops / BF16_OPS_PER_S * 1e3,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        profile=device_profile(lambda: step(params, batch), watch="flash_fwd",
                               expected=launches),
    )
    del params, logits
    torch.cuda.empty_cache()


# whisper's start-of-transcript sequence in its multilingual vocabulary:
# <|startoftranscript|> <|en|> <|transcribe|> <|notimestamps|>
WHISPER_PROMPT = (50258, 50259, 50359, 50363)


def attn_weights(cfg) -> int:
    """One attention layer's projection weights (q, k, v, o)."""
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return d * h * dh + 2 * d * kv * dh + h * dh * d


def phase_lm_whisper() -> None:
    """whisper-medium at full width and depth on one card (24 encoder and
    24 decoder layers, d 1,024, 16 heads of 64, random bf16 weights from a
    seed): a prefill of 8 x 1,500 encoder frames (its 30 s window after
    the conv stem) x 448 decoder tokens, K1 launched 72 times (encoder,
    decoder self- and cross-attention per layer); then generation at B=4
    with the cross cache filled once from ``encode``, the 4-token
    start-of-transcript prompt and 60 new tokens; and the decode path's
    logits at the last prompt position held against the prefill's, in
    bf16 and in float32 (a float32 cache)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import model as M

    cfg = get_config("whisper-medium")
    left_gb = free_card()
    gen = torch.Generator(device="cuda")
    t0 = time.perf_counter()
    params = M.init_params(cfg, gen.manual_seed(0), device="cuda", compute=True)
    sync()
    init_s = time.perf_counter() - t0
    count = sum(p.numel() for p in params.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    check(count == M.tree_param_count(cfg), f"whisper-medium holds {count} parameters")

    B, S_enc, T = 8, 1500, cfg.max_target_len
    frames = torch.randn((B, S_enc, cfg.d_model), generator=gen.manual_seed(1), device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (B, T), generator=gen.manual_seed(2),
                           device="cuda", dtype=torch.int32)
    batch = {"tokens": tokens, "enc_frames": frames}
    step = make_prefill_step(cfg)
    logits, path_k1, _ = path_run(lambda: step(params, batch))  # the main path's run
    check(path_k1 == k1_calls(cfg) == 72,
          f"whisper prefill launched K1 {path_k1} times, not 72 (24 encoder, 24 self, 24 cross)")
    check(logits.shape == (B, cfg.padded_vocab), f"whisper prefill logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "whisper prefill logits are not finite")
    walls = wall_times(lambda: step(params, batch), 3)
    profile = device_profile(lambda: step(params, batch), watch="flash_fwd", top=5,
                             expected=path_k1)
    # least time: 2 operations per weight and row of the encoder's layers
    # (frames), the decoder's (tokens; the cross q and o projections on
    # tokens, its k and v on frames), K1's work and the lm_head for the
    # last position, at bf16 peak
    d, f, h, dh = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.head_dim
    layer = attn_weights(cfg) + 3 * d * f
    attn = 4 * dh * B * h * (cfg.encoder_layers * attention_pairs(S_enc, S_enc, False, 0)
                             + cfg.n_layers * (attention_pairs(T, T, True, 0)
                                               + attention_pairs(T, S_enc, False, 0)))
    ops = (2 * B * S_enc * cfg.encoder_layers * layer
           + 2 * B * T * cfg.n_layers * (layer + 2 * d * h * dh)
           + 2 * B * S_enc * cfg.n_layers * 2 * d * cfg.n_kv_heads * dh
           + attn + 2 * B * d * cfg.padded_vocab)
    emit(
        "lm_whisper_prefill",
        arch=cfg.name,
        params=count,
        config_param_count=cfg.param_count(),
        weight_gb=weight_bytes / 1e9,
        allocated_gb_before=left_gb,
        init_s=init_s,
        batch=B, encoder_frames=S_enc, decoder_tokens=T,
        k1_launches_per_call=path_k1,
        prefill_s=min(walls),
        prefill_s_runs=walls,
        frames_per_s=B * S_enc / min(walls),
        decoder_tokens_per_s=B * T / min(walls),
        prefill_bound_ms=ops / BF16_OPS_PER_S * 1e3,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        profile=profile,
    )
    del logits

    # generate: B=4, the cross cache filled once, 4 prompt tokens + 60 new
    Bg, new = 4, 60
    prompts = torch.tensor([WHISPER_PROMPT] * Bg, dtype=torch.int32, device="cuda")
    P = prompts.shape[1]
    encdec_generate(cfg, params, frames[:Bg], prompts[:, :2], 2, "cuda")  # warm-up
    sync()
    t0 = time.perf_counter()
    seqs, dec16, (decode, cparams, cache, tok) = encdec_generate(
        cfg, params, frames[:Bg], prompts, new, "cuda")
    sync()
    gen_s = time.perf_counter() - t0
    steps_run = P + new - 1
    check(seqs.shape == (Bg, P + new) and bool(torch.equal(seqs[:, :P], prompts)),
          "whisper generate returned the wrong sequences")
    check(bool(((seqs >= 0) & (seqs < cfg.padded_vocab)).all()), "whisper token ids out of range")
    step_profile = device_profile(lambda: decode(cparams, cache, tok, cfg.max_target_len - 1))
    del cache

    # the decode path's logits at position P - 1 against the prefill's, in
    # bf16 (as served) and in float32 with a float32 cache
    short = {"tokens": prompts, "enc_frames": frames[:Bg]}
    pre16 = step(params, short)
    gap16 = rel_gap(dec16, pre16)
    del params, cparams, decode
    free_card()
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    params32 = M.init_params(cfg32, gen.manual_seed(0), device="cuda")
    _, dec32, _ = encdec_generate(cfg32, params32, frames[:Bg], prompts, 1, "cuda",
                                  cache_dtype=torch.float32)
    pre32, k1_32, _ = path_run(lambda: make_prefill_step(cfg32)(params32, short))
    gap32 = rel_gap(dec32, pre32)
    emit(
        "lm_whisper_generate",
        arch=cfg.name,
        batch=Bg, encoder_frames=S_enc, prompt=list(WHISPER_PROMPT), gen=new,
        decode_steps=steps_run,
        generate_s=gen_s,
        generated_tokens_per_s=Bg * new / gen_s,
        ms_per_decode_step=1e3 * gen_s / steps_run,
        decode_step_weight_bound_ms=weight_bytes / HBM_BYTES_PER_S * 1e3,
        step_profile=step_profile,
        prefill_vs_decode_logits_rel_gap={"bfloat16": gap16, "float32": gap32},
        prefill_vs_decode_tolerance={"bfloat16": 5e-2, "float32": 1e-3},
        prefill_vs_decode_argmax_agree={
            "bfloat16": f"{int((dec16.argmax(-1) == pre16.argmax(-1)).sum())}/{Bg}",
            "float32": f"{int((dec32.argmax(-1) == pre32.argmax(-1)).sum())}/{Bg}"},
        float32_prefill_k1_launches=k1_32,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
    )
    check(k1_32 == 72, f"the float32 prefill launched K1 {k1_32} times")
    check(gap16 <= 5e-2, f"whisper bf16 prefill and decode logits differ by rel {gap16}")
    check(gap32 <= 1e-3, f"whisper float32 prefill and decode logits differ by rel {gap32}")
    del params32
    free_card()


def phase_lm_internvl2() -> None:
    """internvl2-2b at full width and depth on one card (24 layers, d
    2,048, GQA 16:8 at dh 128, untied head, 1,893,828,608 parameters,
    random bf16 weights from a seed): a prefill of 4 x (256 patch
    embeddings + 1,792 text tokens), K1 launched once per layer; then
    generation on tokens alone (4 x 64 prompt + 32 new), as the
    reference serves the arch."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import model as M

    cfg = get_config("internvl2-2b")
    left_gb = free_card()
    gen = torch.Generator(device="cuda")
    t0 = time.perf_counter()
    params = M.init_params(cfg, gen.manual_seed(0), device="cuda", compute=True)
    sync()
    init_s = time.perf_counter() - t0
    count = sum(p.numel() for p in params.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    check(count == M.tree_param_count(cfg) == 1_893_828_608,
          f"internvl2-2b holds {count} parameters")

    B, n_patch, T = 4, cfg.frontend_tokens, 1792
    S = n_patch + T
    patches = torch.randn((B, n_patch, cfg.d_model), generator=gen.manual_seed(1), device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (B, T), generator=gen.manual_seed(2),
                           device="cuda", dtype=torch.int32)
    batch = {"tokens": tokens, "patch_embeds": patches}
    step = make_prefill_step(cfg)
    logits, path_k1, _ = path_run(lambda: step(params, batch))  # the main path's run
    check(path_k1 == cfg.n_layers == 24,
          f"internvl2 prefill launched K1 {path_k1} times, not once per layer ({cfg.n_layers})")
    check(logits.shape == (B, cfg.padded_vocab), f"internvl2 prefill logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "internvl2 prefill logits are not finite")
    walls = wall_times(lambda: step(params, batch), 3)
    profile = device_profile(lambda: step(params, batch), watch="flash_fwd", top=5,
                             expected=path_k1)
    # least time: the layers' matmuls over all S positions, the patch
    # projection, K1's causal work and the lm_head for the last position
    d = cfg.d_model
    layer = attn_weights(cfg) + 3 * d * cfg.d_ff
    ops = (2 * B * S * cfg.n_layers * layer + 2 * B * n_patch * d * d
           + cfg.n_layers * 4 * cfg.head_dim * B * cfg.n_heads * attention_pairs(S, S, True, 0)
           + 2 * B * d * cfg.padded_vocab)
    emit(
        "lm_internvl2_prefill",
        arch=cfg.name,
        params=count,
        config_param_count=cfg.param_count(),
        weight_gb=weight_bytes / 1e9,
        allocated_gb_before=left_gb,
        init_s=init_s,
        batch=B, patches=n_patch, text_tokens=T,
        k1_launches_per_call=path_k1,
        prefill_s=min(walls),
        prefill_s_runs=walls,
        prefill_tokens_per_s=B * S / min(walls),
        prefill_bound_ms=ops / BF16_OPS_PER_S * 1e3,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        profile=profile,
    )
    prompt, new = 64, 32
    _, gen_s = timed_generate(cfg, params, tokens[:, :prompt], new)
    steps_run = prompt + new - 1
    emit(
        "lm_internvl2_generate",
        arch=cfg.name,
        batch=B, prompt=prompt, gen=new,
        decode_steps=steps_run,
        generate_s=gen_s,
        generated_tokens_per_s=B * new / gen_s,
        ms_per_decode_step=1e3 * gen_s / steps_run,
        decode_step_weight_bound_ms=weight_bytes / HBM_BYTES_PER_S * 1e3,
    )
    del params, logits
    free_card()


def phase_lm_serve() -> int:
    """llama3-8b at full width and depth on one card; returns K1's
    launches in one prefill call (the main path's run)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import model as M

    cfg = get_config("llama3-8b")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda")
    t0 = time.perf_counter()
    params = M.init_params(cfg, gen.manual_seed(0), device="cuda", compute=True)
    sync()
    init_s = time.perf_counter() - t0
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    weight_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    check(sum(p.numel() for p in params.parameters()) == cfg.param_count(), "parameter count")

    # prefill: B=4 x S=2048 random prompts
    B, S = 4, 2048
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen.manual_seed(1),
                            device="cuda", dtype=torch.int32)
    batch = {"tokens": prompts}
    step = make_prefill_step(cfg)
    flash_attention.launches = 0  # the main path's run
    logits = step(params, batch)
    sync()
    path_launches = flash_attention.launches
    check(path_launches == cfg.n_layers,
          f"prefill launched K1 {path_launches} times, not once per layer ({cfg.n_layers})")
    check(logits.shape == (B, cfg.padded_vocab), f"prefill logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "prefill logits are not finite")
    walls = []
    for _ in range(3):
        before = flash_attention.launches
        t0 = time.perf_counter()
        out = step(params, batch)
        sync()
        walls.append(time.perf_counter() - t0)
        check(flash_attention.launches - before == cfg.n_layers, "K1 launches per prefill")
        check(bool(torch.isfinite(out).all()), "prefill logits are not finite")
    prefill_s = min(walls)
    prefill_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prefill_profile = device_profile(lambda: step(params, batch), watch="flash_fwd",
                                     expected=path_launches)
    # least time: 2 operations per weight and token in the layers' matmuls,
    # the lm_head for the last position only, and K1's work, at bf16 peak
    layer_weights = cfg.param_count() - 2 * cfg.padded_vocab * cfg.d_model - cfg.d_model
    attn_ops = 4 * cfg.head_dim * B * cfg.n_heads * attention_pairs(S, S, True, 0)
    prefill_ops = (2 * B * S * layer_weights + 2 * B * cfg.d_model * cfg.padded_vocab
                   + cfg.n_layers * attn_ops)
    emit(
        "lm_serve_prefill",
        arch=cfg.name,
        params=cfg.param_count(),
        weight_gb=weight_bytes / 1e9,
        init_s=init_s,
        init_peak_gb=init_peak_gb,
        batch=B, seq=S,
        k1_launches_per_call=path_launches,
        prefill_s=prefill_s,
        prefill_s_runs=walls,
        prefill_tokens_per_s=B * S / prefill_s,
        prefill_bound_ms=prefill_ops / BF16_OPS_PER_S * 1e3,
        prefill_peak_gb=prefill_peak_gb,
        profile=prefill_profile,
    )

    # generate: B=4, prompt 64 (teacher-forced through the decode path), 32 new
    prompt, new = 64, 32
    p64 = prompts[:, :prompt]
    _, gen_s = timed_generate(cfg, params, p64, new)
    steps_run = prompt + new - 1

    # the decode path teacher-forced over the same 64 tokens, then one
    # profiled step at position 64 against the filled cache
    decode = make_decode_step(cfg, cast=False)  # as generate runs it
    cache = M.init_cache(cfg, B, prompt + 1, torch.bfloat16, device="cuda")
    for t in range(prompt):
        nxt, decode_logits, cache = decode(params, cache, p64[:, t : t + 1], t)
    sync()
    step_profile = device_profile(lambda: decode(params, cache, nxt[:, None], prompt))
    prefill_logits = step(params, {"tokens": p64})
    gap = rel_gap(decode_logits, prefill_logits)
    argmax_agree = int((decode_logits.argmax(-1) == prefill_logits.argmax(-1)).sum())
    emit(
        "lm_serve_generate",
        arch=cfg.name,
        batch=B, prompt=prompt, gen=new,
        decode_steps=steps_run,
        generate_s=gen_s,
        generated_tokens_per_s=B * new / gen_s,
        ms_per_decode_step=1e3 * gen_s / steps_run,
        decode_step_weight_bound_ms=weight_bytes / HBM_BYTES_PER_S * 1e3,
        step_profile=step_profile,
        prefill_vs_decode_logits_rel_gap=gap,
        prefill_vs_decode_argmax_agree=f"{argmax_agree}/{B}",
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
    )
    check(gap <= 5e-2, f"prefill and decode logits at position {prompt - 1} differ by rel {gap}")
    return path_launches


def phase_lm_falcon_mamba() -> tuple[int, dict[str, int]]:
    """falcon-mamba-7b at full width and depth on one card: 64 mamba
    layers, each prefill scan one K2 launch at the K2 cell's shape (B=2 x
    2048, d_inner 8192, N 16), and each of the mixer's three passes one
    launch a layer.  Returns K2's and the passes' launches in one prefill
    call (the main path's run)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.mamba_mixer import kernel as mixer_kernel
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import model as M

    cfg = get_config("falcon-mamba-7b")
    left_gb = free_card()
    gen = torch.Generator(device="cuda")
    t0 = time.perf_counter()
    params = M.init_params(cfg, gen.manual_seed(0), device="cuda", compute=True)
    sync()
    init_s = time.perf_counter() - t0
    count = sum(p.numel() for p in params.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    check(count == M.tree_param_count(cfg), f"falcon-mamba-7b holds {count} parameters")

    B, S = 2, 2048
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen.manual_seed(1),
                            device="cuda", dtype=torch.int32)
    batch = {"tokens": prompts}
    step = make_prefill_step(cfg)
    passes = [getattr(mixer_kernel, name) for name in MIXER_PASSES]
    for counter in passes:
        counter.launches = 0
    logits, path_k1, path_k2 = path_run(lambda: step(params, batch))  # the main path's run
    path_mixer = {name: c.launches for name, c in zip(MIXER_PASSES, passes)}
    check(path_k2 == cfg.n_layers,
          f"falcon prefill launched K2 {path_k2} times, not once per layer ({cfg.n_layers})")
    check(path_mixer == dict.fromkeys(MIXER_PASSES, cfg.n_layers),
          f"falcon prefill launched the mixer passes {path_mixer}, not once per layer")
    check(path_k1 == 0, f"falcon prefill launched K1 {path_k1} times in an attention-free model")
    check(logits.shape == (B, cfg.padded_vocab), f"falcon prefill logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "falcon prefill logits are not finite")
    walls = wall_times(lambda: step(params, batch), 3)
    profile = device_profile(lambda: step(params, batch), watch="selective_scan", top=10,
                             expected=path_k2)
    # least time: the layers' matmuls (2 operations per weight and token,
    # the lm_head for the last position only) at bf16 peak, then each
    # layer's scan at K2's bytes bound
    mixer = cfg.d_model * 2 * cfg.d_inner + cfg.d_inner * (cfg.dt_rank_actual + 2 * cfg.ssm_state)
    mixer += cfg.dt_rank_actual * cfg.d_inner + cfg.d_inner * cfg.d_model
    matmul_ops = 2 * B * S * cfg.n_layers * mixer + 2 * B * cfg.d_model * cfg.padded_vocab
    scan_ms = cfg.n_layers * scan_bytes_ms(B, S, cfg.d_inner, cfg.ssm_state)
    emit(
        "lm_falcon_mamba_prefill",
        arch=cfg.name,
        params=count,
        config_param_count=cfg.param_count(),
        weight_gb=weight_bytes / 1e9,
        allocated_gb_before=left_gb,
        init_s=init_s,
        batch=B, seq=S,
        k2_launches_per_call=path_k2,
        mixer_pass_launches_per_call=path_mixer,
        prefill_s=min(walls),
        prefill_s_runs=walls,
        prefill_tokens_per_s=B * S / min(walls),
        prefill_bound_ms=matmul_ops / BF16_OPS_PER_S * 1e3 + scan_ms,
        matmul_bound_ms=matmul_ops / BF16_OPS_PER_S * 1e3,
        scan_bound_ms=scan_ms,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        profile=profile,
    )

    # generate: B=4, prompt 64 (teacher-forced through the decode path), 32 new
    prompt, new = 64, 32
    p64 = torch.randint(0, cfg.vocab_size, (4, prompt), generator=gen.manual_seed(2),
                        device="cuda", dtype=torch.int32)
    _, gen_s = timed_generate(cfg, params, p64, new)
    steps_run = prompt + new - 1

    # The decode path teacher-forced over the same 64 tokens against the
    # prefill of those tokens, as served (bf16) and in float32 with a
    # float32 cache.  In float32 the two paths must agree.  In bf16 they
    # run other GEMM and conv kernels (the shapes differ), and the 64
    # layers carry each one's roundings (rel 5.9e-2 on an H100); on the
    # CPU, where they round alike, they agree exactly
    # (tests/test_torch_mamba.py).  Two witnesses that this gap is
    # rounding and no bf16-only fault of one path: it grows with the
    # depth (the model cut to its first 8, 16 and 32 layers: 1.3e-2,
    # 2.2e-2, 3.6e-2 on an H100), and the decode path lies no further
    # from its float32 self than 1.5x the prefill's distance from its own
    # (both 6.0e-2 on an H100; lm_reduced holds the prefill against the
    # CPU).
    import dataclasses

    def prefill_and_decode(cfg, params, cache_dtype):
        """Position 63's logits by the prefill and by the decode path."""
        decode = make_decode_step(cfg, cast=False)
        cache = M.init_cache(cfg, 4, prompt + 1, cache_dtype, device="cuda")
        for t in range(prompt):
            nxt, logits, cache = decode(params, cache, p64[:, t : t + 1], t)
        prefill_logits, _, k2 = path_run(lambda: make_prefill_step(cfg)(params, {"tokens": p64}))
        check(k2 == cfg.n_layers, f"falcon prefill of 64 tokens launched K2 {k2} times")
        return prefill_logits.float(), logits.float(), (decode, cache, nxt)

    def agree(a, b):
        return f"{int((a.argmax(-1) == b.argmax(-1)).sum())}/4"

    pre16, dec16, (decode, cache, nxt) = prefill_and_decode(cfg, params, torch.bfloat16)
    # the profiled calls advance the state further; only timing is read
    step_profile = device_profile(lambda: decode(params, cache, nxt[:, None], prompt))
    del cache
    depth_gaps = {}
    for depth in (8, 16, 32):
        cut = dataclasses.replace(cfg, n_layers=depth)
        cut_params = M.LM(params.embed.table, list(params.layers[:depth]), params.final_norm,
                          params.lm_head)
        cut_pre, cut_dec, _ = prefill_and_decode(cut, cut_params, torch.bfloat16)
        depth_gaps[depth] = rel_gap(cut_dec, cut_pre)
    gap = depth_gaps[cfg.n_layers] = rel_gap(dec16, pre16)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    params32 = M.cast_for_compute(cfg32, params)
    pre32, dec32, _ = prefill_and_decode(cfg32, params32, torch.float32)
    del params32
    gap32 = rel_gap(dec32, pre32)
    prefill_bf16_err, decode_bf16_err = rel_gap(pre16, pre32), rel_gap(dec16, dec32)
    emit(
        "lm_falcon_mamba_generate",
        arch=cfg.name,
        batch=4, prompt=prompt, gen=new,
        decode_steps=steps_run,
        generate_s=gen_s,
        generated_tokens_per_s=4 * new / gen_s,
        ms_per_decode_step=1e3 * gen_s / steps_run,
        decode_step_weight_bound_ms=weight_bytes / HBM_BYTES_PER_S * 1e3,
        step_profile=step_profile,
        prefill_vs_decode_logits_rel_gap=gap,
        prefill_vs_decode_argmax_agree=agree(dec16, pre16),
        prefill_vs_decode_rel_gap_by_depth=depth_gaps,
        f32_prefill_vs_decode_logits_rel_gap=gap32,
        f32_prefill_vs_decode_argmax_agree=agree(dec32, pre32),
        prefill_bf16_vs_f32_rel_gap=prefill_bf16_err,
        decode_bf16_vs_f32_rel_gap=decode_bf16_err,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
    )
    check(gap32 <= 1e-3, f"falcon float32 prefill and decode logits at position {prompt - 1} "
                         f"differ by rel {gap32}")
    check(decode_bf16_err <= 1.5 * prefill_bf16_err,
          f"falcon bf16 decode lies rel {decode_bf16_err} from float32, the prefill "
          f"{prefill_bf16_err}")
    by_depth = [depth_gaps[d] for d in sorted(depth_gaps)]
    check(all(a < b for a, b in zip(by_depth, by_depth[1:])),
          f"falcon bf16 prefill vs decode gaps do not grow with the depth: {depth_gaps}")
    # 1.35x the 5.9e-2 read on an H100, the same bits in every run
    check(gap <= 8e-2, f"falcon bf16 prefill and decode logits at position {prompt - 1} "
                       f"differ by rel {gap}")
    return path_k2, path_mixer


def train_path_run(fn):
    """One run of a training path: the four kernel counters (K1 and K2,
    forward and backward) set to 0 just before ``fn`` and read just
    after; returns ``(result, counts)``."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention, flash_attention_bwd
    from repro_torch.kernels.mamba_scan.kernel import selective_scan, selective_scan_bwd

    counters = {"k1": flash_attention, "k1_bwd": flash_attention_bwd,
                "k2": selective_scan, "k2_bwd": selective_scan_bwd}
    for f in counters.values():
        f.launches = 0
    out = fn()
    sync()
    return out, {name: f.launches for name, f in counters.items()}


@contextlib.contextmanager
def no_remat():
    """Every layer stack keeps all its activations inside (the model's
    private ``remat=False``), as the port trained before it recomputed
    its layer groups."""
    from repro_torch.models import model as M

    stack = M._stack
    M._stack = functools.partial(stack, remat=False)
    try:
        yield
    finally:
        M._stack = stack


def trainable(cfg, device, *, draw_on: str | None = None):
    """``(params, tree, opt)``: a trainable LM on ``device`` with float32
    master weights drawn from seed 0 on ``draw_on`` (default ``device``),
    its AdamW tree and zero moments."""
    from repro_torch.launch.steps import param_tree
    from repro_torch.models import model as M
    from repro_torch.optim import adamw

    draw_on = draw_on or device
    gen = torch.Generator(device=draw_on).manual_seed(0)
    params = M.train_mode(M.init_params(cfg, gen, device=draw_on).to(device))
    tree = param_tree(params)
    return params, tree, adamw.init(tree, cfg.moment_dtype)


def phase_lm_reduced_train() -> None:
    """One float32 train step of each reduced arch on the card and on the
    port on the CPU, with the same weights and batch: the loss within rel
    1e-4, the gradient's global norm within rel 1e-3, and on the card K1's
    and K2's backward launched once per attention call (encoder, decoder
    and cross) and mamba layer, their forwards twice (the layer groups'
    recompute, :func:`train_launches`)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw

    for name in REDUCED_ARCHS:
        cfg = dataclasses.replace(get_config(name).reduced(), compute_dtype="float32")
        n_attn, n_mamba = layer_kinds(cfg)
        n_k1 = k1_calls(cfg)
        rng = np.random.default_rng(2)
        # whisper's decoder takes at most max_target_len tokens (32 reduced)
        S = min(40, cfg.max_target_len) if cfg.is_encoder_decoder else 40
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, S + 1)), dtype=torch.int32)
        batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:], **frontend_inputs(cfg, 2, rng)}
        step = make_train_step(cfg, lr_schedule=adamw.cosine_schedule(1e-3, 0, 10))
        cpu_params, _, cpu_opt = trainable(cfg, "cpu")
        _, _, cpu_m = step(cpu_params, cpu_opt, batch, 0)
        params, _, opt = trainable(cfg, "cuda", draw_on="cpu")  # the same initial weights
        card_batch = {k: v.cuda() for k, v in batch.items()}
        (_, _, card_m), counts = train_path_run(lambda: step(params, opt, card_batch, 0))
        loss_gap = abs(float(card_m["loss"]) - float(cpu_m["loss"])) / abs(float(cpu_m["loss"]))
        norm_gap = abs(float(card_m["grad_norm"]) - float(cpu_m["grad_norm"])) \
            / float(cpu_m["grad_norm"])
        emit(
            "lm_reduced_train",
            arch=cfg.name,
            batch=2, seq=S,
            attention_layers=n_attn, mamba_layers=n_mamba, k1_calls_per_forward=n_k1,
            loss=float(card_m["loss"]),
            loss_rel_gap_vs_cpu=loss_gap,
            grad_norm=float(card_m["grad_norm"]),
            grad_norm_rel_gap_vs_cpu=norm_gap,
            launches=counts,
        )
        check(counts == train_launches(n_k1, n_mamba),
              f"{name}: a train step launched {counts} for {n_k1} attention calls and "
              f"{n_mamba} mamba layers")
        check(loss_gap <= 1e-4, f"{name}: card loss differs from the CPU by rel {loss_gap}")
        check(norm_gap <= 1e-3, f"{name}: card gradient norm differs from the CPU by rel {norm_gap}")


def first_step_drop(opt, metrics, b1: float = 0.9, max_norm: float = 1.0) -> dict:
    """What AdamW's first step predicts for the loss.  That step moves
    every coordinate by about ``lr`` whatever its gradient's size (``m /
    sqrt(v)`` is ``g / |g|``), so the loss's first-order change is ``lr``
    times the gradient's L1 norm, read here from the moments after the
    step (``m = (1 - b1) * g``, with the clipping undone)."""
    from repro_torch.optim import adamw

    l1 = sum(float(m.abs().sum(dtype=torch.float64)) for m in adamw._leaves(opt.m))
    norm, lr = float(metrics["grad_norm"]), float(metrics["lr"])
    grad_l1 = l1 / (1 - b1) * max(norm / max_norm, 1.0)
    return dict(lr=lr, grad_norm=norm, grad_l1=grad_l1, first_order_drop=lr * grad_l1)


def train_launches(n_k1: int, n_k2: int) -> dict:
    """The kernel launches of a training run whose forwards call K1
    ``n_k1`` and K2 ``n_k2`` times: each backward once, and each forward
    twice, since the backward recomputes every layer group's forward
    (``models.model._stack``)."""
    return {"k1": 2 * n_k1, "k1_bwd": n_k1, "k2": 2 * n_k2, "k2_bwd": n_k2}


def group_tail_weights(cfg) -> int:
    """The weights of a layer group's last product, which the backward's
    recompute stops before (its result is no saved tensor): the last
    layer's ``w_down``, or its mamba out-projection where it has no FFN."""
    from repro_torch.models.model import slot_kinds

    mixer, _, ffn = slot_kinds(cfg, cfg.group_size - 1)
    if ffn == "dense":
        return cfg.d_ff * cfg.d_model
    if ffn == "none" and mixer == "mamba":
        return cfg.d_inner * cfg.d_model
    raise ValueError(f"{cfg.name}: a group ending in a {mixer} layer with a {ffn} FFN")


def train_step_ops(cfg, B: int, S: int) -> float:
    """Operations of one training step: the forward's matrix products
    (every layer weight and the lm_head once per token) times three for
    the backward's two; the recompute of each layer group's forward, its
    products once more but the group's last (:func:`group_tail_weights`);
    and K1's visible pairs forward (4 dh a pair), once more in the
    recompute, plus its backward (2.5 times the forward)."""
    from repro_torch.models.model import tree_param_count

    layer_weights = tree_param_count(cfg) - 2 * cfg.padded_vocab * cfg.d_model - cfg.d_model
    matmul = 6 * B * S * (layer_weights + cfg.d_model * cfg.padded_vocab)
    recompute = 2 * B * S * (layer_weights - cfg.n_groups * group_tail_weights(cfg))
    n_attn, _ = layer_kinds(cfg)
    attn = 4 * cfg.head_dim * B * cfg.n_heads * attention_pairs(S, S, True, cfg.sliding_window)
    return matmul + recompute + (1 + 1 + 2.5) * n_attn * attn


def phase_lm_danube_train() -> int:
    """h2o-danube-1.8b at full size (24 layers, d 2,560, GQA 32:8, dh 80,
    window 4,096, 1.83 B parameters, nothing cut): float32 master weights
    and moments, bf16 compute, a global batch of 4 x 2,048 in two
    micro-batches.  Six AdamW steps on one fixed batch: the loss is finite
    and falls, K1 launches 24 times backward and 48 times forward (the
    layers' recompute) per micro-batch.  The first two steps again without
    remat: their losses, gradient norms and parameters are the same bits
    (K1 has no atomics), their peak and pace printed beside.  Then the
    same six steps through ``TrainLoop`` with a
    checkpoint every 3 steps and a ``FailureInjector`` at step 4: the run
    resumes from step 3's checkpoint and reproduces steps 4-6's losses and
    the final parameters bit for bit.  One steady step under the profiler
    gives K1 backward's share of the step's device time (its three kernels
    a call), which must stay below 20%.  Returns the first step's
    launches, the first two steps' losses and gradient norms, the
    parameters after them (on the host) and the median ms a step."""
    from repro_torch.checkpoint import store
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import tree_param_count
    from repro_torch.optim import adamw
    from repro_torch.runtime.fault_tolerance import FailureInjector, TrainLoop

    cfg = get_config("h2o-danube-1.8b")
    left_gb = free_card()
    B, S, accum, n_steps = 4, 2048, 2, 6
    batch = TokenStream(cfg, S, B, seed=1, device="cuda").batch_at(0)  # one fixed batch
    step = make_train_step(cfg, accum=accum,
                           lr_schedule=adamw.cosine_schedule(1e-3, 0, n_steps))
    t0 = time.perf_counter()
    params, tree, opt = trainable(cfg, "cuda")
    sync()
    init_s = time.perf_counter() - t0
    count = sum(p.numel() for p in params.parameters())
    check(count == tree_param_count(cfg), f"danube holds {count} parameters")
    state_gb = torch.cuda.memory_allocated() / 1e9

    # the main path's run: the first step
    # the step returns ``params`` itself: bound to ``params`` (not ``_``),
    # the weights go with the ``del`` below
    (params, opt, metrics), counts = train_path_run(lambda: step(params, opt, batch, 0))
    first = first_step_drop(opt, metrics)
    losses, walls = [float(metrics["loss"])], []
    grad_norms = [float(metrics["grad_norm"])]
    after_two = None
    for s in range(1, n_steps):
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch, s)
        losses.append(float(metrics["loss"]))  # a synchronise
        walls.append(time.perf_counter() - t0)
        grad_norms.append(float(metrics["grad_norm"]))
        if s == 1:  # for lm_mesh_train, which repeats the first two steps
            after_two = [p.detach().cpu() for p in params.parameters()]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    final = [p.detach().cpu() for p in params.parameters()]
    per_micro = cfg.n_layers
    check(counts == train_launches(accum * per_micro, 0),
          f"danube train step launched {counts}, not {per_micro} K1 backward and twice as "
          f"many forward a micro-batch")
    check(all(np.isfinite(losses)), f"danube losses are not finite: {losses}")
    check(losses[-1] < losses[0], f"danube loss does not fall: {losses}")
    ms_step = 1e3 * float(np.median(walls))
    # every K1 backward call launches three kernels (D, dK/dV, dQ)
    profile = device_profile(lambda: step(params, opt, batch, n_steps),
                             watch="flash_bwd", top=8, expected=3 * accum * per_micro)
    k1_bwd_share = profile["watched"]["ms"] / profile["device_ms"]
    ops = train_step_ops(cfg, B, S)
    del params, tree, opt, metrics
    remat_left_gb = free_card()

    # the first two steps keeping every activation
    params, tree, opt = trainable(cfg, "cuda")
    plain_hist, plain_walls = [], []
    with no_remat():
        for s in range(2):
            t0 = time.perf_counter()
            params, opt, metrics = step(params, opt, batch, s)
            plain_hist.append((float(metrics["loss"]), float(metrics["grad_norm"])))
            plain_walls.append(time.perf_counter() - t0)
    plain_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    plain_same = all(torch.equal(p.detach().cpu(), w)
                     for p, w in zip(params.parameters(), after_two))
    remat_hist = list(zip(losses[:2], grad_norms[:2]))
    del params, tree, opt, metrics
    plain_left_gb = free_card()

    # the same steps through TrainLoop, killed before step 4 and resumed
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    params, tree, opt = trainable(cfg, "cuda")

    def step_fn(state, s):
        _, o = state
        _, o, m = step(params, o, batch, s)
        return (tree, o), {"loss": float(m["loss"])}

    loop = TrainLoop(step_fn=step_fn, ckpt_dir=ckpt_dir, save_every=3,
                     injector=FailureInjector({4}))
    t0 = time.perf_counter()
    failed = False
    try:
        loop.run((tree, opt), n_steps)
    except FailureInjector.NodeFailure:
        failed = True
    first_s = time.perf_counter() - t0
    saved = store.latest_step(ckpt_dir)
    ckpt_gb = sum(f.stat().st_size for f in (ckpt_dir / f"step_{saved:08d}").iterdir()) / 1e9 \
        if saved is not None else None
    t0 = time.perf_counter()
    _, end, history = loop.run((tree, opt), n_steps)
    resume_s = time.perf_counter() - t0
    resumed_losses = [h["loss"] for h in history]
    same_params = all(torch.equal(p.detach().cpu(), f) for p, f in zip(params.parameters(), final))
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    emit(
        "lm_danube_train",
        arch=cfg.name,
        params=count,
        allocated_gb_before=left_gb,
        init_s=init_s,
        state_gb=state_gb,
        global_batch=B, seq=S, accum=accum,
        param_dtype=cfg.param_dtype, compute_dtype=cfg.compute_dtype,
        moment_dtype=cfg.moment_dtype,
        launches_per_step=counts,
        losses=losses,
        first_step=dict(first, measured_drop=losses[0] - losses[1]),
        step_s_runs=walls,
        ms_per_step=ms_step,
        tokens_per_s=B * S / (ms_step / 1e3),
        step_bound_ms=ops / BF16_OPS_PER_S * 1e3,
        step_ops=ops,
        peak_gb=peak_gb,
        step_profile=profile,
        k1_backward_device_ms=profile["watched"]["ms"],
        k1_backward_share_of_device=k1_bwd_share,
        no_remat=dict(history=plain_hist, remat_history=remat_hist,
                      history_bit_equal=plain_hist == remat_hist,
                      params_bit_equal=plain_same, peak_gb=plain_peak_gb,
                      allocated_gb_before=remat_left_gb, allocated_gb_after=plain_left_gb,
                      step_s_runs=plain_walls, ms_second_step=1e3 * plain_walls[1]),
        resume=dict(
            failed_at=4, checkpoint_step=saved, checkpoint_gb=ckpt_gb,
            first_run_s=first_s, resume_run_s=resume_s, end_step=end,
            resumed_steps=[h["step"] for h in history],
            resumed_losses=resumed_losses,
            losses_bit_equal=resumed_losses == losses[3:],
            final_params_bit_equal=same_params,
        ),
    )
    check(plain_hist == remat_hist,
          f"danube's first two steps without remat {plain_hist} differ from {remat_hist}")
    check(plain_same, "danube's parameters after two steps without remat differ")
    check(failed, "the injected failure at step 4 did not fire")
    check(saved == 3, f"the run killed at step 4 left checkpoint {saved}, not 3")
    check(end == n_steps and [h["step"] for h in history] == [3, 4, 5],
          f"the resumed run ran steps {[h['step'] for h in history]}")
    check(resumed_losses == losses[3:],
          f"resumed losses {resumed_losses} differ from the uninterrupted {losses[3:]}")
    check(same_params, "resumed final parameters differ from the uninterrupted run's")
    check(k1_bwd_share < 0.20,
          f"K1's backward takes {k1_bwd_share:.1%} of the danube step's device time")
    return dict(counts=counts, losses=losses[:2], grad_norms=grad_norms[:2],
                params_after_two=after_two, ms_per_step=ms_step)


def phase_lm_falcon_mamba_train() -> int:
    """falcon-mamba-7b at full width (d 4,096, d_inner 8,192, N 16, vocab
    65,024) with 8 of its 64 layers, cut because AdamW's float32 state for
    all 7.27 B parameters (about 116 GB with the weights and gradients)
    exceeds the card's 80 GB: four steps at B=2 x 2,048, float32 master
    weights and moments, bf16 compute.  The loss is finite and falls, and
    K2 launches 8 times backward and 16 times forward a step (the layers'
    recompute).  Returns the
    first step's launches and loss and the median ms a step."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw

    full = get_config("falcon-mamba-7b")
    cfg = dataclasses.replace(full, n_layers=8)
    left_gb = free_card()
    B, S, n_steps = 2, 2048, 4
    batch = TokenStream(cfg, S, B, seed=2, device="cuda").batch_at(0)
    # Adam's first step moves every weight by about lr whatever its
    # gradient, so the loss's first-order change is lr times the gradient's
    # L1 norm (``first_step`` prints both).  On an H100 that norm was of
    # one size for both models (about 1.5e5 here, 8.2e4 for danube), so at
    # danube's 1e-3 either step is 80-150 nats by first order: far past
    # where the gradient predicts the loss.  danube's loss still fell
    # there; falcon's swung between 0.05 and 11.9 (at 1e-3 and 3e-4).  At
    # 1e-5 the first step is 1.5 nats and the loss falls by what the
    # gradient predicts.
    step = make_train_step(cfg, lr_schedule=adamw.cosine_schedule(1e-5, 0, n_steps))
    params, tree, opt = trainable(cfg, "cuda")
    count = sum(p.numel() for p in params.parameters())
    (_, opt, metrics), counts = train_path_run(lambda: step(params, opt, batch, 0))
    first = first_step_drop(opt, metrics)
    losses, walls = [float(metrics["loss"])], []
    first_norm = float(metrics["grad_norm"])
    for s in range(1, n_steps):
        t0 = time.perf_counter()
        _, opt, metrics = step(params, opt, batch, s)
        losses.append(float(metrics["loss"]))
        walls.append(time.perf_counter() - t0)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms_step = 1e3 * float(np.median(walls))
    check(counts == train_launches(0, cfg.n_layers),
          f"falcon train step launched {counts}, not {cfg.n_layers} K2 backward and twice as "
          f"many forward")
    check(all(np.isfinite(losses)), f"falcon losses are not finite: {losses}")
    check(losses[-1] < losses[0], f"falcon loss does not fall: {losses}")
    profile = device_profile(lambda: step(params, opt, batch, n_steps),
                             watch="selective_scan_bwd", top=8, expected=cfg.n_layers)
    # least time: the matrix products at bf16 peak, plus each layer's scan
    # forward and backward at their bytes bounds
    scan_ms = cfg.n_layers * (scan_bytes_ms(B, S, cfg.d_inner, cfg.ssm_state)
                              + scan_bwd_bytes(B, S, cfg.d_inner, cfg.ssm_state)
                              / HBM_BYTES_PER_S * 1e3)
    bound_ms = train_step_ops(cfg, B, S) / BF16_OPS_PER_S * 1e3 + scan_ms
    emit(
        "lm_falcon_mamba_train",
        arch=cfg.name,
        layers=cfg.n_layers,
        layers_full=full.n_layers,
        params=count,
        allocated_gb_before=left_gb,
        batch=B, seq=S,
        launches_per_step=counts,
        losses=losses,
        first_step=dict(first, measured_drop=losses[0] - losses[1]),
        step_s_runs=walls,
        ms_per_step=ms_step,
        tokens_per_s=B * S / (ms_step / 1e3),
        step_bound_ms=bound_ms,
        scans_bound_ms=scan_ms,
        peak_gb=peak_gb,
        step_profile=profile,
    )
    return dict(counts=counts, loss=losses[0], grad_norm=first_norm, ms_per_step=ms_step)


def phase_lm_qwen3_moe() -> None:
    """qwen3-moe-30b-a3b at full width and depth on one card: 48 layers of
    GQA attention (K1 once per layer in a prefill) and 128 experts top-8
    through the batched single-device dispatch; 61.1 GB of bf16 weights,
    so every earlier model is freed first.  No prefill-against-decode
    check: capacity drops make the two paths differ by design, so the
    prefill's dropped assignments are counted instead."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod

    cfg = get_config("qwen3-moe-30b-a3b")
    left_gb = free_card()
    gen = torch.Generator(device="cuda")
    t0 = time.perf_counter()
    params = M.init_params(cfg, gen.manual_seed(0), device="cuda", compute=True)
    sync()
    init_s = time.perf_counter() - t0
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    count = sum(p.numel() for p in params.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    check(count == cfg.param_count() == M.tree_param_count(cfg), f"qwen3 holds {count} parameters")

    B, S = 2, 2048
    T = B * S
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen.manual_seed(1),
                            device="cuda", dtype=torch.int32)
    batch = {"tokens": prompts}
    step = make_prefill_step(cfg)
    logits, k1, k2 = path_run(lambda: step(params, batch))  # the main path's run
    check(k1 == cfg.n_layers,
          f"qwen3 prefill launched K1 {k1} times, not once per layer ({cfg.n_layers})")
    check(k2 == 0, f"qwen3 prefill launched K2 {k2} times in a model without mamba layers")
    check(logits.shape == (B, cfg.padded_vocab), f"qwen3 prefill logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "qwen3 prefill logits are not finite")

    # one more prefill with each layer's routing read: selected (token,
    # expert) pairs that found no slot (the model's own tally), and the
    # most tokens one expert drew
    loads, route = [], moe_mod.route

    def load_route(*args):
        r = route(*args)
        loads.append(torch.bincount(r.top_i[r.top_p > 0], minlength=cfg.n_experts).max())
        return r

    moe_mod.route = load_route
    try:
        with moe_mod.drop_tally() as dropped:
            step(params, batch)
    finally:
        moe_mod.route = route
    check(len(dropped) == cfg.n_layers, f"{len(dropped)} routed layers of {cfg.n_layers}")
    dropped = torch.stack(dropped).tolist()
    loads = torch.stack(loads).tolist()

    walls = wall_times(lambda: step(params, batch), 3)
    profile = device_profile(lambda: step(params, batch), watch="flash_fwd", top=10,
                             expected=k1)
    # least time: every expert's (C+1)-row buffer through its three
    # products (the reference's work), the attention projections and the
    # router for every token, K1's causal pairs and the last position's
    # lm_head at bf16 peak; or the weights read once, whichever is longer
    C = moe_mod._capacity(cfg, T)
    h, kv, dh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    per_layer = (2 * cfg.n_experts * (C + 1) * 3 * d * cfg.d_ff
                 + 2 * T * (d * (h + 2 * kv) * dh + h * dh * d + d * cfg.n_experts)
                 + 4 * dh * B * h * attention_pairs(S, S, True, 0))
    prefill_ops = cfg.n_layers * per_layer + 2 * B * d * cfg.padded_vocab
    ops_ms = prefill_ops / BF16_OPS_PER_S * 1e3
    bytes_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    emit(
        "lm_qwen3_moe_prefill",
        arch=cfg.name,
        params=count,
        weight_gb=weight_bytes / 1e9,
        allocated_gb_before=left_gb,
        init_s=init_s,
        init_peak_gb=init_peak_gb,
        batch=B, seq=S,
        capacity=C,
        dropped_assignments=sum(dropped),
        dropped_per_layer=dropped,
        max_expert_load_per_layer=loads,
        routed_assignments=cfg.n_layers * T * cfg.experts_per_token,
        k1_launches_per_call=k1,
        prefill_s=min(walls),
        prefill_s_runs=walls,
        prefill_tokens_per_s=T / min(walls),
        prefill_bound_ms=max(ops_ms, bytes_ms),
        prefill_bound_by="operations" if ops_ms >= bytes_ms else "bytes",
        ops_bound_ms=ops_ms,
        weight_bytes_bound_ms=bytes_ms,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        profile=profile,
    )

    # generate: B=4, prompt 16 (teacher-forced through the decode path), 16 new
    prompt, new = 16, 16
    p16 = torch.randint(0, cfg.vocab_size, (4, prompt), generator=gen.manual_seed(2),
                        device="cuda", dtype=torch.int32)
    seqs16, gen_s = timed_generate(cfg, params, p16, new)
    steps_run = prompt + new - 1
    decode = make_decode_step(cfg, cast=False)
    cache = M.init_cache(cfg, 4, prompt + 2, torch.bfloat16, device="cuda")
    for t in range(prompt):
        nxt, decode_logits, cache = decode(params, cache, p16[:, t : t + 1], t)
    sync()
    check(bool(torch.isfinite(decode_logits).all()), "qwen3 decode logits are not finite")
    step_profile = device_profile(lambda: decode(params, cache, nxt[:, None], prompt))
    emit(
        "lm_qwen3_moe_generate",
        arch=cfg.name,
        batch=4, prompt=prompt, gen=new,
        decode_steps=steps_run,
        decode_capacity=moe_mod._capacity(cfg, 4),
        generate_s=gen_s,
        generated_tokens_per_s=4 * new / gen_s,
        ms_per_decode_step=1e3 * gen_s / steps_run,
        decode_step_weight_bound_ms=bytes_ms,
        step_profile=step_profile,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
    )
    del cache
    return dict(params=params, batch=batch, logits=logits, dropped=sum(dropped),
                prompts=p16, seqs=seqs16, gen_s=gen_s)


MESH_ARCHS = ("llama3-8b", "gemma2-9b", "falcon-mamba-7b", "qwen3-moe-30b-a3b",
              "jamba-1.5-large-398b")


def long_decode(cfg, mesh, slots: int, first: int, steps: int) -> dict:
    """``steps`` decode steps of ``cfg`` at full size and B = 1 from
    position ``first`` against a cache of ``slots`` (a ring where the
    arch's window is shorter) filled from a seeded generator, once with no
    mesh and once under the ``long`` decode cell (B = 1: the sequence over
    every axis of ``mesh``); the weights are freed after."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models import model as M
    from repro_torch.parallel import context as ctx

    free_card()
    gen = torch.Generator(device="cuda")
    params = M.init_params(cfg, gen.manual_seed(0), device="cuda", compute=True)
    params = M.cast_for_compute(cfg, params)
    none_cache = M.init_cache(cfg, 1, slots, torch.bfloat16, device="cuda")
    gen.manual_seed(1)
    for entry in none_cache:
        entry.k.normal_(generator=gen)
        entry.v.normal_(generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (1, steps), generator=gen.manual_seed(2),
                           device="cuda", dtype=torch.int32)
    shape = ShapeConfig("long", slots, 1, "decode")
    with mesh_lib.cell_context(mesh, cfg, shape):
        layout = dict(cache_seq=ctx.physical_axes("cache_seq"),
                      cache_batch=ctx.physical_axes("cache_batch"), tp=ctx.physical_axes("tp"))
        local = mesh_lib.shard_params(cfg, params)
        mesh_cache = M.init_cache(cfg, 1, slots, torch.bfloat16, device="cuda")
        for mine, whole in zip(mesh_cache, none_cache):
            mine.k.copy_(whole.k)
            mine.v.copy_(whole.v)
    cache_bytes = sum(t.numel() * t.element_size() for e in none_cache for t in (e.k, e.v))
    step = make_decode_step(cfg, cast=False)

    def run(weights, cache, cell):
        logits, walls = [], []
        for t in range(steps):
            with cell():
                sync()
                t0 = time.perf_counter()
                _, lg, cache = step(weights, cache, tokens[:, t : t + 1], first + t)
                sync()
            walls.append(time.perf_counter() - t0)
            logits.append(lg)
        return torch.stack(logits), walls

    none_logits, none_walls = run(params, none_cache, contextlib.nullcontext)
    mesh_logits, mesh_walls = run(local, mesh_cache, lambda: mesh_lib.cell_context(mesh, cfg, shape))
    out = dict(arch=cfg.name, mesh=mesh.shape, layout=layout, batch=1, slots=slots,
               positions=[first, first + steps - 1], cache_gb=cache_bytes / 1e9,
               local_cache_gb=sum(t.numel() * t.element_size()
                                  for e in mesh_cache for t in (e.k, e.v)) / 1e9,
               weights_shared_with_no_mesh=local is params,
               logits_bit_equal=bool(torch.equal(mesh_logits, none_logits)),
               logits_max_abs_diff=float((mesh_logits.float() - none_logits.float()).abs().max()),
               logits_finite=bool(torch.isfinite(mesh_logits).all()),
               ms_per_step=1e3 * min(mesh_walls[1:]), no_mesh_ms_per_step=1e3 * min(none_walls[1:]),
               ms_per_step_runs=[1e3 * w for w in mesh_walls],
               no_mesh_ms_per_step_runs=[1e3 * w for w in none_walls],
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del params, local, none_cache, mesh_cache
    free_card()
    return out


def phase_lm_mesh() -> None:
    """Serving across ranks on one card: the mesh code (``parallel``,
    ``launch.mesh``, the sharded layers and MoE paths) at one rank, where
    every collective spans one process, so the mesh paths must reproduce
    the no-mesh ones.  The reduced archs on the card against the same code
    on the CPU (bf16 prefill within rel 2e-2, jamba 4e-2 with its routers
    zeroed; float32 tokens equal); the sequence-sharded decode cache at
    full size (llama3-8b's 32,768 slots, h2o-danube-1.8b's ``long_500k``
    ring) bit-equal to ``--mesh none``; then qwen3-moe-30b-a3b at full
    size (phase_lm_qwen3_moe runs here, once the long caches are freed):
    its weights exceed a quarter of the card, so its decode cell takes
    2-D tensor parallelism, its experts stay sharded over ``efsdp`` and
    decode takes the no-gather path."""
    import copy
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod
    from repro_torch.parallel import context as ctx

    t_start = time.perf_counter()
    store = ROOT / "build" / "chip_smoke_mesh_store"
    store.parent.mkdir(exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group("cpu:gloo,cuda:nccl", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1)
    try:
        mesh = mesh_lib.make_production_mesh()
        check(mesh.shape == {"data": 1, "model": 1}, f"--mesh single at one rank is {mesh.shape}")
        B, prompt, gen = 2, 16, 8
        for name in MESH_ARCHS:
            cfg = get_config(name).reduced()
            cpu_params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
            card_params = copy.deepcopy(cpu_params).to("cuda")
            prompts = torch.as_tensor(np.random.default_rng(1).integers(
                0, cfg.vocab_size, (B, prompt)), dtype=torch.int32)
            hybrid = M.routing_feeds_state(cfg)
            tol = 4e-2 if hybrid else 2e-2
            cpu16, card16 = (zero_routers(p) if hybrid else p for p in (cpu_params, card_params))
            cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
            with mesh_lib.cell_context(mesh, cfg, ShapeConfig("p", prompt, B, "prefill")):
                step = make_prefill_step(cfg)
                card_logits = step(mesh_lib.shard_params(cfg, card16), {"tokens": prompts.cuda()})
                gap = rel_gap(card_logits, step(mesh_lib.shard_params(cfg, cpu16),
                                                {"tokens": prompts}))
            with mesh_lib.cell_context(mesh, cfg32, ShapeConfig("d", prompt + gen, B, "decode")):
                card_seqs = generate(cfg32, mesh_lib.shard_params(cfg32, card_params), prompts,
                                     prompt + gen, gen, device="cuda").cpu()
                cpu_seqs = generate(cfg32, mesh_lib.shard_params(cfg32, cpu_params), prompts,
                                    prompt + gen, gen, device="cpu")
            equal = bool(torch.equal(card_seqs, cpu_seqs))
            emit("lm_mesh_reduced", arch=cfg.name, mesh=mesh.shape, batch=B, prompt=prompt,
                 gen=gen, prefill_logits_rel_gap_vs_cpu=gap, prefill_tolerance=tol,
                 prefill_routers_zeroed=hybrid, f32_tokens_equal_cpu=equal)
            check(gap <= tol, f"{name}: mesh prefill on the card differs from the CPU by {gap}")
            check(equal, f"{name}: mesh float32 tokens differ between the card and the CPU")
        reduced_s = time.perf_counter() - t_start

        # the sequence-sharded decode cache at full size, one rank holding
        # every block: llama3-8b's 32,768 slots, danube's long_500k ring
        t_long = time.perf_counter()
        for cfg, slots, first in ((get_config("llama3-8b"), 32_768, 32_760),
                                  (get_config("h2o-danube-1.8b"), 524_288, 524_280)):
            row = long_decode(cfg, mesh, slots, first, 8)
            emit("lm_mesh_long_decode", **row, nvidia_smi=nvidia_smi("name,power.limit"))
            check(row["layout"]["cache_seq"] == ("data", "model") and not row["layout"]["cache_batch"],
                  f"{cfg.name}: the long cell lays the cache out as {row['layout']}")
            check(row["logits_finite"], f"{cfg.name}: long decode logits are not finite")
            check(row["logits_bit_equal"],
                  f"{cfg.name}: the long cell's decode differs from --mesh none by "
                  f"{row['logits_max_abs_diff']}")
        long_s = time.perf_counter() - t_long

        qwen3 = phase_lm_qwen3_moe()
        cfg = get_config("qwen3-moe-30b-a3b")
        params, batch = qwen3["params"], qwen3["batch"]
        B, S = batch["tokens"].shape
        with mesh_lib.cell_context(mesh, cfg, ShapeConfig("serve", S, B, "prefill")):
            efsdp = ctx.physical_axes("efsdp")
            local = mesh_lib.shard_params(cfg, params)
            step = make_prefill_step(cfg)
            with moe_mod.drop_tally() as drops:
                logits, k1, k2 = path_run(lambda: step(local, batch))
            walls = wall_times(lambda: step(local, batch), 2)
        cfg_a2a = dataclasses.replace(cfg, moe_impl="a2a")
        with mesh_lib.cell_context(mesh, cfg_a2a, ShapeConfig("serve", S, B, "prefill")):
            with moe_mod.drop_tally() as a2a_drops:
                a2a_logits, a2a_k1, _ = path_run(lambda: make_prefill_step(cfg_a2a)(local, batch))
            a2a_s = min(wall_times(lambda: make_prefill_step(cfg_a2a)(local, batch), 1))
        want = qwen3["logits"]
        gap = rel_gap(logits, want)
        p16 = qwen3["prompts"]
        new = qwen3["seqs"].shape[1] - p16.shape[1]
        with mesh_lib.cell_context(mesh, cfg, ShapeConfig("serve", p16.shape[1] + new,
                                                          p16.shape[0], "decode")):
            decode_path = "no-gather" if ctx.physical_axes("efsdp") else "gather"
            decode_tp, decode_fsdp = ctx.physical_axes("tp"), ctx.physical_axes("fsdp")
            decoding = mesh_lib.shard_params(cfg, params)  # the 2-D decode cut
            seqs, gen_s = timed_generate(cfg, decoding, p16, new)
        # the no-mesh generate once more, after the mesh's: the decode steps
        # are host-bound, and the first generate of lm_qwen3_moe ran first
        _, none_after_s = timed_generate(cfg, params, p16, new)
        steps_run = p16.shape[1] + new - 1
        emit(
            "lm_mesh_qwen3",
            arch=cfg.name, mesh=mesh.shape, efsdp=list(efsdp), decode_path=decode_path,
            weights_shared_with_no_mesh=local is params,
            batch=B, seq=S,
            gather_logits_rel_gap_vs_no_mesh=gap,
            gather_logits_max_abs_diff=float((logits.float() - want.float()).abs().max()),
            gather_logits_bit_equal=bool(torch.equal(logits, want)),
            gather_dropped_assignments=int(sum(int(d) for d in drops)),
            no_mesh_dropped_assignments=qwen3["dropped"],
            a2a_dropped_assignments=int(sum(int(d) for d in a2a_drops)),
            a2a_logits_finite=bool(torch.isfinite(a2a_logits).all()),
            a2a_logits_rel_gap_vs_gather=rel_gap(a2a_logits, logits),
            k1_launches_per_prefill=k1, a2a_k1_launches_per_prefill=a2a_k1,
            prefill_s=min(walls), prefill_s_runs=walls, prefill_tokens_per_s=B * S / min(walls),
            a2a_prefill_s=a2a_s,
            generate_s=gen_s, no_mesh_generate_s=qwen3["gen_s"],
            no_mesh_generate_s_after=none_after_s,
            generated_tokens_per_s=p16.shape[0] * new / gen_s,
            decode_tp=list(decode_tp), decode_fsdp=list(decode_fsdp),
            decode_weights_shared_with_no_mesh=decoding is params,
            ms_per_decode_step=1e3 * gen_s / steps_run,
            no_mesh_ms_per_decode_step=1e3 * qwen3["gen_s"] / steps_run,
            no_mesh_ms_per_decode_step_after=1e3 * none_after_s / steps_run,
            tokens_equal_no_mesh=bool(torch.equal(seqs, qwen3["seqs"])),
            nvidia_smi=nvidia_smi("name,power.limit"),
            reduced_s=reduced_s, long_s=long_s, phase_s=time.perf_counter() - t_start,
        )
        check(local is params and decoding is params,
              "one rank's shards of qwen3 are not the whole model")
        check(decode_tp == ("model", "data") and not decode_fsdp,
              f"qwen3's decode cell took tp {decode_tp} and fsdp {decode_fsdp}, not 2-D TP")
        check(bool(torch.equal(seqs, qwen3["seqs"])),
              "qwen3's --mesh single tokens through 2-D decode TP differ from --mesh none's")
        check(k1 == cfg.n_layers and a2a_k1 == cfg.n_layers,
              f"mesh prefill launched K1 {k1} / {a2a_k1} times for {cfg.n_layers} layers")
        check(k2 == 0, f"mesh prefill launched K2 {k2} times in a model without mamba layers")
        check(gap <= 1e-3, f"one-rank mesh prefill differs from --mesh none by rel {gap}")
        check(bool(torch.isfinite(a2a_logits).all()), "a2a prefill logits are not finite")
        check(a2a_logits.shape == logits.shape, f"a2a logits {tuple(a2a_logits.shape)}")
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)


def mesh_train_history(cfg, params, batch, n_steps: int, **step_args) -> tuple[list, dict]:
    """``n_steps`` of ``make_train_step`` on ``params`` (trainable, this
    rank's shards), the first under ``train_path_run``: ``([(loss,
    grad_norm), ...], the first step's launches)``."""
    from repro_torch.launch.steps import make_train_step, param_tree
    from repro_torch.optim import adamw

    step = make_train_step(cfg, **step_args)
    opt = adamw.init(param_tree(params), cfg.moment_dtype)
    (_, opt, m), counts = train_path_run(lambda: step(params, opt, batch, 0))
    hist = [(float(m["loss"]), float(m["grad_norm"]))]
    for s in range(1, n_steps):
        _, opt, m = step(params, opt, batch, s)
        hist.append((float(m["loss"]), float(m["grad_norm"])))
    return hist, counts


def phase_lm_mesh_train(danube: dict, falcon: dict) -> None:
    """Training across ranks on one card: the mesh train step (the hoisted
    compute copy, each micro-batch's gradient summed onto the shards, the
    global norm over shards) at one rank, where every collective and its
    backward return their input, so it must reproduce the no-mesh step.
    The reduced archs on the card against the CPU; h2o-danube-1.8b at full
    size against lm_danube_train's first two steps (``danube``), bit for
    bit; falcon's 8-layer step's loss and gradient norm against
    lm_falcon_mamba_train's first (``falcon``); ``compressed_psum_mean``
    at one rank."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw
    from repro_torch.parallel import context as ctx
    from repro_torch.parallel.compression import compressed_grad_mean, compressed_psum_mean

    t_start = time.perf_counter()
    free_card()
    store = ROOT / "build" / "chip_smoke_mesh_train_store"
    store.parent.mkdir(exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group("cpu:gloo,cuda:nccl", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1)
    try:
        mesh = mesh_lib.make_production_mesh()
        check(mesh.shape == {"data": 1, "model": 1}, f"--mesh single at one rank is {mesh.shape}")
        B, S = 2, 40
        for name in MESH_ARCHS:
            cfg = dataclasses.replace(get_config(name).reduced(), compute_dtype="float32")
            rng = np.random.default_rng(2)
            tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S + 1)),
                                     dtype=torch.int32)
            batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
            lr = adamw.cosine_schedule(1e-3, 0, 10)
            with mesh_lib.cell_context(mesh, cfg, ShapeConfig("t", S, B, "train")):
                cpu_params, _, _ = trainable(cfg, "cpu")
                cpu_hist, _ = mesh_train_history(cfg, mesh_lib.shard_params(cfg, cpu_params),
                                                 batch, 2, lr_schedule=lr)
                card_params, _, _ = trainable(cfg, "cuda", draw_on="cpu")
                card_batch = {k: v.cuda() for k, v in batch.items()}
                card_hist, counts = mesh_train_history(
                    cfg, mesh_lib.shard_params(cfg, card_params), card_batch, 2, lr_schedule=lr)
            loss_gap = max(abs(c[0] - w[0]) / abs(w[0]) for c, w in zip(card_hist, cpu_hist))
            norm_gap = max(abs(c[1] - w[1]) / w[1] for c, w in zip(card_hist, cpu_hist))
            n_k1, (_, n_mamba) = k1_calls(cfg), layer_kinds(cfg)
            emit("lm_mesh_train_reduced", arch=cfg.name, mesh=mesh.shape, batch=B, seq=S,
                 card_history=card_hist, cpu_history=cpu_hist, loss_rel_gap_vs_cpu=loss_gap,
                 grad_norm_rel_gap_vs_cpu=norm_gap, launches=counts)
            check(counts == train_launches(n_k1, n_mamba),
                  f"{name}: a mesh train step launched {counts}")
            check(loss_gap <= 1e-4,
                  f"{name}: mesh train loss on the card differs from the CPU by rel {loss_gap}")
            check(norm_gap <= 1e-3,
                  f"{name}: mesh gradient norm on the card differs from the CPU by rel {norm_gap}")
        reduced_s = time.perf_counter() - t_start

        # h2o-danube-1.8b at full size in lm_danube_train's cell, from its
        # seed and batch (the state rebuilt, not copied): the counted step,
        # then a timed one
        cfg = get_config("h2o-danube-1.8b")
        B, S, accum = 4, 2048, 2
        batch = TokenStream(cfg, S, B, seed=1, device="cuda").batch_at(0)
        t0 = time.perf_counter()
        with mesh_lib.cell_context(mesh, cfg, ShapeConfig("t", S, B, "train")):
            params, _, opt = trainable(cfg, "cuda")
            local = mesh_lib.shard_params(cfg, params)
            check(local is params, "one rank's shards of danube are not the whole model")
            step = make_train_step(cfg, accum=accum,
                                   lr_schedule=adamw.cosine_schedule(1e-3, 0, 6))
            (_, opt, m), counts = train_path_run(lambda: step(local, opt, batch, 0))
            hist = [(float(m["loss"]), float(m["grad_norm"]))]
            t1 = time.perf_counter()
            _, opt, m = step(local, opt, batch, 1)
            hist.append((float(m["loss"]), float(m["grad_norm"])))
            step_s = time.perf_counter() - t1
        want = list(zip(danube["losses"], danube["grad_norms"]))
        same, worst = True, 0.0
        for p, w in zip(local.parameters(), danube["params_after_two"]):
            got = p.detach().cpu()
            if not torch.equal(got, w):
                same = False
                worst = max(worst, float((got.float() - w.float()).abs().max()))
        del params, local, opt, m
        free_card()
        emit("lm_mesh_train_danube", arch=cfg.name, mesh=mesh.shape, global_batch=B, seq=S,
             accum=accum, history=hist, no_mesh_history=want, history_bit_equal=hist == want,
             params_bit_equal=same, params_max_abs_diff=worst, launches_per_step=counts,
             k1_backward_launches_per_step=counts["k1_bwd"],
             mesh_ms_per_step=1e3 * step_s, no_mesh_ms_per_step=danube["ms_per_step"],
             part_s=time.perf_counter() - t0)
        check(counts == danube["counts"],
              f"danube mesh step launched {counts}, not {danube['counts']} as without the mesh")
        check(counts["k1_bwd"] == accum * cfg.n_layers, f"danube K1 backward {counts['k1_bwd']}")
        check(hist == want, f"danube mesh history {hist} differs from the no-mesh {want}")
        check(same, f"danube parameters after two mesh steps differ by up to {worst}")

        # falcon's 8-layer train step through the mesh code
        cfg = dataclasses.replace(get_config("falcon-mamba-7b"), n_layers=8)
        batch = TokenStream(cfg, 2048, 2, seed=2, device="cuda").batch_at(0)
        with mesh_lib.cell_context(mesh, cfg, ShapeConfig("t", 2048, 2, "train")):
            params, _, _ = trainable(cfg, "cuda")
            fal_hist, fal_counts = mesh_train_history(
                cfg, mesh_lib.shard_params(cfg, params), batch, 1,
                lr_schedule=adamw.cosine_schedule(1e-5, 0, 4))
        del params
        free_card()
        want = (falcon["loss"], falcon["grad_norm"])
        emit("lm_mesh_train_falcon", arch=cfg.name, layers=cfg.n_layers, loss=fal_hist[0][0],
             grad_norm=fal_hist[0][1], no_mesh_loss=want[0], no_mesh_grad_norm=want[1],
             bit_equal=fal_hist[0] == want, launches=fal_counts)
        check(fal_counts == falcon["counts"] and fal_counts["k2_bwd"] == cfg.n_layers,
              f"falcon mesh step launched {fal_counts}, not {falcon['counts']}")
        check(fal_hist[0] == want,
              f"falcon mesh loss and gradient norm {fal_hist[0]} differ from the no-mesh {want}")

        # the int8 error-feedback mean at one rank
        with ctx.use_mesh(mesh):
            x = torch.randn(1000, device="cuda", generator=torch.Generator("cuda").manual_seed(3))
            same_x = compressed_psum_mean(x, ("data",)) is x
            mean, res = compressed_grad_mean({"w": x})
        identity = same_x and bool(torch.equal(mean["w"], x)) and bool((res["w"] == 0).all())
        emit("lm_mesh_train_compression", one_rank_identity=identity,
             nvidia_smi=nvidia_smi("name,power.limit"),
             reduced_s=reduced_s, phase_s=time.perf_counter() - t_start)
        check(identity, "the compressed mean at one rank is not the identity")
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)


DRYRUN_CELLS = (
    # label, arch, the cell: lm_serve_prefill's and lm_danube_train's
    ("llama3-8b prefill", "llama3-8b", ("p", 2048, 4, "prefill")),
    ("h2o-danube-1.8b train", "h2o-danube-1.8b", ("t", 2048, 4, "train")),
)
# The meta run's predicted peak against the card's: the gaps read on the
# H100 were 3.0e-8 (llama3-8b prefill) and 6.5e-3 (danube's train step).
PEAK_REL = 0.02
# The caching allocator rounds a block up to 512 bytes; a block over 1 MiB
# comes from the large pool and keeps a remainder of up to 1 MiB unsplit.
ALLOCATOR_BLOCK, ALLOCATOR_SMALL = 512, 1 << 20


def phase_dryrun() -> None:
    """The counter source (``core.meshsig.counters.count_program``), the
    dry run and the mesh-signature validation on the card host: (a)
    ``run_validation`` for llama3-8b's ``train_4k`` on ``meta`` (five
    meshes of up to 256 ranks, each rank 0 of a layout-only mesh), the
    fitted signature giving back its two runs' model-axis link bytes to
    1e-6 of their totals; (b) one rank on the card against ``meta``:
    ``DRYRUN_CELLS`` built on the card and counted in ``"observe"`` mode,
    then built on ``meta`` and simulated, at a (1, 1) mesh: FLOPs equal,
    argument bytes equal, the allocator's live bytes after the build
    those of the arguments' blocks (up to each large block's unsplit
    remainder), the predicted peak within ``PEAK_REL`` of the card's peak
    allocation around the call, danube's FLOPs within 1% of
    ``train_step_ops``, no collective; (c) the dry run
    of every arch's ``prefill_32k`` and ``decode_32k`` cells as rank 0 of
    the 16 x 16 mesh, each ``ok``, its per-rank peak beside the card's
    memory.  K2's layout constants that ``meta`` allocates by are held
    against the built libraries first."""
    from repro_torch.configs.base import ShapeConfig, get_config, list_configs
    from repro_torch.core.meshsig.counters import _storages, count_program
    from repro_torch.core.meshsig.validate import run_validation
    from repro_torch.kernels.mamba_scan import kernel as k2
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.parallel import context as ctx

    t_start = time.perf_counter()
    for n in k2.STATE_WIDTHS:
        check(k2.tiles(n)["time_chunk"] == k2.TIME_CHUNK, f"K2 forward's chunk at N = {n}")
        for di in (96, 8192):
            want = {"time_chunk": k2.TIME_CHUNK, "slices": k2.bwd_slices(di, n)}
            check(k2.bwd_layout(di, n) == want, f"K2 backward's layout at ({di}, {n})")

    # (a) the validation at full size
    t0 = time.perf_counter()
    rec = run_validation("llama3-8b", "train_4k", chip=h100_chip())
    validation_s = time.perf_counter() - t0
    refused = {k: m["error"] for k, m in rec["meshes"].items() if "error" in m}
    fit_gaps = {}
    for name, c in rec["fit_meshes_check"].items():
        total = sum(c["measured_axis_bytes"].values())
        fit_gaps[name] = {a: abs(c["predicted_axis_bytes"][a] - m) / total
                          for a, m in c["measured_axis_bytes"].items()}
    emit("dryrun_validation", arch=rec["arch"], shape=rec["shape"],
         class_fractions=rec["class_fractions"],
         errors_pct_of_total={k: m.get("error_pct_of_total", m.get("error"))
                              for k, m in rec["meshes"].items()},
         median_error_pct=rec["median_error_pct"], max_error_pct=rec["max_error_pct"],
         advisor_order=rec["advisor_order"], measured_order=rec["measured_order"],
         fit_meshes_rel_gap=fit_gaps, fit_profile_s=rec["fit_compile_s"],
         mesh_profile_s={k: m.get("compile_s") for k, m in rec["meshes"].items()},
         seconds=validation_s)
    check(not refused and len(rec["meshes"]) == 3, f"validation meshes refused: {refused}")
    check(np.isfinite(rec["median_error_pct"]), "the validation's median error is not finite")
    check(all(g["model"] <= 1e-6 for g in fit_gaps.values()),
          f"the fit does not give back its runs' model-axis link bytes: {fit_gaps}")

    # (b) one rank on the card against meta
    mesh = ctx.Mesh(("data", "model"), (1, 1), 0)
    for label, arch, cell in DRYRUN_CELLS:
        cfg, shape = get_config(arch), ShapeConfig(*cell)
        base = free_card() * 1e9
        with mesh_lib.cell_context(mesh, cfg, shape):
            fn, args, meta = dryrun.build_cell(cfg, shape, device="cuda")
            sync()
            torch.cuda.reset_peak_memory_stats()
            live = torch.cuda.memory_allocated() - base
            t0 = time.perf_counter()
            card = count_program(fn, *args, mode="observe")
            sync()
            card_s = time.perf_counter() - t0
            card_peak = torch.cuda.max_memory_allocated() - base
        arg_sizes = _storages(args, {}).values()
        arg_blocks = sum(-(-n // ALLOCATOR_BLOCK) * ALLOCATOR_BLOCK for n in arg_sizes)
        unsplit = ALLOCATOR_SMALL * sum(n > ALLOCATOR_SMALL for n in arg_sizes)
        del fn, args
        free_card()
        sim, sim_meta = dryrun.profile_cell(cfg, shape, mesh)
        predicted = sim.memory["argument_size_in_bytes"] + sim.memory["temp_size_in_bytes"]
        peak_gap = abs(predicted - card_peak) / card_peak
        ops = train_step_ops(cfg, shape.global_batch, shape.seq_len) \
            if shape.kind == "train" else None
        emit("dryrun_one_rank", cell=label, accum=meta.get("accum"),
             card_flops=card.flops, meta_flops=sim.flops, train_step_ops=ops,
             card_hbm_bytes=card.hbm_bytes, meta_hbm_bytes=sim.hbm_bytes,
             card_kernels=card.kernels, meta_kernels=sim.kernels,
             card_memory=card.memory, meta_memory=sim.memory, card_live_bytes=live,
             card_arg_blocks_bytes=arg_blocks, card_live_beyond_arg_blocks=live - arg_blocks,
             card_unsplit_limit_bytes=unsplit,
             card_peak_bytes=card_peak, predicted_peak_bytes=predicted,
             peak_rel_gap=peak_gap, card_collectives=len(card.collectives),
             meta_collectives=len(sim.collectives), card_profile_s=card_s,
             meta_profile_s=sim.seconds)
        check(card.flops == sim.flops, f"{label}: card FLOPs {card.flops}, meta {sim.flops}")
        check(sim.memory["argument_size_in_bytes"] == card.memory["argument_size_in_bytes"],
              f"{label}: argument bytes {sim.memory} against the card's {card.memory}")
        check(arg_blocks <= live <= arg_blocks + unsplit,
              f"{label}: the allocator holds {live} bytes after the build, the arguments' "
              f"blocks {arg_blocks} (+ up to {unsplit} unsplit)")
        check(peak_gap <= PEAK_REL, f"{label}: predicted peak {predicted} against the card's "
                                    f"{card_peak} (rel {peak_gap})")
        check(not card.collectives and not sim.collectives, f"{label}: collectives at one rank")
        if ops is not None:
            check(abs(sim.flops - ops) <= 0.01 * ops,
                  f"{label}: {sim.flops} FLOPs against train_step_ops' {ops}")

    # (c) the dry run's prefill and decode cells on the 16 x 16 mesh
    out_dir = ROOT / "build" / "chip_smoke_dryrun"
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    cells = {}
    for arch in list_configs():
        for shape_name in ("prefill_32k", "decode_32k"):
            r = dryrun.run_cell(arch, shape_name, "single", out_dir=out_dir, force=True)
            check(r["status"] == "ok", f"dry run {arch} {shape_name}: {r.get('error')}")
            cells[f"{arch} {shape_name}"] = dict(
                flops=r["flops"], link_bytes=r["collectives"]["link_bytes_total"],
                peak_bytes=dryrun.peak_bytes(r), share_of_card=dryrun.peak_bytes(r) / card_bytes,
                profile_s=r["profile_s"])
    shutil.rmtree(out_dir, ignore_errors=True)
    emit("dryrun", mesh="single 16 x 16, rank 0", card_bytes=card_bytes, cells=cells,
         nvidia_smi=nvidia_smi("name,power.limit"), phase_s=time.perf_counter() - t_start)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repository)

    smi = phase_device()
    phase_build()
    scan_row = phase_selective_scan()
    flash = phase_flash_attention()
    flash_bwd_row = {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "design": "wgmma+tma",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd_bf16.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:113",
        "gradient_of": "src/repro/models/attention.py:72 (XLA autodiff of blocked_attention)",
        **phase_flash_attention_backward(),
    }
    scan_bwd_row = phase_selective_scan_backward()
    mixer_rows = phase_mamba_mixer()
    phase_quickstart()
    phase_sweeps()
    phase_placement_search()
    phase_schedule_search()
    phase_service()
    phase_calibration()
    phase_meshsig()
    phase_service_resilience()
    phase_lm_reduced()
    phase_lm_reduced_train()
    phase_lm_danube()
    phase_lm_whisper()
    phase_lm_internvl2()
    flash_row = {
        "name": "flash_attention",
        "route": "cuda",
        "design": "wgmma+tma",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bf16.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:113",
        "launches": phase_lm_serve(),  # one llama3-8b prefill call (bf16)
        **flash,
    }
    # one falcon-mamba-7b prefill call
    scan_row["launches"], mixer_launches = phase_lm_falcon_mamba()
    for row in mixer_rows:
        row["launches"] = mixer_launches[row["name"]]
    danube = phase_lm_danube_train()
    flash_bwd_row["launches"] = danube["counts"]["k1_bwd"]  # one danube train step
    falcon = phase_lm_falcon_mamba_train()
    scan_bwd_row["launches"] = falcon["counts"]["k2_bwd"]  # one falcon (8 layers) step
    phase_lm_mesh()  # runs phase_lm_qwen3_moe once its long decode caches are freed
    phase_lm_mesh_train(danube, falcon)
    phase_dryrun()
    print(json.dumps({"kernels": [scan_row, flash_row, flash_bwd_row, scan_bwd_row, *mixer_rows]}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
