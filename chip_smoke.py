"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from the sources in this checkout and
drives the port's paths on ``cuda`` in phases, one JSON line each:

1. device — the card, its power limit and the float32 matmul settings;
2. build — nvcc of every kernel source (all started together);
3. selective_scan — the mamba-1 scan through ``ssm_scan`` at falcon-mamba-7b
   width (B=2, S=2048, d_inner=8192, N=16), held against the plain version;
4. quickstart — profile_pair -> fit_signature -> predict_counters on the
   E5-2699 v3 (the paper's pipeline; error < 5%);
5. sweeps — the three placement sweeps through ``evaluate_batch``, noisy
   median error against the committed values, placements/s, and the
   noise-free sweep held against the same code on the CPU;
6. service — the advisor service on E7-4830 v3 at 24 threads: batch tier,
   cache tier, a mixed stream, answers held against the CPU, concurrent
   answers held against serial ones.

Then one line listing every kernel of the port with its launches, error
and times, the card's name and power limit as nvidia-smi prints them,
and, last, ``{"ok": true, "device": {...}}``.  Any failed check exits
non-zero before the last line; nothing is caught.  Without CUDA, or
without the repository's ``src/`` beside it, it exits non-zero at once.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA's H100 datasheet): HBM bytes/s and
# float32 (no tensor core) operations/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

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
    """Mean milliseconds of ``fn`` over ``iters`` calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def device_profile(fn) -> dict:
    """Where one call of ``fn`` spends its time: the host wall time (best
    of three unprofiled calls, each ending in a synchronise), the device
    time of the kernels one profiled call launched (the union of their
    intervals, from ``torch.profiler``), the device's busy share of the
    wall time, the three kernels with the most device time, and the
    host's most frequent CUDA runtime calls (launches, synchronisations,
    copies)."""
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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events()
        if e.device_type == DeviceType.CUDA
    )
    busy_us, end, per_name = 0.0, float("-inf"), {}
    for start, stop, name in spans:
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
        ms, count = per_name.get(name, (0.0, 0))
        per_name[name] = (ms + (stop - start) / 1e3, count + 1)
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:3]
    runtime = Counter(
        e.name for e in prof.events()
        if e.device_type == DeviceType.CPU and e.name.startswith("cuda")
    )
    device_ms = busy_us / 1e3 if spans else None
    return {
        "wall_ms": wall_ms,
        "device_ms": device_ms,
        "busy_share": device_ms / wall_ms if spans else None,
        "device_ops": len(spans),
        "top_kernels": [
            {"name": name[:80], "ms": ms, "count": count} for name, (ms, count) in top
        ],
        "runtime_calls": dict(runtime.most_common(5)),
    }


# ---------------------------------------------------------------------------


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
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


def phase_build() -> None:
    from repro_torch.kernels import build
    from repro_torch.kernels.mamba_scan import kernel as scan_kernel

    sources = [scan_kernel.SOURCE]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = list(pool.map(build.build, sources))
    seconds = time.perf_counter() - t0
    for lib in libs:
        check(lib.exists(), f"{lib} was not built")
    emit(
        "build",
        seconds=round(seconds, 3),
        libraries=[str(p.relative_to(ROOT)) for p in libs],
        ptxas=[line for s in sources for line in build.BUILD_LOGS.get(s.name, "").splitlines()
               if "ptxas" in line],
    )


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


def phase_selective_scan() -> dict:
    from repro_torch.kernels.mamba_scan.kernel import selective_scan
    from repro_torch.kernels.mamba_scan.ops import ssm_scan
    from repro_torch.kernels.mamba_scan.ref import selective_scan_ref

    B, S, di, n = 2, 2048, 8192, 16
    dt, a, b, c, x = scan_inputs(B, S, di, n, 0, "cuda")

    # the path run: counts from zero, read right after
    selective_scan.launches = 0
    y = ssm_scan(dt, a, b, c, x)
    sync()
    launches = selective_scan.launches
    check(launches > 0, "ssm_scan did not launch the CUDA kernel")

    want, _ = selective_scan_ref(dt, a, b, c, x)
    sync()
    diff = (y - want).abs()
    max_abs = float(diff.max())
    max_rel = max_abs / float(want.abs().max())
    check(bool(torch.isfinite(y).all()), "scan output is not finite")
    check(bool((diff <= 1e-4 + 1e-4 * want.abs()).all()),
          f"scan disagrees with the plain version: max abs {max_abs}")

    # bf16 inputs through the public wrapper, against the plain scan of the
    # same bf16-rounded inputs
    bf = [t.to(torch.bfloat16) for t in (dt, b, c, x)]
    y16 = ssm_scan(bf[0], a, bf[1], bf[2], bf[3])
    want16, _ = selective_scan_ref(*(t.float() for t in bf[:1]), a,
                                   *(t.float() for t in bf[1:]))
    sync()
    diff16 = (y16 - want16).abs()
    check(bool((diff16 <= 2e-2 + 2e-2 * want16.abs()).all()),
          f"bf16 scan disagrees: max abs {float(diff16.max())}")

    for _ in range(3):
        selective_scan(dt, a, b, c, x)
    kernel_ms = cuda_ms(lambda: selective_scan(dt, a, b, c, x), 20)
    selective_scan_ref(dt, a, b, c, x)
    plain_ms = cuda_ms(lambda: selective_scan_ref(dt, a, b, c, x), 2)

    elems = B * S * di
    bytes_moved = 4 * (3 * elems + 2 * B * S * n + di * n)  # dt, x, y, b, c, a
    ops = 7 * elems * n + elems  # per (b,t,d,n): dt*a, exp, *h, *b, +, *c, +
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    row = {
        "name": "selective_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/mamba_scan/csrc/selective_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan/kernel.py:61",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,  # no single PyTorch call computes the scan
    }
    emit(
        "selective_scan",
        shape=[B, S, di, n],
        max_abs_err=max_abs,
        max_rel_err=max_rel,
        bf16_max_abs_err=float(diff16.max()),
        launches=launches,
        kernel_ms=kernel_ms,
        plain_ms=plain_ms,
        bound_ms=row["bound_ms"],
        bytes_bound_ms=bytes_ms,
        ops_bound_ms=ops_ms,
    )
    return row


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repository)

    smi = phase_device()
    phase_build()
    scan_row = phase_selective_scan()
    phase_quickstart()
    phase_sweeps()
    phase_service()
    print(json.dumps({"kernels": [scan_row]}), flush=True)
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
