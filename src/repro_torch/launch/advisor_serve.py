"""Load generator + CLI for the placement-advisor service (port of
``repro.launch.advisor_serve``).

Spins up an :class:`~repro_torch.serve.AdvisorService` on the chosen
device and drives a mixed query stream against it, printing the
per-tier metrics snapshot (counts, batch histogram, p50/p99 latency,
shape-retrace counter).  Until the search tier is ported the stream
targets the sweep tier only: E7-4830 v3 at 24 threads (the reference's
``--search-fraction`` is fixed at 0).

    PYTHONPATH=src python -m repro_torch.launch.advisor_serve --device cuda \
        --queries 1000 --pool 32 --hit-fraction 0.8 --workers 4
"""

from __future__ import annotations

import argparse
import itertools
import json
import threading
import time

import numpy as np

from repro_torch.serve import AdvisorService, QuerySignature


def signature_pool(
    n: int,
    *,
    read_bpi: float = 0.6,
    write_bpi: float = 0.2,
    seed: int = 0,
) -> list[QuerySignature]:
    """``n`` deterministic distinct workload signatures (Dirichlet mixes,
    interleaved takes the 4th share, scaled under 1, rounded) — the same
    signatures as the reference's pool for the same seed."""
    rng = np.random.default_rng(seed)
    sigs = []
    for _ in range(n):
        read = rng.dirichlet(np.ones(4))[:3] * 0.9
        write = rng.dirichlet(np.ones(4))[:3] * 0.9
        sigs.append(
            QuerySignature(
                tuple(round(float(v), 4) for v in read),
                tuple(round(float(v), 4) for v in write),
                read_bpi,
                write_bpi,
            )
        )
    return sigs


def drive_threads(
    service: AdvisorService, queries, *, n_workers: int = 4
) -> tuple[list, float]:
    """Closed-loop load: ``n_workers`` threads issue synchronous queries,
    each pulling the next query off a shared counter.  ``queries`` is a
    list of ``(machine_or_handle, signature, n_threads)``.  Returns
    (advice list in query order, wall seconds)."""
    results: list = [None] * len(queries)
    counter = itertools.count()
    errors: list[BaseException] = []

    def worker() -> None:
        try:
            while True:
                i = next(counter)
                if i >= len(queries):
                    return
                machine, sig, n = queries[i]
                results[i] = service.query(machine, sig, n)
        except BaseException as exc:  # surfaced to the caller below
            errors.append(exc)

    threads = [
        threading.Thread(target=worker, name=f"advisor-load-{w}")
        for w in range(n_workers)
    ]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return results, wall


def mixed_stream(
    pool: list[QuerySignature],
    fresh: list[QuerySignature],
    n_queries: int,
    *,
    sweep_target,
    hit_fraction: float = 0.8,
    seed: int = 1,
) -> list[tuple]:
    """A deterministic shuffled stream mixing cache hits (drawn from
    ``pool``, assumed pre-answered) and fresh sweep misses (consumed from
    ``fresh``) against ``sweep_target = (machine_or_handle, n_threads)``
    — the reference's stream with ``search_fraction=0``."""
    rng = np.random.default_rng(seed)
    fresh_iter = iter(fresh)
    stream: list[tuple] = []
    for _ in range(n_queries):
        roll = rng.random()
        if roll < 1.0 - hit_fraction:
            sig = next(fresh_iter, None)
            if sig is None:  # fresh supply exhausted -> serve a hit instead
                sig = pool[int(rng.integers(len(pool)))]
        else:
            sig = pool[int(rng.integers(len(pool)))]
        stream.append((sweep_target[0], sig, sweep_target[1]))
    return stream


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default="cuda",
                        help="torch device to serve on (cpu only on request)")
    parser.add_argument("--queries", type=int, default=1000)
    parser.add_argument("--pool", type=int, default=32,
                        help="distinct signatures in the hot (cached) set")
    parser.add_argument("--hit-fraction", type=float, default=0.8)
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--max-batch", type=int, default=8)
    parser.add_argument("--max-wait-ms", type=float, default=2.0)
    parser.add_argument("--json", type=str, default=None,
                        help="write the metrics snapshot to this path")
    args = parser.parse_args()

    from repro_torch.core.numa import E7_4830_V3

    service = AdvisorService(
        device=args.device, max_batch=args.max_batch,
        max_wait_s=args.max_wait_ms / 1e3,
    )
    try:
        sweep_fp = service.register(E7_4830_V3)
        pool = signature_pool(args.pool, seed=0)
        fresh = signature_pool(args.queries, seed=7)

        print("warming up (placement table + first batch)...")
        service.warmup(sweep_fp, 24)
        for sig in pool:  # pre-answer the hot set
            service.query(sweep_fp, sig, 24)
        service.metrics.reset(keep_traces=True)

        stream = mixed_stream(
            pool, fresh, args.queries, sweep_target=(sweep_fp, 24),
            hit_fraction=args.hit_fraction,
        )
        results, wall = drive_threads(service, stream, n_workers=args.workers)
        if any(r is None for r in results):
            raise RuntimeError("a query went unanswered")

        snap = service.metrics.snapshot()
        snap["device"] = str(service.device)
        snap["qps"] = round(len(stream) / wall, 1)
        snap["wall_s"] = round(wall, 3)
        print(json.dumps(snap, indent=2))
        if args.json and args.json != "-":
            with open(args.json, "w") as fh:
                json.dump(snap, fh, indent=2)
            print(f"wrote {args.json}")
    finally:
        service.close()


if __name__ == "__main__":
    main()
