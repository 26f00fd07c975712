"""Load generator + CLI for the placement-advisor service (port of
``repro.launch.advisor_serve``).

Spins up an :class:`~repro_torch.serve.AdvisorService` on the chosen
device and drives a mixed query stream against it, printing the
per-tier metrics snapshot (counts, batch histogram, p50/p99 latency,
shape-retrace counter).  The stream mixes cache hits and sweep misses
on E7-4830 v3 at 24 threads with a ``--search-fraction`` of queries on
a 16-node SNC machine (8 sockets x 2 nodes, 32 threads), whose two
signatures are warmed first, so they are answered by the search tier
once and then from the cache.

    PYTHONPATH=src python -m repro_torch.launch.advisor_serve --device cuda \
        --queries 1000 --pool 32 --hit-fraction 0.8 --search-fraction 0.02 --workers 4

``--deadline-ms`` gives every query of the stream a deadline; past it
the answer comes off the degradation ladder (the snapshot's
``fidelity_counts`` and ``degraded_rate`` count those answers).
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


def drive_async(service: AdvisorService, queries) -> tuple[list, float]:
    """Open-loop load: submit the whole stream without waiting (concurrent
    misses coalesce into micro-batches), then wait for every future.
    ``queries`` is a list of ``(machine_or_handle, signature,
    n_threads)``.  Returns (advice list in query order, wall seconds)."""
    t0 = time.perf_counter()
    futures = [service.submit(m, sig, n) for (m, sig, n) in queries]
    results = [f.result() for f in futures]
    return results, time.perf_counter() - t0


def drive_threads(
    service: AdvisorService, queries, *, n_workers: int = 4,
    deadline_s: float | None = None,
) -> tuple[list, float]:
    """Closed-loop load: ``n_workers`` threads issue synchronous queries,
    each pulling the next query off a shared counter.  ``queries`` is a
    list of ``(machine_or_handle, signature, n_threads)``; ``deadline_s``
    bounds each query (None: the service's default).  Returns (advice
    list in query order, wall seconds)."""
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
                results[i] = service.query(machine, sig, n, deadline_s=deadline_s)
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
    search_sigs: list[QuerySignature] = (),
    search_target=None,
    hit_fraction: float = 0.8,
    search_fraction: float = 0.0,
    seed: int = 1,
) -> list[tuple]:
    """A deterministic shuffled stream mixing cache hits (drawn from
    ``pool``, assumed pre-answered), fresh sweep misses (consumed from
    ``fresh``) and search-tier queries (drawn from ``search_sigs``,
    assumed warmed) — the reference's stream.  ``*_target`` are
    ``(machine_or_handle, n_threads)``."""
    rng = np.random.default_rng(seed)
    fresh_iter = iter(fresh)
    stream: list[tuple] = []
    for _ in range(n_queries):
        roll = rng.random()
        if roll < search_fraction:
            sig = search_sigs[int(rng.integers(len(search_sigs)))]
            stream.append((search_target[0], sig, search_target[1]))
        elif roll < search_fraction + (1.0 - hit_fraction - search_fraction):
            sig = next(fresh_iter, None)
            if sig is None:  # fresh supply exhausted -> serve a hit instead
                sig = pool[int(rng.integers(len(pool)))]
            stream.append((sweep_target[0], sig, sweep_target[1]))
        else:
            sig = pool[int(rng.integers(len(pool)))]
            stream.append((sweep_target[0], sig, sweep_target[1]))
    return stream


def search_machine():
    """The 16-node SNC machine of the search-tier target: 8 sockets of 8
    cores, 2 NUMA nodes a socket, 25.6 GB/s QPI links."""
    from repro_torch.core.numa import make_machine

    return make_machine(
        "snc2-8s", sockets=8, cores_per_socket=8, nodes_per_socket=2,
        qpi_bw=25.6e9,
    )


def serve_stream(
    service: AdvisorService,
    n_queries: int,
    *,
    pool: int = 32,
    hit_fraction: float = 0.8,
    search_fraction: float = 0.02,
    workers: int = 4,
    deadline_s: float | None = None,
) -> dict:
    """Warm ``service`` (the sweep group's table and first batch, the hot
    set, and the search machine's two signatures when
    ``search_fraction > 0``), reset its metrics, drive the mixed stream
    (each query bounded by ``deadline_s`` when given) and return the
    metrics snapshot with the device, qps and wall time."""
    from repro_torch.core.numa import E7_4830_V3

    sweep_fp = service.register(E7_4830_V3)
    search_fp = service.register(search_machine())
    hot = signature_pool(pool, seed=0)
    fresh = signature_pool(n_queries, seed=7)
    search_sigs = signature_pool(2, seed=13)

    service.warmup(sweep_fp, 24)
    for sig in hot:  # pre-answer the hot set
        service.query(sweep_fp, sig, 24)
    if search_fraction > 0:
        for sig in search_sigs:
            service.query(search_fp, sig, 32)
    service.metrics.reset(keep_traces=True)

    stream = mixed_stream(
        hot, fresh, n_queries, sweep_target=(sweep_fp, 24),
        search_sigs=search_sigs, search_target=(search_fp, 32),
        hit_fraction=hit_fraction, search_fraction=search_fraction,
    )
    results, wall = drive_threads(service, stream, n_workers=workers, deadline_s=deadline_s)
    if any(r is None for r in results):
        raise RuntimeError("a query went unanswered")
    snap = service.metrics.snapshot()
    snap["device"] = str(service.device)
    snap["search_queries"] = sum(m == search_fp for m, _, _ in stream)
    snap["qps"] = round(len(stream) / wall, 1)
    snap["wall_s"] = round(wall, 3)
    return snap


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default="cuda",
                        help="torch device to serve on (cpu only on request)")
    parser.add_argument("--queries", type=int, default=1000)
    parser.add_argument("--pool", type=int, default=32,
                        help="distinct signatures in the hot (cached) set")
    parser.add_argument("--hit-fraction", type=float, default=0.8)
    parser.add_argument("--search-fraction", type=float, default=0.02,
                        help="share of queries on the 16-node search-tier machine")
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--max-batch", type=int, default=8)
    parser.add_argument("--max-wait-ms", type=float, default=2.0)
    parser.add_argument("--deadline-ms", type=float, default=None,
                        help="per-query deadline (ms); past it the answer "
                             "comes off the degradation ladder")
    parser.add_argument("--json", type=str, default=None,
                        help="write the metrics snapshot to this path")
    args = parser.parse_args()

    service = AdvisorService(
        device=args.device, max_batch=args.max_batch,
        max_wait_s=args.max_wait_ms / 1e3,
    )
    try:
        print("warming up (placement table, first batch, search answers)...")
        snap = serve_stream(
            service, args.queries, pool=args.pool, hit_fraction=args.hit_fraction,
            search_fraction=args.search_fraction, workers=args.workers,
            deadline_s=None if args.deadline_ms is None else args.deadline_ms / 1e3,
        )
        print(json.dumps(snap, indent=2))
        if args.json and args.json != "-":
            with open(args.json, "w") as fh:
                json.dump(snap, fh, indent=2)
            print(f"wrote {args.json}")
    finally:
        service.close()


if __name__ == "__main__":
    main()
