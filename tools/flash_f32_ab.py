"""Time K1's float32 forward from several source trees in one process, on
one card, in turns (A B ... B A per round), at the float32 shapes of
``chip_smoke.py``'s ``phase_flash_attention``: llama3-8b (4 x 2,048, dh
128, causal), gemma2-9b (1 x 8,192, dh 256, window 4,096, soft-cap 50) and
h2o-danube-1.8b (1 x 8,192, dh 80, window 4,096).

Each ``--tree LABEL=DIR`` names a ``csrc`` directory holding a
``flash_attention.cu`` with the C entry ``flash_attention_fwd``; the
wrapper loads it in place of the port's own.  Every tree's output is held
to the first tree's (atol = rtol = 2e-5).  One JSON line a case, then the
card's name and power limit:

    python tools/flash_f32_ab.py --tree before=scratch_tree/old/csrc \\
        --tree after=src/repro_torch/kernels/flash_attention/csrc
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

CASES = (
    # label, (B, H, Kv, S, dh), options, std of q and k
    ("llama3-8b prefill f32", (4, 32, 8, 2048, 128), {}, 1.0),
    ("gemma2-9b prefill f32", (1, 16, 8, 8192, 256), dict(window=4096, logit_cap=50.0), 5.0),
    ("h2o-danube-1.8b prefill f32", (1, 32, 8, 8192, 80), dict(window=4096), 1.0),
)


def cuda_ms(fn, iters: int) -> float:
    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def main() -> int:
    from repro_torch.kernels.flash_attention import kernel

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True, help="LABEL=csrc directory")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_f32_ab: CUDA is not available", file=sys.stderr)
        return 2
    trees = dict(t.split("=", 1) for t in args.tree)
    sources = {label: (ROOT / d / "flash_attention.cu").resolve() for label, d in trees.items()}
    order = list(sources) + list(reversed(sources))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for case, (B, H, Kv, S, dh), options, std in CASES:
        q = torch.randn((B, H, S, dh), generator=gen, device="cuda") * std
        k = torch.randn((B, Kv, S, dh), generator=gen, device="cuda") * std
        v = torch.randn((B, Kv, S, dh), generator=gen, device="cuda") * 0.5
        ms = {label: [] for label in sources}
        outs = {}
        for _ in range(args.rounds):
            for label in order:
                kernel.SOURCES[torch.float32] = sources[label]
                ms[label].append(cuda_ms(lambda: kernel.flash_attention(q, k, v, **options),
                                         args.iters))
                if label not in outs:
                    outs[label] = kernel.flash_attention(q, k, v, **options)
        first = outs[next(iter(sources))]
        agree = {label: float(((o - first).abs() / (2e-5 + 2e-5 * first.abs())).max())
                 for label, o in outs.items()}
        print(json.dumps({"case": case, "shape": dict(B=B, H=H, Kv=Kv, S=S, dh=dh),
                          "options": options, "ms": ms, "tolerance_used_vs_first": agree}),
              flush=True)
        del q, k, v, outs, first
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
