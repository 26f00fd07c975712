"""The benchmark's yardstick: the published peaks of one H100 and the
operations and bytes that a cell's shapes need.

Everything here counts the *model's* work, never what an implementation
issues: a training step counts its forward's products three times (the
backward's two) and attention 1 + 2.5 times its forward, and a layer
group's recomputed forward counts as time but never as work.  So a
change that drops or changes the recompute reads as less time for the
same work.  The rules for K1 and K2 are those the port's kernels state
for themselves (copied here, so that a later change to the program cannot
move the yardstick).
"""

from __future__ import annotations

import functools
import importlib
from dataclasses import dataclass

import numpy as np

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W limit
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


@functools.lru_cache(maxsize=256)
def attention_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """The (row, col) pairs one (batch, head) of attention must compute:
    those its mask leaves visible, rows right-aligned (row ``r`` at
    position ``r + skv - sq``), a window of ``window`` keys ending at the
    row's own (0: no window)."""
    rows = np.arange(sq) + (skv - sq)
    hi = np.minimum(rows + 1, skv) if causal else np.full(sq, skv)
    lo = np.maximum(rows - window + 1, 0) if window else np.zeros(sq, np.int64)
    return int(np.clip(hi - lo, 0, None).sum())


@dataclass(frozen=True)
class Work:
    """Operations, bytes and the peak rate of one piece of work."""

    ops: float
    nbytes: float
    peak: float = BF16_OPS_PER_S

    @property
    def ops_s(self) -> float:
        return self.ops / self.peak

    @property
    def bytes_s(self) -> float:
        return self.nbytes / HBM_BYTES_PER_S

    @property
    def least_s(self) -> float:
        """The least time the card could take: the larger of the two."""
        return max(self.ops_s, self.bytes_s)

    @property
    def bound(self) -> str:
        return "operations" if self.ops_s >= self.bytes_s else "bytes"


def flash_fwd(B: int, H: int, kv: int, sq: int, skv: int, dh: int, *, window: int,
              itemsize: int = 2, lse: bool = False) -> Work:
    """K1's forward: 4 dh operations per visible pair (QK^T and PV); q,
    k and v read and o written once (and the float32 log-sum-exp)."""
    ops = 4 * dh * B * H * attention_pairs(sq, skv, True, window)
    qb, kb = B * H * sq * dh * itemsize, B * kv * skv * dh * itemsize
    return Work(float(ops), 2 * qb + 2 * kb + (4 * B * H * sq if lse else 0))


def flash_bwd(B: int, H: int, kv: int, sq: int, skv: int, dh: int, *, window: int,
              itemsize: int = 2) -> Work:
    """K1's backward: 2.5 times the forward's operations; q, k, v, o, dO
    and the log-sum-exp read, dq, dk and dv written."""
    ops = 2.5 * 4 * dh * B * H * attention_pairs(sq, skv, True, window)
    qb, kb = B * H * sq * dh * itemsize, B * kv * skv * dh * itemsize
    return Work(ops, 4 * qb + 4 * kb + 4 * B * H * sq)


def scan_fwd(B: int, S: int, di: int, n: int) -> Work:
    """K2's forward as a function: 7 operations per (b, t, d, n) and one
    per (b, t, d) on the CUDA cores; dt, x, b, c and a read and y written,
    float32."""
    elems = B * S * di
    return Work(float(7 * elems * n + elems), float(4 * (3 * elems + 2 * B * S * n + di * n)),
                F32_OPS_PER_S)


def scan_bwd(B: int, S: int, di: int, n: int) -> Work:
    """K2's backward as a function: 26 operations per (b, t, d, n); dt,
    x and dy read and ddt and dx written, b and c read and db and dc
    written, a read and da written, float32."""
    nbytes = 4 * (5 * B * S * di + 4 * B * S * n + 2 * di * n)
    return Work(float(26 * B * S * di * n), float(nbytes), F32_OPS_PER_S)


def gemm(m: int, k: int, n: int, itemsize: int = 2) -> Work:
    """One product (m, k) x (k, n): 2 m k n operations; both operands read
    and the result written once."""
    return Work(2.0 * m * k * n, float(itemsize * (m * k + k * n + m * n)))


# ---------------------------------------------------------------------------
# A model's work, from its configuration file's numbers and its family
# ---------------------------------------------------------------------------


def padded_vocab(cfg: dict) -> int:
    return -(-cfg["vocab_size"] // 256) * 256


def family(cfg: dict):
    """The module ``portbench/families/<family>.py`` of the configuration's
    family, which states the products of one layer and its kernels' work;
    a family without one has no yardstick, and is refused."""
    name = f"portbench.families.{cfg['family']}"
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise ValueError(f"family {cfg['family']!r} has no module {name}: its work "
                         f"is not counted") from None


def prefill_work(cfg: dict, B: int, S: int) -> dict[str, list[Work]]:
    """The model's work for one prefill of ``B`` prompts of ``S`` tokens,
    by kernel class: every layer product at every position, the lm_head
    at the last position only (as ``prefill`` computes it), and the
    family's kernels' forwards (K1 once an attention layer, K2 once a
    mamba layer)."""
    fam = family(cfg)
    gemms = [gemm(B * S, k, n) for _ in range(cfg["n_layers"]) for _, k, n in fam.products(cfg)]
    gemms.append(gemm(B, cfg["d_model"], padded_vocab(cfg)))
    return {"gemm": gemms, **fam.prefill_kernels(cfg, B, S)}


def train_work(cfg: dict, micro: int, S: int, accum: int) -> dict[str, list[Work]]:
    """The model's work for one optimizer step of ``accum`` micro-batches
    of ``micro`` sequences of ``S`` tokens: each product forward and its
    two backward products (the input's and the weight's gradient), the
    lm_head at every position, and the family's kernels' forwards and
    backwards, once a micro-batch.  The layer groups' recomputed forward
    is not counted: it is the implementation's work, not the model's."""
    fam = family(cfg)
    m = micro * S
    one = [(k, n) for _ in range(cfg["n_layers"]) for _, k, n in fam.products(cfg)]
    one.append((cfg["d_model"], padded_vocab(cfg)))
    gemms = [w for k, n in one for w in (gemm(m, k, n), gemm(m, n, k), gemm(k, m, n))]
    kernels = fam.train_kernels(cfg, micro, S)
    return {"gemm": gemms * accum, **{c: ws * accum for c, ws in kernels.items()}}


def model_ops(work: dict[str, list[Work]]) -> float:
    """The operations ``mfu`` counts: those of work at the bf16 peak, the
    products' and attention's (the scan's elementwise operations, counted
    at the float32 peak, are no tensor-core work and are left out)."""
    return sum(w.ops for ws in work.values() for w in ws if w.peak == BF16_OPS_PER_S)


def least_s(works: list[Work]) -> float:
    return sum(w.least_s for w in works)


def bound_of(works: list[Work]) -> str:
    """Which bound holds most of a class's least time."""
    ops = sum(w.least_s for w in works if w.bound == "operations")
    return "operations" if ops >= least_s(works) / 2 else "bytes"
