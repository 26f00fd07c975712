"""Fitting a bandwidth signature from two profiling runs — paper §5 (port
of ``repro.core.bwsig.fit``).

1. one symmetric and one asymmetric run of the same thread count (§5.1);
2. normalize bank counters by per-thread instruction rates (§5.2);
3. static socket and fraction from the symmetric run (§5.3);
4. local fraction from the symmetric run's remote ratio (§5.4);
5. per-thread fraction from the asymmetric run (§5.5).

Every function takes samples whose fields may carry leading batch
dimensions (the bank axis last), so one call fits a whole benchmark
batch — the reference's ``vmap``, written out.
"""

from __future__ import annotations

import torch

from repro_torch.core.bwsig.counters import CounterSample
from repro_torch.core.bwsig.signature import BandwidthSignature, DirectionSignature

_EPS = 1e-20


def _elapsed(sample: CounterSample) -> torch.Tensor:
    """``elapsed`` broadcastable against the bank axis."""
    e = sample.elapsed
    return e[..., None] if e.dim() else e


def _per_thread_rate(sample: CounterSample) -> torch.Tensor:
    """Average per-thread instruction rate per socket (paper §5.2)."""
    n = sample.n_per_socket.to(torch.float32)
    denom = torch.clamp(n * _elapsed(sample), min=_EPS)
    rate = sample.instructions / denom
    # an empty socket executed nothing: rate 1 makes division a no-op
    return torch.where(n > 0, rate, 1.0)


def _remote_source_weights(n_per_socket: torch.Tensor) -> torch.Tensor:
    """``w[..., j, i]``: fraction of bank ``j``'s remote counter sourced
    from socket ``i`` (exact for s == 2)."""
    n = n_per_socket.to(torch.float32)
    s = n.shape[-1]
    off = 1.0 - torch.eye(s, dtype=torch.float32, device=n.device)
    w = off * n[..., None, :]
    denom = torch.clamp(w.sum(dim=-1, keepdim=True), min=_EPS)
    return w / denom


def normalize_sample(sample: CounterSample, direction: str) -> dict[str, torch.Tensor]:
    """Paper §5.2: divide each bank counter by the average per-thread
    instruction rate of the socket the traffic was to or from."""
    rate = _per_thread_rate(sample)
    if direction == "read":
        local, remote = sample.local_read, sample.remote_read
    elif direction == "write":
        local, remote = sample.local_write, sample.remote_write
    else:
        raise ValueError(f"unknown direction {direction!r}")

    w = _remote_source_weights(sample.n_per_socket)
    local_n = local / torch.clamp(rate, min=_EPS)
    shares = w * remote[..., :, None]  # [bank j, source i]
    remote_n = (shares / torch.clamp(rate[..., None, :], min=_EPS)).sum(dim=-1)
    return {
        "local": local_n,
        "remote": remote_n,
        "source_weights": w,
        "n_per_socket": sample.n_per_socket,
    }


def fit_static(sym: dict[str, torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
    """Static socket = the bank moving the most data in the symmetric run;
    static fraction = its excess over the other banks' mean over the
    total (paper §5.3)."""
    totals = sym["local"] + sym["remote"]
    s = totals.shape[-1]
    static_socket = torch.argmax(totals, dim=-1).to(torch.int32)
    peak = torch.gather(totals, -1, static_socket[..., None].long())[..., 0]
    others_mean = (totals.sum(dim=-1) - peak) / max(s - 1, 1)
    total = torch.clamp(totals.sum(dim=-1), min=_EPS)
    static_fraction = torch.clamp((peak - others_mean) / total, 0.0, 1.0)
    return static_socket, static_fraction


def _onehot(static_socket: torch.Tensor, s: int) -> torch.Tensor:
    return torch.arange(s, device=static_socket.device) == static_socket[..., None]


def fit_local(
    sym: dict[str, torch.Tensor],
    static_socket: torch.Tensor,
    static_fraction: torch.Tensor,
) -> torch.Tensor:
    """Paper §5.4: with the static component removed, the remote ratio
    obeys ``r = (s-1)/s * (1 - local / (1 - static))``."""
    local, remote = sym["local"], sym["remote"]
    s = local.shape[-1]
    total = torch.clamp((local + remote).sum(dim=-1), min=_EPS)
    static_total = (static_fraction * total)[..., None]

    onehot = _onehot(static_socket, s)
    local = torch.where(onehot, local - static_total / s, local)
    remote = torch.where(onehot, remote - static_total * (s - 1) / s, remote)
    local = torch.clamp(local, min=0.0)
    remote = torch.clamp(remote, min=0.0)

    r_per_bank = remote / torch.clamp(local + remote, min=_EPS)
    r = r_per_bank.mean(dim=-1)
    frac = 1.0 - r * s / (s - 1)
    local_fraction = frac * (1.0 - static_fraction)
    return torch.minimum(
        torch.clamp(local_fraction, min=0.0), 1.0 - static_fraction
    )


def fit_per_thread(
    asym: dict[str, torch.Tensor],
    static_socket: torch.Tensor,
    static_fraction: torch.Tensor,
    local_fraction: torch.Tensor,
) -> torch.Tensor:
    """Paper §5.5: disambiguate Per-thread from Interleaved using the
    asymmetric run."""
    local, remote = asym["local"], asym["remote"]
    w = asym["source_weights"]
    n = asym["n_per_socket"].to(torch.float32)
    s = local.shape[-1]
    sf = static_fraction[..., None]
    lf = local_fraction[..., None]

    # per-CPU demand: local traffic plus its share of other banks' remote
    per_cpu = local + (w * remote[..., :, None]).sum(dim=-2)

    onehot = _onehot(static_socket, s)
    onehot_f = onehot.to(torch.float32)
    remote_static = sf * ((1.0 - onehot_f) * per_cpu).sum(dim=-1, keepdim=True)
    local_static = sf * (onehot_f * per_cpu).sum(dim=-1, keepdim=True)
    remote = torch.where(onehot, remote - remote_static, remote)
    local = torch.where(onehot, local - local_static, local)

    # remove each CPU's thread-local traffic from its own bank
    local = local - lf * per_cpu
    local = torch.clamp(local, min=0.0)
    remote = torch.clamp(remote, min=0.0)

    remote_from_cpu = (w * remote[..., :, None]).sum(dim=-2)
    l_measured = local / torch.clamp(local + remote_from_cpu, min=_EPS)

    used = (n > 0).to(torch.float32)
    s_used = torch.clamp(used.sum(dim=-1, keepdim=True), min=1.0)
    pt_expect = n / torch.clamp(n.sum(dim=-1, keepdim=True), min=_EPS)
    il_expect = used / s_used

    # least squares for l = PT*p + IL*(1-p) over sockets
    active = used * torch.where(local + remote_from_cpu > _EPS, 1.0, 0.0)
    dx = (pt_expect - il_expect) * active
    dy = (l_measured - il_expect) * active
    p = (dx * dy).sum(dim=-1) / torch.clamp((dx * dx).sum(dim=-1), min=_EPS)
    p = torch.clamp(p, 0.0, 1.0)

    per_thread = p * (1.0 - local_fraction - static_fraction)
    return torch.clamp(per_thread, 0.0, 1.0)


def fit_direction(
    sym_sample: CounterSample, asym_sample: CounterSample, direction: str
) -> DirectionSignature:
    """Fit one direction's 4 properties from the two profiling runs."""
    sym = normalize_sample(sym_sample, direction)
    asym = normalize_sample(asym_sample, direction)
    static_socket, static_fraction = fit_static(sym)
    local_fraction = fit_local(sym, static_socket, static_fraction)
    per_thread = fit_per_thread(asym, static_socket, static_fraction, local_fraction)
    return DirectionSignature(
        static_socket=static_socket,
        static_fraction=static_fraction,
        local_fraction=local_fraction,
        per_thread_fraction=per_thread,
    )


def fit_signature(
    sym_sample: CounterSample,
    asym_sample: CounterSample,
    *,
    combined: bool = False,
) -> BandwidthSignature:
    """Fit the full 8-property signature (paper §5).  ``combined=True``
    merges reads and writes first and uses one direction signature for
    both slots (§6.2.1)."""
    if combined:
        sym_sample = sym_sample.combined()
        asym_sample = asym_sample.combined()
        d = fit_direction(sym_sample, asym_sample, "read")
        return BandwidthSignature(read=d, write=d)
    return BandwidthSignature(
        read=fit_direction(sym_sample, asym_sample, "read"),
        write=fit_direction(sym_sample, asym_sample, "write"),
    )
