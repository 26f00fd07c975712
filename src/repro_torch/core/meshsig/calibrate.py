"""Link-bandwidth calibration of a device mesh — the inverse problem of
:class:`~repro_torch.core.meshsig.device_topology.DeviceTopology` (port of
``repro.core.meshsig.calibrate``).

A ``DeviceTopology`` gives the advisor a routed forward model
``t = max_l bytes_l / bw_l`` (the most-loaded directed link).  This module
recovers the per-link bandwidths from measured collective times, with
the recipe of :mod:`repro_torch.core.numa.calibrate`:

1. **Probe design** (:func:`probe_suite`) — one collective-permute per
   directed link between adjacent devices (a one-hop route charges
   exactly that link, so its time *is* ``bytes / bw``), plus ring probes
   over whole axis groups that drive several links at once, as real
   steps do.
2. **Closed-form seeding** (:func:`seed_link_bw`) — every sample
   lower-bounds each charged link's capacity by ``bytes_l / t``; the
   permute probes make the bound tight, so on clean data the seed alone
   round-trips.
3. **AdamW in log space** (:func:`fit_device_topology`) — the
   :class:`~repro_torch.core.graphtop.LinkGroups` packing ties links of
   one class (a torus axis, the glue links of a multi-host ring), and a
   loop of autograd steps through ``optim.adamw.update_`` minimizes the
   squared relative time error through the max.  The max's gradient is
   ``amax``'s, which splits a tie evenly over the tied links as JAX's
   reduction does (ties are the rule on a uniform template).  The loop
   runs on the samples' device with its link index built there once and
   its losses kept there: one host copy per fit.

The fitted graph is rebuilt with :func:`~repro_torch.core.graphtop.from_fit`
(routes held static; only capacities are free parameters).

Samples are float32 tensors on one device; probe design, seeding and the
fitted graph are float64 numpy, as in the reference.  Noisy sweeps take
their standard-normal draws as a tensor or draw them from a
``torch.Generator`` (the reference draws from ``jax.random`` keys).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.core.graphtop import LinkGroups, from_fit, link_groups
from repro_torch.core.meshsig.device_topology import DeviceTopology
from repro_torch.optim import adamw

_EPS = 1e-9
_F32 = torch.float32


class CollectiveSamples(NamedTuple):
    """A calibration sweep: ``P`` measured collective runs, on one device.

    ``charges[p]`` is the known per-directed-link byte vector of run ``p``
    (slot ``2l`` = link ``l`` low->high, ``2l + 1`` reverse — computed
    from the run's collective schedule by
    :meth:`DeviceTopology.link_loads`, NOT measured); ``times[p]`` is the
    measured wall time of the run's collective phase."""

    charges: torch.Tensor  # (P, 2 * n_links) float32
    times: torch.Tensor  # (P,) float32 seconds

    @property
    def n_samples(self) -> int:
        return int(self.charges.shape[0])

    @property
    def device(self) -> torch.device:
        return self.charges.device

    def to(self, device) -> "CollectiveSamples":
        """The same samples on ``device``."""
        dev = resolve_device(device)
        return CollectiveSamples(self.charges.to(dev), self.times.to(dev))


class MeshCalibrationResult(NamedTuple):
    topology: DeviceTopology  # fitted (concrete, validated graph)
    link_bw: np.ndarray  # (n_links,) fitted bytes/s
    groups: LinkGroups
    loss_history: np.ndarray  # (steps,)
    seed_loss: float
    final_loss: float


# ---------------------------------------------------------------------------
# Probe design + synthetic collection
# ---------------------------------------------------------------------------


def probe_suite(
    template: DeviceTopology,
    *,
    probe_bytes: float = 1e9,
    axis_sizes_list: Sequence[dict[str, int]] = (),
) -> np.ndarray:
    """``(P, 2L)`` charge vectors of the designed sweep.

    Per-directed-link permute probes identify every link exactly; the
    optional axis-ring probes (one per candidate in ``axis_sizes_list``,
    charging ``probe_bytes`` per device on every axis) add multi-link
    samples."""
    L = template.graph.n_links
    rows: list[np.ndarray] = []
    for slot in range(2 * L):
        v = np.zeros((2 * L,), np.float64)
        v[slot] = probe_bytes
        rows.append(v)
    for axes in axis_sizes_list:
        rows.append(template.link_loads(axes, {a: probe_bytes for a in axes}))
    return np.stack(rows)


def collect_samples(
    truth: DeviceTopology,
    charges: np.ndarray,
    *,
    noise_std: float = 0.0,
    noise=None,
    generator: torch.Generator | None = None,
    device=DEFAULT_DEVICE,
) -> CollectiveSamples:
    """Run a charge sweep through the forward model of a ground-truth
    topology (the synthetic round trip; measured traces package their
    times with the same schedule-derived charges instead), on ``device``.

    With ``noise_std > 0`` each time is scaled by
    ``max(1 + noise_std * z, 0.05)``, ``z`` one standard-normal draw per
    sample: ``noise`` holds the ``(P,)`` draws, else they come from
    ``generator``; one of the two is required."""
    dev = resolve_device(device)
    charges = np.asarray(charges, np.float64)
    slot_bw = np.repeat(np.asarray(truth.graph.link_bw, np.float64), 2)
    times = (charges / slot_bw).max(axis=1)
    if noise_std > 0.0:
        if noise is None:
            if generator is None:
                raise ValueError("noise_std > 0 needs the draws (noise=) or a generator")
            noise = torch.randn(
                (len(times),), generator=generator, device=generator.device, dtype=_F32
            )
        if isinstance(noise, torch.Tensor):
            noise = noise.detach().cpu().numpy()
        # the reference's draws are float32: scale them in float32 too
        noise = np.asarray(noise, np.float32).reshape(len(times))
        times = times * np.clip(1.0 + noise_std * noise, 0.05, None)
    return CollectiveSamples(
        charges=torch.as_tensor(charges.astype(np.float32), device=dev),
        times=torch.as_tensor(times.astype(np.float32), device=dev),
    )


# ---------------------------------------------------------------------------
# Stage 1: closed-form seeding
# ---------------------------------------------------------------------------


def seed_link_bw(template: DeviceTopology, samples: CollectiveSamples) -> np.ndarray:
    """``(n_links,)`` seeds: ``t >= bytes_l / bw_l`` for every charged
    link, so ``bytes_l / t`` lower-bounds ``bw_l``; the permute probes
    make the best bound tight.  Links no sample drives keep the
    template's value (nothing observed: keep the prior)."""
    charges = samples.charges.cpu().numpy().astype(np.float64)  # (P, 2L)
    times = samples.times.cpu().numpy().astype(np.float64)[:, None]
    bounds = charges / np.maximum(times, _EPS)  # (P, 2L)
    per_slot = bounds.max(axis=0)
    per_link = np.maximum(per_slot[0::2], per_slot[1::2])
    prior = np.asarray(template.graph.link_bw, np.float64)
    return np.where(per_link > 0.0, per_link, prior)


# ---------------------------------------------------------------------------
# Stage 2: AdamW refinement through the max-link forward model
# ---------------------------------------------------------------------------


def _link_index(groups: LinkGroups, device) -> torch.Tensor:
    """``(2 * n_links,)`` parameter id of every directed slot, on
    ``device``: ``groups.unpack`` then the two directions, as one gather."""
    return torch.as_tensor(np.repeat(groups.link_index(), 2), dtype=torch.long, device=device)


def _time_loss(slot_index: torch.Tensor, samples: CollectiveSamples, log_bw: torch.Tensor):
    """Mean squared relative error of the max-link time model over the
    samples, at per-group bandwidths ``exp(log_bw)``."""
    slot_bw = torch.exp(log_bw)[slot_index]  # (2L,)
    pred = (samples.charges / slot_bw).amax(dim=1)  # (P,)
    rel = (pred - samples.times) / torch.clamp_min(samples.times, _EPS)
    return (rel**2).mean()


def _fit_step(slot_index, samples, p: dict, state, lr):
    """One AdamW step from ``p["log_bw"]``, updated in place: ``(loss at
    p, updated state)``."""
    leaf = p["log_bw"].detach().requires_grad_()
    loss = _time_loss(slot_index, samples, leaf)
    (grad,) = torch.autograd.grad(loss, leaf)
    state = adamw.update_({"log_bw": grad}, state, p, lr=lr, weight_decay=0.0)
    return loss.detach(), state


def _fit_loop(slot_index, samples, log_bw, steps: int, lr: float):
    """``steps`` AdamW steps from ``log_bw``: the fitted log bandwidths,
    the loss before each update and the loss after the last, all on the
    samples' device (no host sync in the loop)."""
    schedule = adamw.cosine_schedule(
        lr, warmup_steps=min(20, max(steps // 10, 1)), total_steps=steps
    )
    p = {"log_bw": log_bw.detach().clone()}  # updated in place
    state = adamw.init(p)
    history = []
    for _ in range(steps):
        # the reference reads the schedule at the step before the update
        loss, state = _fit_step(slot_index, samples, p, state, schedule(state.step))
        history.append(loss)
    with torch.no_grad():
        final_loss = _time_loss(slot_index, samples, p["log_bw"])
    empty = torch.zeros((0,), dtype=_F32, device=log_bw.device)
    return p["log_bw"], torch.stack(history) if history else empty, final_loss


def fit_device_topology(
    template: DeviceTopology,
    samples: CollectiveSamples,
    *,
    tie_equal_bw: bool = False,
    groups: LinkGroups | None = None,
    steps: int = 200,
    lr: float = 0.05,
    name: str | None = None,
    device=DEFAULT_DEVICE,
) -> MeshCalibrationResult:
    """Fit per-link bandwidths from a collective sweep, on ``device`` (the
    samples are moved there).

    ``template`` supplies structure only (link list, routes, charging
    policy); its bandwidth values seed un-driven links and are otherwise
    not consulted.  ``tie_equal_bw`` shares one parameter across links
    the template marks as one class by equal bandwidths (a torus axis,
    the glue links of a multi-host ring); see
    :func:`~repro_torch.core.graphtop.link_groups`."""
    samples = samples.to(device)
    if samples.charges.shape[1] != 2 * template.graph.n_links:
        raise ValueError(
            f"samples charge {samples.charges.shape[1]} directed slots; "
            f"template has {2 * template.graph.n_links}"
        )
    if groups is None:
        groups = link_groups(template.graph, tie_equal_bw=tie_equal_bw)
    seed = seed_link_bw(template, samples)
    slot_index = _link_index(groups, samples.device)
    log_bw = torch.log(
        torch.as_tensor(groups.pack(seed).astype(np.float32), device=samples.device)
    )
    with torch.no_grad():
        seed_loss = float(_time_loss(slot_index, samples, log_bw))
    fitted_log, history, final_loss = _fit_loop(
        slot_index, samples, log_bw, int(steps), float(lr)
    )
    link_bw = np.asarray(
        groups.unpack(np.exp(fitted_log.cpu().numpy().astype(np.float64)))
    )
    graph = from_fit(template.graph, link_bw, name=name or f"{template.graph.name}-fit")
    return MeshCalibrationResult(
        topology=DeviceTopology(graph=graph, multipath=template.multipath),
        link_bw=link_bw,
        groups=groups,
        loss_history=history.cpu().numpy(),
        seed_loss=seed_loss,
        final_loss=float(final_loss),
    )


def blind_template(truth: DeviceTopology) -> DeviceTopology:
    """``truth``'s structure with every link at the mean of its
    bandwidths: what a fit knows before it sees samples."""
    mean_bw = float(np.mean(truth.graph.link_bw))
    blind = from_fit(
        truth.graph,
        np.full((truth.graph.n_links,), mean_bw),
        name=f"{truth.graph.name}-blind",
    )
    return DeviceTopology(graph=blind, multipath=truth.multipath)


def fit_from_synthetic(
    truth: DeviceTopology,
    template: DeviceTopology | None = None,
    *,
    probe_bytes: float = 1e9,
    axis_sizes_list: Sequence[dict[str, int]] = (),
    noise_std: float = 0.0,
    noise=None,
    generator: torch.Generator | None = None,
    device=DEFAULT_DEVICE,
    **fit_kwargs,
) -> MeshCalibrationResult:
    """The synthetic round trip on ``device``: sweep ``truth`` through the
    forward model, then fit from a structure-only template (by default
    :func:`blind_template`).  ``noise``/``generator`` as in
    :func:`collect_samples`."""
    charges = probe_suite(truth, probe_bytes=probe_bytes, axis_sizes_list=axis_sizes_list)
    samples = collect_samples(
        truth, charges, noise_std=noise_std, noise=noise, generator=generator, device=device
    )
    if template is None:
        template = blind_template(truth)
    return fit_device_topology(template, samples, device=device, **fit_kwargs)


def link_relative_errors(fitted: DeviceTopology, reference: DeviceTopology) -> np.ndarray:
    """``(n_links,)`` relative error of fitted link bandwidths against a
    reference topology with the same link list."""
    if fitted.graph.link_ends != reference.graph.link_ends:
        raise ValueError("topologies disagree on the link list")
    fit = np.asarray(fitted.graph.link_bw, np.float64)
    ref = np.asarray(reference.graph.link_bw, np.float64)
    return np.abs(fit - ref) / ref
