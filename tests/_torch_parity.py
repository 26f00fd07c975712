"""Shared helpers of the ``tests/test_torch_*.py`` parity tests: carry the
JAX reference's objects into the PyTorch port (through
``repro_torch.convert``, as plain numpy values) and compare results.

Both frameworks run on the CPU here; the port is always called with
``device="cpu"``.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import torch

from repro_torch.convert import (
    machine_from_fields,
    signature_from_arrays,
    workload_from_arrays,
)

CPU = "cpu"


def to_np(x) -> np.ndarray:
    """A tensor or JAX array as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def port_machine(ref_machine):
    """The port's :class:`MachineSpec` for a reference spec."""
    return machine_from_fields(ref_machine._asdict())


def port_workload(ref_workload):
    """The port's workload with the reference workload's exact values."""
    arrays = {f: np.asarray(getattr(ref_workload, f)) for f in ref_workload._fields[1:]}
    return workload_from_arrays(ref_workload.name, arrays, device=CPU)


def port_signature(ref_sig):
    """The port's :class:`BandwidthSignature` from a reference one."""
    return signature_from_arrays(
        tuple(np.asarray(v) for v in ref_sig.read),
        tuple(np.asarray(v) for v in ref_sig.write),
        device=CPU,
    )


@functools.partial(
    jax.jit, static_argnums=(0, 2), static_argnames=("noise_std", "background_bw")
)
def _ref_profile_pair(machine, arrays, thread_classes, key, noise_std, background_bw):
    from repro.core.numa import profile_pair
    from repro.core.numa.workload import Workload

    return profile_pair(
        machine, Workload("w", *arrays), noise_std=noise_std,
        background_bw=background_bw, key=key, thread_classes=thread_classes,
    )


def ref_profile_pair(
    machine, workload, *, noise_std: float = 0.02, background_bw: float = 0.0, seed: int = 0
):
    """The reference's noisy ``profile_pair`` under one ``jit`` (its eager
    first call compiles op by op and takes several times longer)."""
    from repro.core.numa import thread_class_starts

    return _ref_profile_pair(
        machine, tuple(workload[1:]), thread_class_starts(workload),
        jax.random.PRNGKey(seed), noise_std=noise_std, background_bw=background_bw,
    )


@functools.partial(jax.jit, static_argnames=("combined",))
def ref_fit_signature(sym, asym, combined=False):
    """The reference's ``fit_signature`` under ``jit``."""
    from repro.core.bwsig import fit_signature

    return fit_signature(sym, asym, combined=combined)


def port_sample(ref_sample):
    """A reference :class:`CounterSample` as the port's, value for value."""
    from repro_torch.core.bwsig import CounterSample

    return CounterSample(*(torch.as_tensor(np.array(f)) for f in ref_sample))


def jax_counter_noise(key, s: int):
    """The standard-normal draws the reference's ``_finalize_result``
    makes from ``key``, as the port's :class:`CounterNoise`."""
    from repro_torch.core.numa.simulator import CounterNoise

    k1, k2, k3 = jax.random.split(key, 3)
    return CounterNoise(
        torch.as_tensor(np.array(jax.random.normal(k1, (s, s)))),
        torch.as_tensor(np.array(jax.random.normal(k2, (s, s)))),
        torch.as_tensor(np.array(jax.random.normal(k3, (s,)))),
    )


def jax_profile_noise(key, s: int):
    """The two runs' draws of the reference's ``profile_pair(key=key)``."""
    k_sym, k_asym = jax.random.split(key)
    return jax_counter_noise(k_sym, s), jax_counter_noise(k_asym, s)


def assert_close(got, want, *, rtol: float, atol: float = 0.0, what: str = "") -> None:
    """``|got - want| <= atol + rtol * |want|`` elementwise, shapes equal."""
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def assert_rel_to_scale(got, want, *, rtol: float, what: str = "") -> None:
    """Elementwise difference within ``rtol`` of the largest magnitude in
    ``want``: flows and counters mix large and near-zero entries, and a
    zero entry computed as 1e-7 in another summation order is agreement."""
    got, want = to_np(got).astype(np.float64), to_np(want).astype(np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rtol, f"{what}: max |diff| / max |want| = {err:.3e} > {rtol}"
