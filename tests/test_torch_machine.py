"""The port's machine specs, presets and placement enumeration against
the reference: caps vectors, fingerprints, bank assignments, and the
exact placement sets (seeded subsamples included)."""

import numpy as np
import pytest
import torch
from _torch_parity import CPU, port_machine, to_np

import repro.core.numa as ref
import repro.core.numa.evaluate as ref_eval
import repro_torch.core.numa as port
import repro_torch.core.numa.evaluate as port_eval
from repro.core.numa.simulator import machine_caps as ref_machine_caps
from repro_torch.core.numa.simulator import machine_caps as port_machine_caps

PRESETS = sorted(ref.MACHINES)


def _pair(name):
    return ref.MACHINES[name], port.MACHINES[name]


def test_preset_registry_matches():
    assert sorted(port.MACHINES) == PRESETS
    assert len(PRESETS) == 7


@pytest.mark.parametrize("name", PRESETS)
def test_preset_fields_and_fingerprint_identical(name):
    want, got = _pair(name)
    assert repr(got) == repr(want)
    assert got.fingerprint() == want.fingerprint()
    assert (got.n_nodes, got.cores_per_node, got.total_cores, got.n_links) == (
        want.n_nodes, want.cores_per_node, want.total_cores, want.n_links
    )
    # carried across through convert: the same spec, the same digest
    assert port_machine(want) == got
    assert port_machine(want).fingerprint() == want.fingerprint()


@pytest.mark.parametrize("name", PRESETS)
def test_caps_vectors_identical(name):
    want, got = _pair(name)
    pairs = {
        "bank_read": (got.bank_read_caps(CPU), want.bank_read_caps()),
        "bank_write": (got.bank_write_caps(CPU), want.bank_write_caps()),
        "remote_read": (got.remote_read_caps(CPU), want.remote_read_caps()),
        "remote_write": (got.remote_write_caps(CPU), want.remote_write_caps()),
        "link": (got.link_caps(CPU), want.link_caps()),
        "node_rates": (got.node_rates(CPU), want.node_rates()),
        "machine_caps": (port_machine_caps(got, CPU), ref_machine_caps(want)),
    }
    for what, (g, w) in pairs.items():
        assert g.dtype == torch.float32, what
        np.testing.assert_array_equal(to_np(g), np.asarray(w), err_msg=what)


def test_make_machine_fingerprints_identical():
    kwargs = [
        {},
        dict(name="snc", sockets=2, cores_per_socket=12, nodes_per_socket=3, qpi_bw=20e9),
        dict(name="hetero", sockets=3, core_rate=(2.0e9, 1.5e9, 2.5e9),
             local_read_bw=(40e9, 30e9, 50e9), hop_attenuation=0.7),
        dict(name="ring", sockets=5, topology=port.ring(5, 8e9)),
    ]
    for kw in kwargs:
        ref_kw = dict(kw)
        if "topology" in kw:
            ref_kw["topology"] = ref.ring(5, 8e9)
        want = ref.make_machine(**ref_kw)
        got = port.make_machine(**kw)
        assert repr(got) == repr(want)
        assert got.fingerprint() == want.fingerprint()


@pytest.mark.parametrize("name", ["E7-4830v3-4s12c", "E7-8860v3-8s16c"])
def test_canonical_bank_assignment_identical(name):
    want, got = _pair(name)
    s = want.n_nodes
    for ba in (None, tuple(range(s)), tuple(reversed(range(s))), (0,) * s):
        assert port.canonical_bank_assignment(got, ba) == ref.canonical_bank_assignment(
            want, ba
        )
    for bad in ((0,) * (s - 1), (s,) * s):
        with pytest.raises(ValueError):
            port.canonical_bank_assignment(got, bad)


_COUNTS = [
    ("E5-2630v3-8c", 8),
    ("E5-2699v3-18c", 16),
    ("E7-4830v3-4s12c", 24),
    ("E5-2699v3-18c-snc2", 16),
    ("E7-8860v3-8s16c", 32),
    ("E7-8860v3-8s16c", 8),
]


@pytest.mark.parametrize("name,n", _COUNTS)
def test_count_placements_identical(name, n):
    want, got = _pair(name)
    assert port_eval.count_placements(got, n) == ref_eval.count_placements(want, n)


@pytest.mark.parametrize(
    "name,n,max_p,seed",
    [
        ("E5-2630v3-8c", 8, None, 0),
        ("E7-4830v3-4s12c", 24, None, 0),
        ("E5-2699v3-18c-snc2", 16, None, 0),
        ("E7-4830v3-4s12c", 24, 64, 0),
        ("E7-4830v3-4s12c", 24, 64, 3),
        ("E7-8860v3-8s16c", 32, 512, 0),
        ("E7-8860v3-8s16c", 32, 100, 11),
    ],
)
def test_enumerate_placements_identical(name, n, max_p, seed):
    want, got = _pair(name)
    w = np.asarray(ref_eval.enumerate_placements(want, n, max_placements=max_p, seed=seed))
    g = port_eval.enumerate_placements(got, n, max_placements=max_p, seed=seed, device=CPU)
    assert g.dtype == torch.int32
    np.testing.assert_array_equal(to_np(g), w)
    s = port_eval.sweep_placements(got, n, max_placements=max_p, seed=seed, device=CPU)
    np.testing.assert_array_equal(to_np(s), w)


def test_enumerate_rejects_overfull():
    got = port.MACHINES["E5-2630v3-8c"]
    with pytest.raises(ValueError):
        port_eval.enumerate_placements(got, 17, device=CPU)
