"""The port on an NVIDIA GPU: the CUDA selective-scan kernel against its
plain version, and the sweep and the service on the card against the same
port code on the CPU.  Every test here is marked ``gpu`` and skips
without a card; this file imports neither JAX nor the JAX package, so it
runs where only torch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import repro_torch.kernels.mamba_scan.kernel as scan_kernel
from repro_torch.kernels.mamba_scan.ops import ssm_scan
from repro_torch.kernels.mamba_scan.ref import selective_scan_ref

pytestmark = pytest.mark.gpu

SHAPES = [(1, 64, 32, 8), (2, 128, 64, 16), (1, 96, 48, 16), (2, 64, 128, 4), (1, 300, 70, 16)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(seed, B, S, di, n, device):
    rng = np.random.default_rng(seed)
    arrays = (
        np.log1p(np.exp(rng.standard_normal((B, S, di)) - 2.0)),
        -np.exp(rng.standard_normal((di, n)) * 0.3),
        rng.standard_normal((B, S, n)) * 0.5,
        rng.standard_normal((B, S, n)) * 0.5,
        rng.standard_normal((B, S, di)),
    )
    return tuple(torch.as_tensor(a.astype(np.float32), device=device) for a in arrays)


@pytest.mark.parametrize("B,S,di,n", SHAPES)
def test_scan_kernel_matches_plain_version(cuda, B, S, di, n):
    """Ragged shapes included: 300 steps is not a multiple of the 64-step
    staging chunk, 70 channels not a multiple of the 64-thread block."""
    dt, a, b, c, x = _inputs(0, B, S, di, n, cuda)
    before = scan_kernel.selective_scan.launches
    got = scan_kernel.selective_scan(dt, a, b, c, x)
    torch.cuda.synchronize()
    assert scan_kernel.selective_scan.launches == before + 1
    want, _ = selective_scan_ref(dt, a, b, c, x)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_ssm_scan_bf16_inputs_on_the_card(cuda):
    dt, a, b, c, x = _inputs(1, 1, 64, 32, 8, cuda)
    bf = [v.to(torch.bfloat16) for v in (dt, b, c, x)]
    got = ssm_scan(bf[0], a, bf[1], bf[2], bf[3])
    want, _ = selective_scan_ref(bf[0].float(), a, bf[1].float(), bf[2].float(), bf[3].float())
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)


def test_scan_kernel_rejects_state_width_without_instantiation(cuda):
    dt, a, b, c, x = _inputs(2, 1, 16, 8, 5, cuda)
    with pytest.raises(ValueError):
        scan_kernel.selective_scan(dt, a, b, c, x)


def test_sweep_on_the_card_matches_cpu(cuda):
    from repro_torch.core.numa import E5_2699_V3_SNC2
    from repro_torch.core.numa.benchmarks import benchmark_workload
    from repro_torch.core.numa.evaluate import evaluate_batch, placement_array

    placements = placement_array(E5_2699_V3_SNC2, 16, max_placements=128)
    names = ("CG", "Page rank")
    on_card = evaluate_batch(
        E5_2699_V3_SNC2, [benchmark_workload(b, 16, device=cuda) for b in names], placements
    )
    on_cpu = evaluate_batch(
        E5_2699_V3_SNC2, [benchmark_workload(b, 16, device="cpu") for b in names], placements
    )
    assert on_card.total_bw.device.type == "cuda"
    torch.testing.assert_close(on_card.total_bw.cpu(), on_cpu.total_bw, rtol=1e-4, atol=0)
    torch.testing.assert_close(on_card.errors_combined.cpu(), on_cpu.errors_combined,
                               rtol=0, atol=1e-5)


def test_service_on_the_card_matches_cpu(cuda):
    from repro_torch.core.numa import E7_4830_V3
    from repro_torch.launch.advisor_serve import signature_pool
    from repro_torch.serve import AdvisorService

    sigs = signature_pool(8, seed=3)
    with AdvisorService(device="cuda") as svc:
        card = [svc.query(E7_4830_V3, s, 12) for s in sigs]
    with AdvisorService(device="cpu") as svc:
        cpu = [svc.query(E7_4830_V3, s, 12) for s in sigs]
    for g, c in zip(card, cpu):
        assert g.objective == pytest.approx(c.objective, rel=1e-4)
