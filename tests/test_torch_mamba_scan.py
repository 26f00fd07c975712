"""The port's selective scan (mamba-1 forward) against the reference.

On the CPU the wrapper runs its plain PyTorch version; it is held against
the reference's Pallas kernel in interpret mode and its jnp oracle, at
the shapes of the reference's kernel tests, from numpy-seeded inputs:
1e-4 in float32, 2e-2 for bf16 inputs through ``ssm_scan``.  The CUDA
kernel itself is held against the plain version on the card by
``tests/test_torch_cuda.py`` and by ``chip_smoke.py``."""

import numpy as np
import pytest
import torch

import repro_torch.kernels.mamba_scan.kernel as port_kernel
from repro.kernels.mamba_scan.kernel import selective_scan as ref_selective_scan
from repro.kernels.mamba_scan.ops import ssm_scan as ref_ssm_scan
from repro.kernels.mamba_scan.ref import selective_scan_ref as ref_scan_ref
from repro_torch.kernels.mamba_scan.ops import ssm_scan
from repro_torch.kernels.mamba_scan.ref import selective_scan_ref

SHAPES = [
    # B, S, di, n, block_d, chunk (the reference kernel's tiling)
    (1, 64, 32, 8, 16, 32),
    (2, 128, 64, 16, 32, 64),
    (1, 96, 48, 16, 16, 32),
    (2, 64, 128, 4, 128, 16),
]


def _inputs(seed, B, S, di, n):
    """The reference tests' distribution, drawn with numpy."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, di)) - 2.0))  # softplus
    a = -np.exp(rng.standard_normal((di, n)) * 0.3)
    b = rng.standard_normal((B, S, n)) * 0.5
    c = rng.standard_normal((B, S, n)) * 0.5
    x = rng.standard_normal((B, S, di))
    return tuple(v.astype(np.float32) for v in (dt, a, b, c, x))


def _t(arrays):
    return tuple(torch.as_tensor(v) for v in arrays)


@pytest.mark.parametrize("B,S,di,n,block_d,chunk", SHAPES)
def test_selective_scan_matches_reference_kernel_and_oracle(B, S, di, n, block_d, chunk):
    arrays = _inputs(0, B, S, di, n)
    got = port_kernel.selective_scan(*_t(arrays))
    assert got.dtype == torch.float32 and got.shape == (B, S, di)
    want_kernel = ref_selective_scan(*arrays, block_d=block_d, chunk=chunk, interpret=True)
    want_ref, _ = ref_scan_ref(*arrays)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), atol=1e-4, rtol=1e-4)


def test_plain_version_final_state_and_h0_match_reference():
    B, S, di, n = 2, 32, 16, 8
    arrays = _inputs(1, B, S, di, n)
    h0 = np.random.default_rng(2).standard_normal((B, di, n)).astype(np.float32)
    y, hT = selective_scan_ref(*_t(arrays), h0=torch.as_tensor(h0))
    want_y, want_h = ref_scan_ref(*arrays, h0=h0)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(hT.numpy(), np.asarray(want_h), atol=1e-4, rtol=1e-4)


def test_ssm_scan_bf16_inputs_match_reference():
    B, S, di, n = 1, 64, 32, 8
    dt, a, b, c, x = _t(_inputs(3, B, S, di, n))
    bf = [v.to(torch.bfloat16) for v in (dt, b, c, x)]
    got = ssm_scan(bf[0], a, bf[1], bf[2], bf[3])
    assert got.dtype == torch.float32
    as_f32 = [v.float().numpy() for v in bf]
    want = ref_ssm_scan(as_f32[0], a.numpy(), as_f32[1], as_f32[2], as_f32[3], interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2, rtol=2e-2)


def test_cpu_tensors_take_the_plain_version_without_counting():
    arrays = _t(_inputs(4, 1, 16, 8, 4))
    before = port_kernel.selective_scan.launches
    port_kernel.selective_scan(*arrays)
    assert port_kernel.selective_scan.launches == before


def test_wrapper_rejects_bad_inputs():
    dt, a, b, c, x = _t(_inputs(5, 1, 16, 8, 4))
    with pytest.raises(TypeError):
        port_kernel.selective_scan(dt.double(), a, b, c, x)
    with pytest.raises(ValueError):
        port_kernel.selective_scan(dt, a, b, c, x.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError):
        port_kernel.selective_scan(dt, a[:4], b, c, x)
    with pytest.raises(ValueError):
        port_kernel.selective_scan(dt, a, b[:, :8], c, x)
    with pytest.raises(ValueError):
        port_kernel.selective_scan(dt[None], a, b, c, x[None])
    with pytest.raises(ValueError):  # neither cpu nor cuda
        port_kernel.selective_scan(*(v.to("meta") for v in (dt, a, b, c, x)))
