"""The port on an NVIDIA GPU: the CUDA selective-scan and flash-attention
kernels, forward and backward, against their plain versions, a training
step of the reduced LMs on the card against the CPU, and the sweep, the placement
search, the scheduler, the service's tiers, the reduced LMs' prefill
(attention, mamba and MoE layers), the mamba decode step, the MoE
dispatch, the calibration's paired batch, loss gradient and fit, the
mesh-domain link fit, and a hot-swap of the service on the card against
the same port code on the CPU; the kernels' counted work on the card
against their ``meta`` branches, and the counter source's count of a
step on the card against ``meta``.  Every test here is marked ``gpu`` and skips without a card; this
file imports neither JAX nor the JAX package, so it runs where only
torch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import repro_torch.kernels.flash_attention.kernel as flash_kernel
import repro_torch.kernels.mamba_scan.kernel as scan_kernel
from repro_torch.kernels.flash_attention.ops import mha_flash
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.mamba_scan.ops import ssm_scan
from repro_torch.kernels.mamba_scan.ref import selective_scan_ref

pytestmark = pytest.mark.gpu

SHAPES = [
    (1, 64, 32, 8), (2, 128, 64, 16), (1, 96, 48, 16), (2, 64, 128, 4), (1, 300, 70, 16),
    # ragged for K2's tiles (16-step chunks in a ring of 4, channel tiles of
    # 32 / 64 / 128 at N = 16 / 8 / 4, 16-byte copies only where d_inner % 4
    # == 0): S past the ring's first wrap and no multiple of a chunk, part
    # of a channel tile, d_inner % 4 != 0, B = 3
    (3, 333, 100, 16), (3, 257, 90, 8), (3, 161, 130, 4), (2, 1000, 200, 16),
    # fewer chunks than ring stages; less than one chunk; one step
    (2, 40, 36, 4), (3, 7, 20, 16), (1, 1, 4, 8),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(seed, B, S, di, n, device, dt_shift=2.0):
    rng = np.random.default_rng(seed)
    arrays = (
        np.log1p(np.exp(rng.standard_normal((B, S, di)) - dt_shift)),
        -np.exp(rng.standard_normal((di, n)) * 0.3),
        rng.standard_normal((B, S, n)) * 0.5,
        rng.standard_normal((B, S, n)) * 0.5,
        rng.standard_normal((B, S, di)),
    )
    return tuple(torch.as_tensor(a.astype(np.float32), device=device) for a in arrays)


@pytest.mark.parametrize("B,S,di,n", SHAPES)
def test_scan_kernel_matches_plain_version(cuda, B, S, di, n):
    """Ragged shapes included (see ``SHAPES``); one launch a call."""
    dt, a, b, c, x = _inputs(0, B, S, di, n, cuda)
    before = scan_kernel.selective_scan.launches
    got = scan_kernel.selective_scan(dt, a, b, c, x)
    torch.cuda.synchronize()
    assert scan_kernel.selective_scan.launches == before + 1
    want, _ = selective_scan_ref(dt, a, b, c, x)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_scan_kernel_carries_the_state_across_chunks(cuda):
    """dt drawn small (softplus(z - 6), about 0.004) so the state decays
    slowly and carries across the kernel's time chunks; S spans five of
    them and a ragged sixth.  The kernel matches the plain version, and the
    plain version with the state reset to zero at any of the five chunk
    boundaries lies outside the tolerance on the last chunk's steps, so a
    kernel that dropped the carry at a boundary (or read a stale ring
    stage) would fail."""
    T = scan_kernel.tiles(16)["time_chunk"]
    B, S, di, n = 2, 5 * T + 7, 96, 16
    dt, a, b, c, x = _inputs(3, B, S, di, n, cuda, dt_shift=6.0)
    got = scan_kernel.selective_scan(dt, a, b, c, x)
    torch.cuda.synchronize()
    want, _ = selective_scan_ref(dt, a, b, c, x)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    for cut in range(T, S, T):
        after, _ = selective_scan_ref(dt[:, cut:], a, b[:, cut:], c[:, cut:], x[:, cut:])
        with pytest.raises(AssertionError):
            torch.testing.assert_close(after[:, 5 * T - cut:], want[:, 5 * T:], atol=1e-4, rtol=1e-4)


def test_scan_kernel_reads_unaligned_views(cuda):
    """Contiguous inputs that start 4 bytes into their storage: 16-byte
    copies need 16-byte aligned addresses, so the kernel takes its 4-byte
    copies, and matches the plain version."""
    B, S, di, n = 2, 100, 64, 16
    arrays = _inputs(4, B, S, di, n, cuda)

    def shifted(t):
        view = torch.empty(t.numel() + 1, device=cuda)[1:].view(t.shape)
        return view.copy_(t)

    dt, a, b, c, x = (shifted(t) for t in arrays)
    assert dt.is_contiguous() and dt.data_ptr() % 16 != 0
    got = scan_kernel.selective_scan(dt, a, b, c, x)
    torch.cuda.synchronize()
    want, _ = selective_scan_ref(*arrays)
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
    with pytest.raises(ValueError):
        scan_kernel.tiles(5)


FLASH_CASES = [
    # B, H, Kv, Sq, Skv, dh, options: the CPU parity sweep plus ragged sizes
    (1, 4, 4, 128, 128, 64, {}),
    (2, 8, 2, 128, 128, 64, {}),
    (1, 4, 1, 64, 256, 32, {}),
    (1, 2, 2, 256, 256, 128, {}),
    (1, 4, 2, 128, 128, 64, dict(window=32)),
    (1, 4, 2, 128, 128, 64, dict(window=64)),
    (1, 2, 2, 64, 64, 32, dict(logit_cap=30.0)),
    (1, 2, 2, 64, 64, 32, dict(causal=False)),
    (1, 4, 2, 300, 300, 64, {}),
    (1, 4, 2, 77, 301, 16, dict(window=40)),
    (1, 4, 2, 300, 300, 256, dict(window=100, logit_cap=50.0)),
    (2, 16, 2, 256, 256, 128, {}),  # GQA 8:1 at dh 128, as qwen3-moe-30b-a3b's prefill
]
# the bf16 tensor-core kernel's own edges: dh 80 (padded to 128 by TMA's
# zero fill), ragged and right-aligned; Sq < Skv at dh 128; a window edge
# in the middle of a 128-row q tile; S = 2048, where the two-stage K/V
# ring wraps eight times
FLASH_EDGE_CASES = [
    (1, 4, 2, 128, 128, 80, {}),
    (2, 4, 2, 200, 333, 80, dict(window=100)),
    (1, 4, 2, 130, 400, 128, {}),
    (1, 4, 2, 512, 512, 128, dict(window=192)),
    (1, 2, 1, 2048, 2048, 128, {}),
    # whisper's non-causal attention, MHA at dh 64: cross-attention with Sq
    # < Skv (the right-aligned q offset must change nothing without a mask)
    # and Sq > Skv, and ragged sizes no multiple of a tile
    (1, 4, 4, 40, 75, 64, dict(causal=False)),
    (1, 4, 4, 75, 40, 64, dict(causal=False)),
    (2, 16, 16, 130, 333, 64, dict(causal=False)),
    (1, 4, 4, 300, 300, 64, dict(causal=False)),
]


def _qkv(seed, B, H, Kv, Sq, Skv, dh, dtype, device, qk_std=0.5):
    rng = np.random.default_rng(seed)
    stds = (qk_std, qk_std, 0.5)
    return tuple(
        torch.as_tensor((rng.standard_normal(shape) * std).astype(np.float32), device=device).to(dtype)
        for shape, std in zip(((B, H, Sq, dh), (B, Kv, Skv, dh), (B, Kv, Skv, dh)), stds)
    )


# the plain version computes in float32 too and rounds to q's dtype, so
# bf16 outputs differ by one ulp (2^-7 relative) plus what the bf16
# kernel's rounding of its probabilities (2^-9 relative a weight) adds
FLASH_TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5), torch.bfloat16: dict(atol=4e-3, rtol=1e-2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Kv,Sq,Skv,dh,kwargs", FLASH_CASES)
def test_flash_kernel_matches_plain_version(cuda, dtype, B, H, Kv, Sq, Skv, dh, kwargs):
    """Ragged sizes included: 300 and 77 / 301 rows are no multiple of
    the float32 kernel's 128-row (64 at dh 256) q and 64-key KV tiles nor
    of the bf16 kernel's 128-row q and 128-key (64 at dh 256) KV tiles."""
    q, k, v = _qkv(0, B, H, Kv, Sq, Skv, dh, dtype, cuda)
    before = flash_kernel.flash_attention.launches
    got = flash_kernel.flash_attention(q, k, v, **kwargs)
    torch.cuda.synchronize()
    assert flash_kernel.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = attention_ref(q, k, v, **kwargs)
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])


def _plain_dropping_keys(q, k, v, keys, *, causal=True, window=0, logit_cap=0.0):
    """The plain version with the keys in ``keys`` masked out as well: what
    a kernel that skipped one KV tile, mis-masked it or read a stale ring
    stage in its place would be near."""
    H, Sq, dh = q.shape[1], q.shape[2], q.shape[3]
    Kv, Skv = k.shape[1], k.shape[2]
    k, v = (t.float().repeat_interleave(H // Kv, dim=1) for t in (k, v))
    logits = q.float() @ k.transpose(-1, -2) * dh**-0.5
    if logit_cap > 0.0:
        logits = logit_cap * torch.tanh(logits / logit_cap)
    rows = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    cols = torch.arange(Skv, device=q.device)[None, :]
    ok = ((cols < keys.start) | (cols >= keys.stop)) & (cols <= rows if causal else True)
    if window:
        ok = ok & (cols > rows - window)
    return (torch.where(ok, logits, -1e30).softmax(-1) @ v).to(q.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Kv,Sq,Skv,dh,kwargs", FLASH_EDGE_CASES)
def test_flash_kernel_edges_match_plain_version(cuda, dtype, B, H, Kv, Sq, Skv, dh, kwargs):
    """The bf16 kernel's edges at q and k of std 1 (scores of std 1, as in
    chip_smoke.py), where the output is concentrated enough to tell one
    128-key tile: the kernel matches the plain version, and the plain
    version with the middle tile of the KV walk dropped lies outside the
    tolerance on the rows past that tile, for which it lies inside the
    walk, so a kernel that lost that tile would fail."""
    q, k, v = _qkv(0, B, H, Kv, Sq, Skv, dh, dtype, cuda, qk_std=1.0)
    before = flash_kernel.flash_attention.launches
    got = flash_kernel.flash_attention(q, k, v, **kwargs)
    torch.cuda.synchronize()
    assert flash_kernel.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = attention_ref(q, k, v, **kwargs)
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])
    tile = Skv // 128 // 2
    keys = range(128 * tile, min(128 * tile + 128, Skv))
    dropped = _plain_dropping_keys(q, k, v, keys, **kwargs)
    first = keys.stop - (Skv - Sq)  # the first q row past the tile (all rows: a one-tile walk)
    rows = slice(first if 0 <= first < Sq else 0, None)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(
            dropped[:, :, rows].float(), want[:, :, rows].float(), **FLASH_TOL[dtype]
        )


# the float32 kernel's own edges (128-row q tiles, 64 at dh 256, and 64-key
# KV tiles; only tiles the diagonal, the window's edge or a ragged end
# crosses test each element): a window edge inside a q tile, Sq < Skv with
# the diagonal mid-tile, ragged Sq and Skv at dh 16, 80 and 256 (the cap at
# dh 256 and, with a window, at dh 32)
F32_EDGE_CASES = [
    (1, 4, 2, 256, 256, 128, dict(window=96)),
    (1, 4, 2, 100, 190, 64, {}),
    (1, 4, 2, 77, 150, 16, {}),
    (2, 4, 2, 130, 201, 80, dict(window=70)),
    (1, 2, 1, 99, 131, 256, dict(logit_cap=5.0)),
    (1, 8, 2, 150, 150, 32, dict(window=50, logit_cap=5.0)),
]


@pytest.mark.parametrize("B,H,Kv,Sq,Skv,dh,kwargs", F32_EDGE_CASES)
def test_f32_flash_kernel_tile_edges_match_plain_version(cuda, B, H, Kv, Sq, Skv, dh, kwargs):
    """The float32 kernel at q and k of std 1: the output and the row
    log-sum-exp match the plain version, two calls give equal bits, and the
    plain version with the middle KV tile of the walk dropped lies outside
    the tolerance on the rows past that tile, so a kernel that lost or
    mis-masked that tile would fail."""
    from repro_torch.kernels.flash_attention.ref import attention_lse_ref

    q, k, v = _qkv(13, B, H, Kv, Sq, Skv, dh, torch.float32, cuda, qk_std=1.0)
    lse = torch.empty((B, H, Sq), device=cuda)
    got = flash_kernel.flash_attention(q, k, v, lse=lse, **kwargs)
    again = flash_kernel.flash_attention(q, k, v, **kwargs)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = attention_ref(q, k, v, **kwargs)
    torch.testing.assert_close(got, want, **FLASH_TOL[torch.float32])
    torch.testing.assert_close(lse, attention_lse_ref(q, k, **kwargs), **FLASH_TOL[torch.float32])
    tile = Skv // 64 // 2
    keys = range(64 * tile, min(64 * tile + 64, Skv))
    dropped = _plain_dropping_keys(q, k, v, keys, **kwargs)
    first = keys.stop - (Skv - Sq)  # the first q row past the tile (all rows: a one-tile walk)
    rows = slice(first if 0 <= first < Sq else 0, None)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(dropped[:, :, rows], want[:, :, rows], **FLASH_TOL[torch.float32])


def test_f32_flash_forward_reads_unaligned_views(cuda):
    """float32 operands whose base lies 4 bytes off 16, or whose rows lie 66
    floats apart, take the 4-byte copies and stores: the output and the row
    log-sum-exp equal, bit for bit, those from the same values at aligned
    addresses, which match the plain version."""
    q, k, v = _qkv(14, 1, 4, 2, 100, 100, 64, torch.float32, cuda, qk_std=1.0)
    lse_want = torch.empty((1, 4, 100), device=cuda)
    want = flash_kernel.flash_attention(q, k, v, lse=lse_want, window=40)
    torch.testing.assert_close(want, attention_ref(q, k, v, window=40), **FLASH_TOL[torch.float32])

    def shifted(t):
        return torch.empty(t.numel() + 1, device=cuda)[1:].view(t.shape).copy_(t)

    def padded(t):
        wide = torch.zeros(*t.shape[:3], t.shape[3] + 2, device=cuda)
        wide[..., : t.shape[3]] = t
        return wide[..., : t.shape[3]]

    for view in (shifted, padded):
        out = view(torch.zeros_like(q))
        assert out.data_ptr() % 16 != 0 or out.stride(2) % 4 != 0
        lse = torch.empty_like(lse_want)
        got = flash_kernel.flash_attention(view(q), view(k), view(v), window=40, out=out, lse=lse)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(lse, lse_want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "H,Kv,S,dh,qk_std,kwargs",
    [
        (4, 2, 128, 64, 2.0, dict(logit_cap=5.0)),  # scores of std 4 against a cap of 5
        (4, 2, 300, 256, 5.0, dict(window=100, logit_cap=50.0)),  # gemma2's cap, std 25
    ],
)
def test_flash_kernel_soft_cap_and_window_move_the_output(cuda, dtype, H, Kv, S, dh, qk_std, kwargs):
    """Scores large enough for the soft-cap to act: the kernel matches the
    plain version, and the plain version without the cap (or the window)
    lies outside the tolerance, so a kernel that ignored it would fail."""
    q, k, v = _qkv(4, 1, H, Kv, S, S, dh, dtype, cuda, qk_std=qk_std)
    got = flash_kernel.flash_attention(q, k, v, **kwargs)
    want = attention_ref(q, k, v, **kwargs)
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])
    for name in kwargs:
        without = attention_ref(q, k, v, **{o: x for o, x in kwargs.items() if o != name})
        with pytest.raises(AssertionError):
            torch.testing.assert_close(without.float(), want.float(), **FLASH_TOL[dtype])


def test_bf16_flash_rejects_a_view_tma_cannot_read(cuda):
    """A q view whose rows lie 136 bytes apart (no multiple of 16) raises:
    the bf16 kernel reads through TMA and neither copies nor falls back."""
    q, k, v = _qkv(5, 1, 4, 2, 64, 64, 64, torch.bfloat16, cuda)
    padded = torch.zeros(1, 4, 64, 68, dtype=torch.bfloat16, device=cuda)
    padded[..., :64] = q
    before = flash_kernel.flash_attention.launches
    with pytest.raises(ValueError, match="16-byte"):
        flash_kernel.flash_attention(padded[..., :64], k, v)
    assert flash_kernel.flash_attention.launches == before


@pytest.mark.parametrize("dh", [64, 80])
def test_mha_flash_on_the_card_counts_and_matches_cpu(cuda, dh):
    """Through the model's (B, S, H, dh) layout: at dh 80 the bf16 kernel's
    tensor maps have a head stride (160 bytes) below the row stride, and
    the columns it zero-fills past dh are the next head's bytes."""
    q, k, v = (
        t.transpose(1, 2).contiguous()
        for t in _qkv(1, 2, 8, 2, 96, 96, dh, torch.bfloat16, cuda, qk_std=1.0)
    )
    before = flash_kernel.flash_attention.launches
    got = mha_flash(q, k, v, causal=True, window=48)
    torch.cuda.synchronize()
    assert flash_kernel.flash_attention.launches == before + 1
    want = mha_flash(q.cpu(), k.cpu(), v.cpu(), causal=True, window=48)
    assert flash_kernel.flash_attention.launches == before + 1
    torch.testing.assert_close(got.cpu().float(), want.float(), **FLASH_TOL[torch.bfloat16])


@pytest.mark.parametrize("name", ["llama3-8b", "gemma2-9b", "h2o-danube-1.8b"])
def test_reduced_prefill_on_the_card_matches_cpu(cuda, name):
    from repro_torch.configs.base import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import model as M

    cfg = get_config(name).reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 40)), dtype=torch.int32)
    step = make_prefill_step(cfg)
    want = step(params, {"tokens": tokens})
    before = flash_kernel.flash_attention.launches
    got = step(params.to(cuda), {"tokens": tokens.to(cuda)})
    torch.cuda.synchronize()
    assert flash_kernel.flash_attention.launches == before + cfg.n_layers
    scale = float(want.float().abs().max())
    assert float((got.cpu().float() - want.float()).abs().max()) <= 2e-2 * scale


@pytest.mark.parametrize("name", ["whisper-medium", "internvl2-2b"])
def test_reduced_encdec_and_vit_prefill_on_the_card_matches_cpu(cuda, name):
    """Reduced whisper (40 encoder frames: K1 once per encoder layer and
    per decoder layer's self- and cross-attention) and reduced internvl2
    (8 patch embeddings before the tokens) on the card against the CPU."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import model as M

    cfg = get_config(name).reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(2)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 24)), dtype=torch.int32)
    key, rows = ("enc_frames", 40) if cfg.is_encoder_decoder else ("patch_embeds",
                                                                   cfg.frontend_tokens)
    batch = {"tokens": tokens,
             key: torch.as_tensor(rng.standard_normal((2, rows, cfg.d_model)), dtype=torch.float32)}
    step = make_prefill_step(cfg)
    want = step(params, batch)
    before = flash_kernel.flash_attention.launches
    got = step(params.to(cuda), {k: v.to(cuda) for k, v in batch.items()})
    torch.cuda.synchronize()
    calls = cfg.n_layers + (cfg.encoder_layers + cfg.n_layers if cfg.is_encoder_decoder else 0)
    assert flash_kernel.flash_attention.launches == before + calls
    scale = float(want.float().abs().max())
    assert float((got.cpu().float() - want.float()).abs().max()) <= 2e-2 * scale


@pytest.mark.parametrize("name", ["falcon-mamba-7b", "jamba-1.5-large-398b"])
def test_reduced_mamba_archs_on_the_card_match_cpu(cuda, name):
    """float32 compute, the same weights on both: the prefill launches K2
    once per mamba layer and K1 once per attention layer, its logits lie
    within rel 1e-4 of the CPU's (K2's own tolerance), and eight
    teacher-forced decode steps (conv window and state on the card) give
    the CPU's tokens and logits.  The caches are float32: a bf16 conv
    window rounds the two devices' last-bit differences across bf16
    boundaries and the state carries them (``tests/test_torch_lm.py``)."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_config(name).reduced(), compute_dtype="float32")
    kinds = [M.slot_kinds(cfg, i % cfg.group_size)[0] for i in range(cfg.n_layers)]
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card_params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu").to(cuda)
    tokens = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 40)),
                             dtype=torch.int32)
    step = make_prefill_step(cfg)
    want = step(params, {"tokens": tokens})
    scans, flashes = scan_kernel.selective_scan.launches, flash_kernel.flash_attention.launches
    got = step(card_params, {"tokens": tokens.to(cuda)})
    torch.cuda.synchronize()
    assert scan_kernel.selective_scan.launches - scans == kinds.count("mamba")
    assert flash_kernel.flash_attention.launches - flashes == kinds.count("attn")
    scale = float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) <= 1e-4 * scale

    decode = make_decode_step(cfg)
    caches = [M.init_cache(cfg, 2, 8, torch.float32, device=d) for d in ("cpu", cuda)]
    for t in range(8):
        want_tok, want, caches[0] = decode(params, caches[0], tokens[:, t : t + 1], t)
        tok, got, caches[1] = decode(card_params, caches[1], tokens[:, t : t + 1].to(cuda), t)
        assert torch.equal(tok.cpu(), want_tok)
        assert float((got.cpu() - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("zero_router", [False, True])
def test_moe_dispatch_on_the_card_matches_cpu(cuda, dtype, zero_router):
    """The batched MoE dispatch on the card: the top-k experts (ties to the
    lower index under a zero router), the keep mask and the slots equal
    the CPU's, tokens are dropped over capacity, and the output lies
    within rel 1e-4 of the CPU's in float32 (2e-2 elementwise in bf16)."""
    import copy
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b").reduced(), n_experts=16,
                              experts_per_token=4, capacity_factor=0.5)
    p = moe.init_moe_params(cfg, torch.Generator().manual_seed(0), dtype, "cpu")
    if zero_router:
        p.router.zero_()
    x = torch.randn((512, cfg.d_model), generator=torch.Generator().manual_seed(1)).to(dtype)
    C = moe._capacity(cfg, 512)
    want = moe.route(cfg, x, p.router, C)
    got = moe.route(cfg, x.to(cuda), p.router.to(cuda), C)
    for field in ("top_i", "keep", "slot"):
        assert torch.equal(getattr(got, field).cpu(), getattr(want, field)), field
    if zero_router:
        assert bool((want.top_i == torch.arange(4)).all())
    assert int((want.top_p > 0).sum() - want.keep.sum()) > 0  # capacity dropped tokens

    card = copy.deepcopy(p).to(cuda)
    out, aux = moe.local_moe(cfg, x.to(cuda), card.router, card.w_gate, card.w_up, card.w_down)
    ref, ref_aux = moe.local_moe(cfg, x, p.router, p.w_gate, p.w_up, p.w_down)
    assert out.device.type == "cuda" and out.dtype == dtype
    if dtype == torch.float32:
        assert float((out.cpu() - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    else:
        torch.testing.assert_close(out.cpu().float(), ref.float(), atol=2e-2, rtol=2e-2)
    assert float(aux) == pytest.approx(float(ref_aux), rel=1e-5)


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


def _exact_on_cpu(machine, name, n, placement):
    from repro_torch.core.numa import exact_objectives
    from repro_torch.core.numa.benchmarks import benchmark_workload

    wl = benchmark_workload(name, n, device="cpu")
    return float(exact_objectives(machine, wl, np.asarray([placement]))[0])


@pytest.mark.parametrize("preset,n", [("E7_4830_V3", 24), ("E5_2699_V3_SNC2", 16)])
def test_search_on_the_card_matches_cpu(cuda, preset, n):
    """Exact objectives, the relaxed rate, gradient ascent and branch and
    bound on the card against the port on the CPU; a different placement
    must score the CPU's objective (ties on symmetric machines)."""
    from repro_torch.core.numa import (
        branch_and_bound,
        exact_objectives,
        optimize_placement,
        relaxed_work_rate,
    )
    from repro_torch.core.numa import machine as machines
    from repro_torch.core.numa.benchmarks import benchmark_workload
    from repro_torch.core.numa.evaluate import placement_array

    m = getattr(machines, preset)
    wl_card = benchmark_workload("CG", n, device=cuda)
    wl_cpu = benchmark_workload("CG", n, device="cpu")
    table = placement_array(m, n, max_placements=64)
    np.testing.assert_allclose(exact_objectives(m, wl_card, table),
                               exact_objectives(m, wl_cpu, table), rtol=1e-5)
    p = np.random.default_rng(0).dirichlet(np.ones(m.n_nodes)) * n
    card_rate = relaxed_work_rate(m, wl_card, torch.tensor(p, dtype=torch.float32))
    cpu_rate = relaxed_work_rate(m, wl_cpu, torch.tensor(p, dtype=torch.float32))
    assert card_rate.device.type == "cuda"
    assert float(card_rate) == pytest.approx(float(cpu_rate), rel=1e-4)
    for search in (optimize_placement, branch_and_bound):
        card, cpu = search(m, wl_card), search(m, wl_cpu)
        assert card.objective == pytest.approx(cpu.objective, rel=1e-5)
        assert (card.optimal, card.nodes_expanded) == (cpu.optimal, cpu.nodes_expanded)
        if card.placement != cpu.placement:
            assert _exact_on_cpu(m, "CG", n, card.placement) == pytest.approx(
                cpu.objective, rel=1e-5)


def test_schedule_on_the_card_matches_cpu(cuda):
    from repro_torch.core.numa import (
        E7_4830_V3,
        MigrationModel,
        mixed_workload,
        optimize_schedule,
        phased_workload,
    )

    def phases(device):
        return phased_workload("tri", [
            (mixed_workload("s0", 24, read_mix=(0.7, 0.1, 0.0), read_bpi=4.0,
                            static_socket=0, device=device), 4.0),
            (mixed_workload("local", 24, read_mix=(0.1, 0.6, 0.1), read_bpi=4.0,
                            device=device), 2.0),
        ])

    # the candidate pools may pick other placements among float32 ties on
    # this symmetric machine, so the schedules are held by their work
    model = MigrationModel(thread_move_bytes=1e6, page_move_bytes=1e6)
    card = optimize_schedule(E7_4830_V3, phases(cuda), model=model)
    cpu = optimize_schedule(E7_4830_V3, phases("cpu"), model=model)
    assert abs(card.gain_pct - cpu.gain_pct) <= 0.005
    assert card.schedule.total_work == pytest.approx(cpu.schedule.total_work, rel=1e-4)
    assert card.static.total_work == pytest.approx(cpu.static.total_work, rel=1e-4)


def test_search_and_schedule_tiers_on_the_card(cuda):
    from repro_torch.core.numa import E5_2630_V3
    from repro_torch.launch.advisor_serve import search_machine, signature_pool
    from repro_torch.serve import AdvisorService, QuerySignature

    m16 = search_machine()
    sig = signature_pool(1, seed=77)[0]
    phases = [(QuerySignature((0.7, 0.1, 0.0), (0.0, 0.0, 0.0), read_bpi=5.0,
                              static_socket=s), 5.0) for s in (0, 1)]
    answers = {}
    for device in ("cuda", "cpu"):
        with AdvisorService(device=device) as svc:
            answers[device] = (svc.query(m16, sig, 32, timeout=600),
                               svc.query_schedule(E5_2630_V3, phases, 8, timeout=600),
                               svc.metrics.snapshot()["tier_counts"])
    (search, sched, counts), (search_cpu, sched_cpu, _) = answers["cuda"], answers["cpu"]
    assert search.tier == "search" and sched.tier == "schedule"
    assert counts["search"] == 1 and counts["schedule"] == 1
    assert search.objective == pytest.approx(search_cpu.objective, rel=1e-4)
    assert abs(sched.gain_pct - sched_cpu.gain_pct) <= 0.005


def test_paired_batch_and_sweep_loss_gradient_on_the_card_match_cpu(cuda):
    """The probe sweep's paired batch, and ``_sweep_loss`` with its
    gradient at the seed, on the card against the CPU (glued 8-socket:
    multi-hop routes and the attenuation)."""
    from repro_torch.core.numa import E7_8860_V3, link_groups
    from repro_torch.core.numa import calibrate as C

    tmpl = C.blind_template(E7_8860_V3)
    groups = link_groups(tmpl.topology)
    card = C.collect_sweep(E7_8860_V3, device=cuda)
    cpu = C.collect_sweep(E7_8860_V3, device="cpu")
    assert card.device.type == "cuda"
    for f in ("local_read", "remote_read", "local_write", "remote_write", "instructions"):
        got, want = getattr(card, f).cpu(), getattr(cpu, f)
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-5, f

    def loss_and_grad(samples):
        seed = C.seed_parameters(tmpl, samples, groups)
        leaves = {k: v.clone().requires_grad_() for k, v in seed._asdict().items()}
        loss = C._sweep_loss(tmpl, groups, samples, C.CalibrationParams(**leaves), 0.25, (0,))
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return float(loss.detach()), [g.cpu() for g in grads]

    (card_loss, card_grads), (cpu_loss, cpu_grads) = loss_and_grad(card), loss_and_grad(cpu)
    assert card_loss == pytest.approx(cpu_loss, rel=1e-4)
    scale = max(float(g.abs().max()) for g in cpu_grads)
    for g, w in zip(card_grads, cpu_grads):
        assert torch.isfinite(g).all()
        assert float((g - w).abs().max()) <= 1e-4 * scale


def test_fit_on_the_card_matches_cpu(cuda):
    """A blind 60-step fit of E5-2699 v3 SNC-2 from the same (noisy)
    samples on the card and on the CPU: links and attenuation at rel
    1e-3, every link recovered within 5%."""
    from repro_torch.core.numa import E5_2699_V3_SNC2
    from repro_torch.core.numa import calibrate as C
    from repro_torch.core.numa.simulator import default_generator

    samples = C.collect_sweep(E5_2699_V3_SNC2, noise_std=0.01,
                              generator=default_generator(cuda, 5), device=cuda)
    tmpl = C.blind_template(E5_2699_V3_SNC2)
    card = C.fit_machine(tmpl, samples, steps=60)
    cpu = C.fit_machine(tmpl, samples.to("cpu"), steps=60)
    np.testing.assert_allclose(card.machine.topology.link_bw, cpu.machine.topology.link_bw,
                               rtol=1e-3)
    assert card.machine.hop_attenuation == pytest.approx(cpu.machine.hop_attenuation, rel=1e-3)
    assert np.isfinite(card.loss_history).all() and card.loss_history.shape == (60,)
    assert float(C.link_relative_errors(card.machine, E5_2699_V3_SNC2).max()) < 0.05


def test_fit_loop_makes_no_host_sync(cuda):
    """The fit's step loop keeps everything on the card: run under
    ``torch.cuda.set_sync_debug_mode("error")``, any synchronising call
    (a host copy of a loss, an ``item()``) would raise."""
    from repro_torch.core.numa import E7_8860_V3, link_groups
    from repro_torch.core.numa import calibrate as C

    tmpl = C.blind_template(E7_8860_V3)
    groups = link_groups(tmpl.topology)
    samples = C.collect_sweep(E7_8860_V3, device=cuda)
    sweep = C._prepare_sweep(tmpl, groups, samples, (0,))
    init = C.seed_parameters(tmpl, samples, groups)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        params, history, final_loss = C._fit_loop(tmpl, groups, sweep, init, 5, 0.03, 0.25, None)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert history.device.type == "cuda" and history.shape == (5,)
    assert torch.isfinite(history).all() and torch.isfinite(final_loss)



def test_mesh_link_fit_on_the_card_matches_cpu(cuda):
    """The mesh-domain link fit: a 4 x 4 torus with links within +-30% of
    50 GB/s, one noisy sweep (draws from a seeded generator on the card),
    fitted blind for 200 steps on the card and on the CPU from the same
    samples: every link at rel 1e-3 of the CPU's, the worst within 5% of
    the truth; the step loop makes no host sync."""
    from repro_torch.core.graphtop import from_fit, link_groups
    from repro_torch.core.meshsig import calibrate as MC
    from repro_torch.core.meshsig.device_topology import DeviceTopology, ici_torus2d

    torus = ici_torus2d(4, 4, 50e9)
    bw = 50e9 * (1 + 0.3 * np.random.default_rng(3).uniform(-1, 1, torus.graph.n_links))
    truth = DeviceTopology(graph=from_fit(torus.graph, bw))
    charges = MC.probe_suite(truth, axis_sizes_list=[{"data": 4, "model": 4}])
    gen = torch.Generator(device=cuda).manual_seed(7)
    samples = MC.collect_samples(truth, charges, noise_std=0.01, generator=gen, device=cuda)
    tmpl = MC.blind_template(truth)
    card = MC.fit_device_topology(tmpl, samples, device=cuda)
    cpu = MC.fit_device_topology(tmpl, samples, device="cpu")
    np.testing.assert_allclose(card.link_bw, cpu.link_bw, rtol=1e-3)
    assert np.isfinite(card.loss_history).all() and card.loss_history.shape == (200,)
    assert float(MC.link_relative_errors(card.topology, truth).max()) < 0.05

    index = MC._link_index(link_groups(tmpl.graph), cuda)
    log_bw = torch.log(torch.as_tensor(MC.seed_link_bw(tmpl, samples), device=cuda).float())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, history, final_loss = MC._fit_loop(index, samples, log_bw, 5, 0.05)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert history.device.type == "cuda" and history.shape == (5,)
    assert torch.isfinite(history).all() and torch.isfinite(final_loss)

def test_swap_on_the_card_matches_cpu(cuda):
    """A recalibrated spec swapped in on the card: epoch 1, a warmed table,
    and answers at rel 1e-4 of a CPU service on the same spec."""
    from repro_torch.core.numa import E7_4830_V3
    from repro_torch.launch.advisor_serve import signature_pool
    from repro_torch.serve import AdvisorService

    drifted = E7_4830_V3._replace(remote_read_bw=E7_4830_V3.remote_read_bw * 0.75,
                                  remote_write_bw=E7_4830_V3.remote_write_bw * 0.75)
    sigs = signature_pool(8, seed=9)
    with AdvisorService(device="cuda") as svc:
        handle = svc.register(E7_4830_V3, machine_id="prod")
        svc.warmup(handle, 12)
        assert svc.swap_machine(handle, drifted) == 1
        card = [svc.query(handle, s, 12, timeout=120) for s in sigs]
        assert svc.metrics.snapshot()["swaps"] == 1
    with AdvisorService(device="cpu") as svc:
        cpu = [svc.query(drifted, s, 12, timeout=120) for s in sigs]
    for g, c in zip(card, cpu):
        assert g.epoch == 1 and g.fidelity == "exact"
        assert g.objective == pytest.approx(c.objective, rel=1e-4)



# ---- backward kernels ---------------------------------------------------------

FLASH_BWD_CASES = [
    # B, H, Kv, Sq, Skv, dh, options: every HEAD_DIMS value, ragged sizes,
    # GQA 1:1 to 8:1, Skv > Sq and Sq > Skv (rows that see no key)
    (1, 4, 4, 77, 77, 16, {}),
    (2, 4, 2, 130, 130, 32, dict(window=40)),
    (1, 8, 2, 200, 200, 64, dict(logit_cap=5.0)),
    (1, 4, 1, 150, 150, 80, dict(window=64)),
    (1, 8, 1, 96, 96, 128, {}),
    (1, 2, 1, 100, 100, 256, dict(window=50, logit_cap=3.0)),
    (1, 4, 2, 60, 100, 64, {}),
    (1, 4, 2, 40, 40, 32, dict(causal=False)),
    (1, 2, 2, 100, 60, 32, {}),
    # the bf16 kernel's tile edges (64-row q steps, 128-key KV tiles, 64 at
    # dh 256; 128-row dQ tiles): Skv no multiple of 64 or 128, dh 80 (padded
    # to 128) with Sq > Skv, GQA 8:1 with a window edge inside a tile, dh 256
    # (two consumers splitting dh) with the soft-cap
    (1, 4, 2, 300, 333, 128, {}),
    (1, 4, 2, 200, 100, 80, {}),
    (1, 16, 2, 300, 300, 128, dict(window=100)),
    (1, 2, 1, 333, 333, 256, dict(logit_cap=5.0)),
    # the float32 kernel's tile edges (64 x 64 score tiles, 32 x 32 at dh
    # 256; only tiles the diagonal, the window or a ragged end crosses test
    # each element): Skv no multiple of 64, a window edge inside a 64-key
    # tile, dh 256 with the soft-cap, Sq > Skv, GQA 8:1
    (1, 4, 2, 150, 190, 64, {}),
    (1, 4, 2, 260, 260, 128, dict(window=90)),
    (1, 2, 1, 150, 150, 256, dict(logit_cap=5.0)),
    (1, 4, 2, 200, 130, 64, {}),
    (1, 16, 2, 140, 140, 80, dict(window=70)),
    # whisper's non-causal cross-attention (MHA, dh 64), Sq < Skv and Sq >
    # Skv, ragged: the dK/dV pass's row range must not take the q offset
    (1, 4, 4, 40, 75, 64, dict(causal=False)),
    (1, 4, 4, 75, 40, 64, dict(causal=False)),
    (2, 16, 16, 130, 333, 64, dict(causal=False)),
]
# each gradient within this share of its largest magnitude: float32
# products in both, bf16 outputs rounded once
FLASH_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _rel_to_scale(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Kv,Sq,Skv,dh,kwargs", FLASH_BWD_CASES)
def test_flash_backward_kernel_matches_plain_version(cuda, dtype, B, H, Kv, Sq, Skv, dh, kwargs):
    """dq, dk and dv from the forward's log-sum-exp, against the plain
    backward; two calls give equal bits (no atomics); rows that see no
    key get zero dq.  Each option (window, soft-cap, non-causal) and the
    GQA group sum moves the plain gradient past the tolerance when
    dropped, so a kernel that ignored it would fail."""
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

    q, k, v = _qkv(6, B, H, Kv, Sq, Skv, dh, dtype, cuda, qk_std=1.0)
    dout = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(1),
                       device=cuda).to(dtype)
    lse = torch.empty((B, H, Sq), device=cuda)
    out = flash_kernel.flash_attention(q, k, v, lse=lse, **kwargs)
    before = flash_kernel.flash_attention_bwd.launches
    first = flash_kernel.flash_attention_bwd(q, k, v, out, dout, lse, **kwargs)
    second = flash_kernel.flash_attention_bwd(q, k, v, out, dout, lse, **kwargs)
    torch.cuda.synchronize()
    assert flash_kernel.flash_attention_bwd.launches == before + 2
    want = attention_bwd_ref(q, k, v, dout, **kwargs)
    for name, g, w, g2 in zip("qkv", first, want, second):
        assert g.dtype == dtype and g.shape == w.shape
        assert bool(torch.isfinite(g.float()).all()), name
        assert _rel_to_scale(g, w) <= FLASH_BWD_TOL[dtype], name
        assert torch.equal(g, g2), name
    if Sq > Skv and kwargs.get("causal", True):  # non-causal rows see every key
        assert not first[0][:, :, : Sq - Skv].any()
    for name in kwargs:
        without = attention_bwd_ref(q, k, v, dout, **{o: x for o, x in kwargs.items() if o != name})
        assert max(_rel_to_scale(a, b) for a, b in zip(without, want)) > FLASH_BWD_TOL[dtype], name
    if Kv < H:  # the dk and dv of each group's first q-head alone
        G = H // Kv
        _, dk1, dv1 = attention_bwd_ref(q[:, ::G], k, v, dout[:, ::G], **kwargs)
        assert max(_rel_to_scale(dk1, want[1]), _rel_to_scale(dv1, want[2])) > FLASH_BWD_TOL[dtype]


def test_f32_flash_backward_reads_unaligned_views(cuda):
    """float32 operands whose base lies 4 bytes off 16 take the 4-byte
    copies and stores: the gradients equal, bit for bit, those from the same
    values at aligned addresses."""
    q, k, v = _qkv(12, 1, 4, 2, 100, 100, 64, torch.float32, cuda, qk_std=1.0)
    dout = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(3),
                       device=cuda)
    lse = torch.empty((1, 4, 100), device=cuda)
    out = flash_kernel.flash_attention(q, k, v, lse=lse)

    def shifted(t):
        return torch.empty(t.numel() + 1, device=cuda)[1:].view(t.shape).copy_(t)

    want = flash_kernel.flash_attention_bwd(q, k, v, out, dout, lse)
    grads = tuple(shifted(torch.zeros_like(t)) for t in (q, k, v))
    got = flash_kernel.flash_attention_bwd(shifted(q), shifted(k), shifted(v), shifted(out),
                                           shifted(dout), lse, grads=grads)
    assert all(g.data_ptr() % 16 != 0 for g in got)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_bf16_flash_backward_rejects_a_view_tma_cannot_read(cuda):
    """A dout whose base lies 2 bytes off 16 raises: the bf16 backward reads
    through TMA and neither copies nor falls back."""
    q, k, v = _qkv(8, 1, 4, 2, 64, 64, 64, torch.bfloat16, cuda)
    lse = torch.empty((1, 4, 64), device=cuda)
    out = flash_kernel.flash_attention(q, k, v, lse=lse)
    shifted = torch.empty(out.numel() + 1, dtype=torch.bfloat16, device=cuda)[1:].view(out.shape)
    shifted.copy_(out)
    before = flash_kernel.flash_attention_bwd.launches
    with pytest.raises(ValueError, match="16-byte"):
        flash_kernel.flash_attention_bwd(q, k, v, out, shifted, lse)
    assert flash_kernel.flash_attention_bwd.launches == before


def test_mha_flash_copies_an_output_gradient_tma_cannot_read(cuda):
    """Under autograd, an output gradient whose base lies 2 bytes off 16 is
    copied before the bf16 backward reads it: the gradients equal, bit for
    bit, those from the same values at an aligned address."""
    q, k, v = (t.transpose(1, 2).contiguous()
               for t in _qkv(10, 1, 4, 2, 64, 64, 64, torch.bfloat16, cuda))
    g = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(2),
                    device=cuda).to(torch.bfloat16)
    shifted = torch.empty(g.numel() + 1, dtype=torch.bfloat16, device=cuda)[1:].view(g.shape)
    shifted.copy_(g)
    assert shifted.data_ptr() % 16 != 0
    grads = []
    for upstream in (g, shifted):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        mha_flash(*leaves, causal=True).backward(upstream)
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_bf16_flash_kernels_run_in_a_thread_without_a_cuda_context(cuda):
    """A thread that has made no CUDA call has no current context, which
    encoding a TMA tensor map needs: the bf16 forward and backward bind
    q's device themselves (autograd's backward thread is such a thread
    when the attention gradient is the first kernel it runs)."""
    import threading

    q, k, v = _qkv(11, 1, 4, 2, 64, 64, 64, torch.bfloat16, cuda)
    lse = torch.empty((1, 4, 64), device=cuda)
    out = torch.empty_like(q)
    grads = tuple(torch.empty_like(t) for t in (q, k, v))
    torch.cuda.synchronize()
    errors = []

    def work():
        try:
            flash_kernel.flash_attention(q, k, v, lse=lse, out=out)
            flash_kernel.flash_attention_bwd(q, k, v, out, out, lse, grads=grads)
        except Exception as e:  # noqa: BLE001 (reported by the main thread)
            errors.append(e)

    worker = threading.Thread(target=work)
    worker.start()
    worker.join(timeout=120)
    assert not worker.is_alive() and not errors, errors
    torch.cuda.synchronize()
    want = attention_ref(q, k, v)
    torch.testing.assert_close(out.float(), want.float(), **FLASH_TOL[torch.bfloat16])


def test_bf16_flash_backward_library_runs_on_the_tensor_cores(cuda):
    """The bf16 backward's SASS holds wgmma (HGMMA) instructions; the
    float32 one, on CUDA cores, none."""
    import shutil
    import subprocess

    from repro_torch.kernels import build

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    counts = {}
    for dtype, source in flash_kernel.BWD_SOURCES.items():
        sass = subprocess.run([cuobjdump, "-sass", str(build.build(source))], capture_output=True,
                              text=True, check=True, timeout=120).stdout
        counts[dtype] = sass.count("HGMMA")
    assert counts[torch.bfloat16] > 0 and counts[torch.float32] == 0, counts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mha_flash_gradients_on_the_card_match_cpu(cuda, dtype):
    """Through autograd in the model's layout, GQA 4:1 with a window."""
    q, k, v = (t.transpose(1, 2).contiguous()
               for t in _qkv(7, 2, 8, 2, 96, 96, 64, dtype, cuda, qk_std=1.0))
    grads = []
    for dev in (cuda, "cpu"):
        leaves = [t.to(dev).detach().requires_grad_() for t in (q, k, v)]
        mha_flash(*leaves, causal=True, window=40).float().square().sum().backward()
        grads.append([t.grad.cpu() for t in leaves])
    for g, w in zip(*grads):
        assert _rel_to_scale(g, w) <= FLASH_BWD_TOL[dtype]


# the backward's own edges: 32 / 64 / 128-channel blocks at N = 16 / 8 / 4
# (d_inner no multiple of them) and S ending inside a 16-step chunk, in its
# first or its second half
SCAN_BWD_SHAPES = SHAPES + [(2, 203, 200, 16), (2, 150, 100, 8), (1, 77, 300, 4),
                            (1, 44, 330, 16), (2, 90, 160, 8)]


@pytest.mark.parametrize("B,S,di,n", SCAN_BWD_SHAPES)
def test_scan_backward_kernel_matches_plain_version(cuda, B, S, di, n):
    """ddt, dA, dB, dC and dx from the forward's saved chunk states, at
    rel 1e-4 of each gradient's scale; one launch a call; two calls give
    equal bits (the channel sums run in a fixed order)."""
    from repro_torch.kernels.mamba_scan.ref import selective_scan_bwd_ref

    dt, a, b, c, x = _inputs(5, B, S, di, n, cuda)
    dy = _inputs(6, B, S, di, n, cuda)[4]
    y, states = scan_kernel.selective_scan(dt, a, b, c, x, save_states=True)
    torch.testing.assert_close(y, scan_kernel.selective_scan(dt, a, b, c, x), rtol=0, atol=0)
    before = scan_kernel.selective_scan_bwd.launches
    first = scan_kernel.selective_scan_bwd(dt, a, b, c, x, dy, states)
    second = scan_kernel.selective_scan_bwd(dt, a, b, c, x, dy, states)
    torch.cuda.synchronize()
    assert scan_kernel.selective_scan_bwd.launches == before + 2
    want = selective_scan_bwd_ref(dt, a, b, c, x, dy)
    for name, g, w, g2 in zip(("ddt", "da", "db", "dc", "dx"), first, want, second):
        assert g.shape == w.shape, name
        assert _rel_to_scale(g, w) <= 1e-4, name
        assert torch.equal(g, g2), name


@pytest.mark.parametrize("n", [8, 16])
def test_scan_backward_partials_do_not_depend_on_the_slices(cuda, n):
    """dB and dC come back as partial slices (one per 32-channel set of a
    block) summed by the wrapper: at three slice counts they match the plain
    version within rel 1e-5 of their scale, and channels repeated m times
    give m times the one-copy dB and dC (rel 1e-6)."""
    from repro_torch.kernels.mamba_scan.ref import selective_scan_bwd_ref

    B, S, tile = 2, 75, 32
    base = _inputs(13, B, S, tile, n, cuda)
    dy = _inputs(14, B, S, tile, n, cuda)[4]
    one, slices = None, set()
    for m in (1, 3, 5):
        dt, a, b, c, x = (t.repeat(1, 1, m) if t.dim() == 3 and t.shape[-1] == tile
                          else t.repeat(m, 1) if t.dim() == 2 else t for t in base)
        dym = dy.repeat(1, 1, m)
        slices.add(scan_kernel.bwd_layout(tile * m, n)["slices"])
        _, states = scan_kernel.selective_scan(dt, a, b, c, x, save_states=True)
        got = scan_kernel.selective_scan_bwd(dt, a, b, c, x, dym, states)
        want = selective_scan_bwd_ref(dt, a, b, c, x, dym)
        for name, g, w in zip(("ddt", "da", "db", "dc", "dx"), got, want):
            assert _rel_to_scale(g, w) <= 1e-5, (m, name)
        if m == 1:
            one = got
        for g, g1 in zip(got[2:4], one[2:4]):
            assert _rel_to_scale(g, m * g1) <= 1e-6, m
    assert len(slices) == 3, slices


def test_scan_backward_kernel_keeps_its_state_in_registers(cuda):
    """At N = 16 the backward keeps its chunk's states and exponentials in
    registers without spilling, and two blocks fit an SM."""
    occupancy = scan_kernel.bwd_occupancy(16)
    assert occupancy["local_bytes"] == 0 and occupancy["blocks_per_sm"] >= 2, occupancy


def test_scan_backward_kernel_reads_unaligned_views(cuda):
    """dt, x, dy, B and C starting 4 bytes into their storage take the
    4-byte copies, as the forward does."""
    from repro_torch.kernels.mamba_scan.ref import selective_scan_bwd_ref

    B, S, di, n = 2, 100, 64, 16
    arrays = _inputs(7, B, S, di, n, cuda)
    dy = _inputs(8, B, S, di, n, cuda)[4]

    def shifted(t):
        view = torch.empty(t.numel() + 1, device=cuda)[1:].view(t.shape)
        return view.copy_(t)

    dt, a, b, c, x = (shifted(t) for t in arrays)
    dys = shifted(dy)
    assert dt.data_ptr() % 16 != 0 and dys.data_ptr() % 16 != 0
    _, states = scan_kernel.selective_scan(*arrays, save_states=True)
    got = scan_kernel.selective_scan_bwd(dt, a, b, c, x, dys, states)
    want = selective_scan_bwd_ref(*arrays, dy)
    for g, w in zip(got, want):
        assert _rel_to_scale(g, w) <= 1e-4


def test_backward_kernels_need_the_forward_residuals(cuda):
    """No quiet recomputation: the CUDA backwards raise without the
    forward's log-sum-exp or states."""
    q, k, v = _qkv(9, 1, 2, 1, 32, 32, 32, torch.float32, cuda)
    out = flash_kernel.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="lse"):
        flash_kernel.flash_attention_bwd(q, k, v, out, out, None)
    dt, a, b, c, x = _inputs(9, 1, 32, 16, 8, cuda)
    with pytest.raises(ValueError, match="states"):
        scan_kernel.selective_scan_bwd(dt, a, b, c, x, x, None)


@pytest.mark.parametrize("name", ["llama3-8b", "gemma2-9b", "falcon-mamba-7b",
                                  "qwen3-moe-30b-a3b"])
def test_reduced_train_step_on_the_card_matches_cpu(cuda, name):
    """One float32 train step with the same weights and batch: loss within
    rel 1e-4, gradient norm within rel 1e-3; K1's backward once per
    attention layer, K2's once per mamba layer, and each forward twice
    (the backward recomputes every layer group's forward)."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.optim import adamw

    cfg = dataclasses.replace(get_config(name).reduced(), compute_dtype="float32")
    tokens = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 41)),
                             dtype=torch.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    kinds = [M.slot_kinds(cfg, i % cfg.group_size)[0] for i in range(cfg.n_layers)]
    results = {}
    for dev in ("cpu", cuda):
        params = M.train_mode(M.init_params(cfg, torch.Generator().manual_seed(0),
                                            device="cpu").to(dev))
        opt = adamw.init(steps.param_tree(params), cfg.moment_dtype)
        step = steps.make_train_step(cfg, lr_schedule=adamw.cosine_schedule(1e-3, 0, 10))
        counts = [flash_kernel.flash_attention.launches, flash_kernel.flash_attention_bwd.launches,
                  scan_kernel.selective_scan.launches, scan_kernel.selective_scan_bwd.launches]
        _, _, metrics = step(params, opt, {k: v.to(dev) for k, v in batch.items()}, 0)
        torch.cuda.synchronize()
        after = [flash_kernel.flash_attention.launches, flash_kernel.flash_attention_bwd.launches,
                 scan_kernel.selective_scan.launches, scan_kernel.selective_scan_bwd.launches]
        results[str(dev)] = (metrics, [b - a for a, b in zip(counts, after)])
    (cpu_m, cpu_counts), (card_m, card_counts) = results["cpu"], results[str(cuda)]
    assert cpu_counts == [0, 0, 0, 0]
    n_attn, n_mamba = kinds.count("attn"), kinds.count("mamba")
    assert card_counts == [2 * n_attn, n_attn, 2 * n_mamba, n_mamba]
    assert abs(float(card_m["loss"]) - float(cpu_m["loss"])) <= 1e-4 * abs(float(cpu_m["loss"]))
    assert abs(float(card_m["grad_norm"]) - float(cpu_m["grad_norm"])) <= \
        1e-3 * float(cpu_m["grad_norm"])


@pytest.mark.parametrize("impl", ["gather", "a2a"])
def test_one_rank_nccl_mesh_forward_matches_no_mesh(cuda, tmp_path, impl):
    """Reduced qwen3-moe-30b-a3b through the mesh code on one NCCL rank
    (every collective spans one rank): the prefill logits and decode
    steps equal the no-mesh path's on the card, bit for bit; the no-gather
    decode path is taken (the replication share set to nothing)."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.parallel import context as ctx

    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b").reduced(), moe_impl=impl)
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))

    def run():
        logits = [steps.make_prefill_step(cfg)(params_of(), {"tokens": tokens})]
        cache = M.init_cache(cfg, 2, 16, torch.bfloat16, device="cuda")
        step = steps.make_decode_step(cfg)
        for t in range(4):
            _, lg, cache = step(params_of(), cache, tokens[:, t : t + 1], t)
            logits.append(lg)
        return logits

    def params_of():
        return mesh_lib.shard_params(cfg, params)

    want = run()
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        mesh = ctx.make_mesh((1, 1), ("data", "model"))
        share = mesh_lib.SERVE_REPLICATION_SHARE
        mesh_lib.SERVE_REPLICATION_SHARE = 0.0
        try:
            with mesh_lib.cell_context(mesh, cfg, ShapeConfig("p", 16, 2, "prefill")):
                assert ctx.physical_axes("efsdp") == ("data",)
                got = run()
        finally:
            mesh_lib.SERVE_REPLICATION_SHARE = share
    finally:
        dist.destroy_process_group()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_split_products_stay_half_precision_gemms_with_float32_output(cuda, dtype):
    """``context.product_f32``, the partial product of every row-split
    layer across ranks (``wo``, SwiGLU ``w_down``, mamba ``x_proj`` and
    ``out_proj``, the no-gather MoE buffers): on the card a half-precision
    GEMM writing float32 equals the product of the widened operands to
    float32 rounding, and keeps the bits a rounding to ``dtype`` drops;
    a column slice (``attention._project_out``) and a batched product too."""
    from repro_torch.parallel import context as ctx

    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(2, 16, 256, device=cuda, generator=g).to(dtype)
    cases = [
        (a, torch.randn(256, 96, device=cuda, generator=g).to(dtype)),
        (a[..., 64:192], torch.randn(128, 96, device=cuda, generator=g).to(dtype)),
        (torch.randn(8, 33, 64, device=cuda, generator=g).to(dtype),
         torch.randn(8, 64, 48, device=cuda, generator=g).to(dtype)),
    ]
    for x, w in cases:
        got = ctx.product_f32(x, w)
        want = x.float() @ w.float()
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
        assert not torch.equal(got, got.to(dtype).float())


def test_one_rank_collectives_pass_gradients_through(cuda, tmp_path):
    """On one NCCL rank every differentiable collective returns its input
    and its backward the input's gradient (CUDA tensors, bf16 and
    float32), and the mesh train step of reduced llama3-8b in bf16 (the
    hoisted compute copy, float32 gradient buffers) gives the no-mesh
    step's loss, gradient norm and parameters bit for bit."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.parallel import context as ctx

    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        mesh = ctx.make_mesh((1, 1), ("data", "model"))
        axes = mesh.axis_names
        ops = [
            lambda x: ctx.psum(x, axes),
            lambda x: ctx.pmean(x, axes),
            lambda x: ctx.fan_out(x, axes),
            lambda x: ctx.fan_out(x, ("model",), keys=[0]),
            lambda x: ctx.all_gather(x, axes, 0, adjoint="slice"),
            lambda x: ctx.all_gather(x, axes, 1, adjoint="sum"),
            lambda x: ctx.all_to_all(x, ("model",)),
            lambda x: ctx.matmul_psum(x, torch.eye(8, device=cuda, dtype=x.dtype), ("model",)),
        ]
        g = torch.Generator(device="cuda").manual_seed(0)
        with ctx.use_mesh(mesh):
            for dtype in (torch.float32, torch.bfloat16):
                for i, op in enumerate(ops):
                    x = torch.randn(1, 8, device=cuda, generator=g).to(dtype).requires_grad_()
                    cot = torch.randn(1, 8, device=cuda, generator=g).to(dtype)
                    y = op(x)
                    assert torch.equal(y, x), (i, dtype)
                    y.backward(cot)
                    assert torch.equal(x.grad, cot), (i, dtype)

        cfg = get_config("llama3-8b").reduced()  # bf16 compute, float32 masters
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 16), device=cuda, generator=g,
                                         dtype=torch.int32)}
        batch["labels"] = torch.roll(batch["tokens"], -1, 1)

        def train(cell):
            params = M.train_mode(M.init_params(
                cfg, torch.Generator(device="cuda").manual_seed(1), device="cuda"))
            step = steps.make_train_step(cfg, accum=2,
                                         lr_schedule=adamw.cosine_schedule(1e-3, 0, 2))
            with cell:
                local = mesh_lib.shard_params(cfg, params)
                opt = adamw.init(steps.param_tree(local), cfg.moment_dtype)
                hist = []
                for s in range(2):
                    _, opt, m = step(local, opt, batch, s)
                    hist.append((float(m["loss"]), float(m["grad_norm"])))
            return hist, [p.detach().clone() for p in local.parameters()]

        import contextlib

        want, want_params = train(contextlib.nullcontext())
        got, got_params = train(mesh_lib.cell_context(mesh, cfg, ShapeConfig("t", 16, 4, "train")))
    finally:
        dist.destroy_process_group()
    assert got == want
    for a, b in zip(got_params, want_params):
        assert torch.equal(a, b)


def test_kernel_counts_on_the_card_equal_their_meta_branches(cuda):
    """Each kernel wrapper counts the same work for a card call as for
    the same call on ``meta``, whose branch allocates the card's outputs
    (K1's with the log-sum-exp; K2's chunk states and partials) and
    launches nothing."""
    from repro_torch.parallel import context as ctx

    rng = np.random.default_rng(5)

    def pair(shape, dtype):
        t = torch.as_tensor(rng.standard_normal(shape).astype(np.float32)).to(dtype)
        return t.to(cuda), torch.empty(shape, dtype=dtype, device="meta")

    B, H, Kv, S, dh = 2, 8, 2, 300, 64
    (q, qm), (k, km), (v, vm), (do, dom) = (
        pair(s, torch.bfloat16) for s in ((B, H, S, dh), (B, Kv, S, dh), (B, Kv, S, dh),
                                          (B, H, S, dh)))
    runs = {}
    for dev, (q_, k_, v_, do_) in (("cuda", (q, k, v, do)), ("meta", (qm, km, vm, dom))):
        mode = "simulate" if dev == "meta" else "observe"
        lse = torch.empty((B, H, S), dtype=torch.float32, device=dev)
        before = flash_kernel.flash_attention.launches, flash_kernel.flash_attention_bwd.launches
        with ctx.record(mode) as rec:
            out = flash_kernel.flash_attention(q_, k_, v_, window=128, lse=lse)
            grads = flash_kernel.flash_attention_bwd(q_, k_, v_, out, do_, lse, window=128)
        after = flash_kernel.flash_attention.launches, flash_kernel.flash_attention_bwd.launches
        runs[dev] = (rec.kernels, [t.shape for t in (out, *grads)],
                     tuple(a - b for a, b in zip(after, before)))
    assert runs["cuda"][:2] == runs["meta"][:2]
    assert runs["cuda"][2] == (1, 1) and runs["meta"][2] == (0, 0)

    dt, a, b, c, x = _inputs(6, 2, 333, 100, 16, cuda)
    dy = _inputs(7, 2, 333, 100, 16, cuda)[4]
    runs = {}
    for dev in ("cuda", "meta"):
        args = [t.to(dev) for t in (dt, a, b, c, x, dy)]
        mode = "simulate" if dev == "meta" else "observe"
        with ctx.record(mode) as rec:
            y, states = scan_kernel.selective_scan(*args[:5], save_states=True)
            grads = scan_kernel.selective_scan_bwd(*args, states)
        runs[dev] = (rec.kernels, [t.shape for t in (y, states, *grads)])
    assert runs["cuda"] == runs["meta"]


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_counted_step_on_the_card_equals_meta(cuda, kind):
    """The counter source at one rank: reduced llama3's step counted on
    the card (``"observe"``) and on ``meta`` (``"simulate"``) gives equal
    FLOPs, bytes and argument sizes, and no collective."""
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.core.meshsig.counters import count_program
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.parallel import context as ctx

    cfg = get_config("llama3-8b").reduced()
    shape = ShapeConfig("c", 32, 4, kind)
    mesh = ctx.Mesh(("data", "model"), (1, 1), 0)
    with mesh_lib.cell_context(mesh, cfg, shape):
        fn, args, _ = dryrun.build_cell(cfg, shape, device="cuda")
        card = count_program(fn, *args, mode="observe")
    meta, _ = dryrun.profile_cell(cfg, shape, mesh)
    assert card.flops == meta.flops and card.hbm_bytes == meta.hbm_bytes
    assert card.kernels == meta.kernels
    assert card.memory["argument_size_in_bytes"] == meta.memory["argument_size_in_bytes"]
    assert not card.collectives and not meta.collectives


def _tiny_hybrid(cuda):
    """The tiny one-period AI21-Jamba2-Mini stage of the benchmark's tests,
    bf16 weights as a server holds them."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the benchmark's package
    from portbench import weights
    from portbench.families import hybrid as fam
    from portbench.tests import _tiny
    from portbench.tests._tiny_hybrid import HYBRID

    cfg = HYBRID
    held = weights.make(fam.layout(cfg), torch.Generator(device=cuda).manual_seed(3),
                        lambda name: weights.serve_dtype(fam, name, torch.bfloat16), cuda)
    mcfg = _tiny.model_config(cfg)
    return cfg, mcfg, fam.build(mcfg, held)


def test_hybrid_served_request_makes_no_host_sync(cuda):
    """One served prefill of the tiny Jamba2-Mini stage (attention through
    K1, mamba through K2 and the mixer passes, the dropless experts
    through the grouped products) under ``set_sync_debug_mode("error")``,
    bit-equal to the request served before it."""
    from repro_torch.launch import steps
    from repro_torch.models import moe

    cfg, mcfg, lm = _tiny_hybrid(cuda)
    step = steps.make_prefill_step(mcfg)
    tokens = torch.randint(0, cfg["vocab_size"], (1, 200), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    first = step(lm, {"tokens": tokens})
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with moe.choice_record() as choices:
            again = step(lm, {"tokens": tokens})
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert len(choices) == 4 and torch.equal(again, first) and bool(torch.isfinite(first).all())


def test_mixer_without_inner_norms_keeps_its_bits(cuda):
    """falcon-mamba-7b's reduced mixer served on the card (norms off) is
    bit-equal to its pre-scan products computed as they were before the
    inner norms existed."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import mamba as mb
    from repro_torch.parallel import context as ctx

    cfg = get_config("falcon-mamba-7b").reduced()
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = mb.init_mamba_params(cfg, gen, torch.bfloat16, cuda)
    x = torch.randn(2, 160, cfg.d_model, device=cuda, generator=gen).bfloat16()

    def before(cfg_, p_, x_conv):
        dtr, n = cfg_.dt_rank_actual, cfg_.ssm_state
        tp = ctx.physical_axes("tp")
        x_dbl = ctx.fan_out(ctx.matmul_psum(x_conv, p_.x_proj, tp), tp)
        dt, b, c = x_dbl.split([dtr, n, n], dim=-1)
        return dt @ p_.dt_proj, b.float(), c.float()

    with torch.no_grad():
        now = mb.mamba_mixer(cfg, p, x)
        projections, mb._projections = mb._projections, before
        try:
            then = mb.mamba_mixer(cfg, p, x)
        finally:
            mb._projections = projections
    assert p.dt_norm is None and torch.equal(now, then)
