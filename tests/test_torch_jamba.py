"""AI21-Jamba2-Mini's layer pattern through the port on the CPU, against
the benchmark's plain float32 reference (``portbench/reference/hybrid.py``,
which imports nothing of the port) at tiny widths on seeded weights: the
full forward and the served prefill with the reference forced to the
program's expert choices, teacher-forced decode steps through the mamba
state and the KV cache against the reference's full forward, the dropless
MoE against a loop over the experts, and one case for each of the
published model's departures from the repository's jamba (no rotary
embedding, attention at slot 4, the mixer's inner norms, top-2 not
renormalised), each of which fails with that departure undone."""

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the benchmark's package

from portbench.families import hybrid as fam  # noqa: E402
from portbench.reference import common as C  # noqa: E402
from portbench.reference import hybrid as ref  # noqa: E402
from portbench.tests import _tiny  # noqa: E402
from portbench.tests._tiny_hybrid import HYBRID  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402

CFG = dict(HYBRID, compute_dtype="float32")
S = 24


def _model(**change):
    mcfg = dataclasses.replace(_tiny.model_config(CFG), **change)
    w = _tiny.leaves(fam, CFG, seed=3)
    return mcfg, w, fam.build(mcfg, w)


def _tokens(B=2, S=S, seed=5):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, CFG["vocab_size"], (B, S), generator=gen)


def _reference(w, tokens, forced):
    with torch.no_grad(), ref.routing(forced=forced) as routes:
        h = C.hidden(ref, CFG, w, tokens, "float32")
    return C.logits(CFG, w, h, "float32"), routes


def _close(got, want, rel=1e-4):
    got = got[..., : CFG["vocab_size"]].float()
    return float((got - want).abs().max()) <= rel * float(want.abs().max())


def test_layer_kinds_follow_the_published_keys():
    mcfg = _tiny.model_config(CFG)
    assert [M.slot_kinds(mcfg, s)[0] for s in range(8)] == [
        ref.mixer_kind(CFG, s) for s in range(8)] == ["mamba"] * 4 + ["attn"] + ["mamba"] * 3
    assert [M.slot_kinds(mcfg, s)[2] for s in range(8)] == [ref.ffn_kind(CFG, s)
                                                            for s in range(8)]
    assert M.tree_param_count(mcfg) == sum(t.numel() for t in _model()[2].parameters())


def test_forward_and_prefill_match_the_reference_under_its_choices():
    mcfg, w, lm = _model()
    tokens = _tokens()
    with torch.no_grad(), moe.choice_record() as choices:
        logits, _ = M.forward(mcfg, lm, {"tokens": tokens})
    want, routes = _reference(w, tokens, choices)
    assert _close(logits, want)
    # float32 on both sides: the reference's own choices are the program's
    assert all(torch.equal(a, b) for a, b in zip(routes.chosen, choices, strict=True))
    last = steps.make_prefill_step(mcfg)(lm, {"tokens": tokens})
    assert _close(last, want[:, -1])


def test_decode_through_the_caches_matches_the_full_forward():
    """Teacher-forced decode steps from position 0 (float32 caches: the
    mamba conv window and state, the attention layer's K/V) against the
    reference's full forward under the steps' choices."""
    mcfg, w, lm = _model()
    tokens = _tokens()
    B = tokens.shape[0]
    cache = M.init_cache(mcfg, B, S, torch.float32, device="cpu")
    step = steps.make_decode_step(mcfg)
    got, per_step = [], []
    for t in range(S):
        with moe.choice_record() as choices:
            _, logits, cache = step(lm, cache, tokens[:, t:t + 1], t)
        got.append(logits)
        per_step.append(choices)
    # each MoE layer's choices, (S, B, k) -> the forward's (B * S, k) rows
    forced = [torch.stack(layer).transpose(0, 1).reshape(B * S, -1)
              for layer in zip(*per_step, strict=True)]
    want, _ = _reference(w, tokens, forced)
    assert _close(torch.stack(got, 1), want, rel=2e-4)


def _loop_moe(cfg, x, router, wg, wu, wd):
    """Each token through its top-k experts by the float32 softmax, one
    token at a time, the probabilities as ``cfg`` takes them."""
    probs = torch.softmax(x.float() @ router, -1)
    out = torch.zeros_like(x)
    for t in range(x.shape[0]):
        p, e = torch.topk(probs[t], cfg.experts_per_token)
        if cfg.moe_renormalize:
            p = p / p.sum()
        for pj, ej in zip(p, e, strict=True):
            out[t] += pj * (torch.nn.functional.silu(x[t] @ wg[ej]) * (x[t] @ wu[ej])) @ wd[ej]
    return out


@pytest.mark.parametrize("router", ["random", "one_expert"])
def test_dropless_moe_is_the_loop_over_experts(router):
    """The grouped path against a loop; with every token's first choice
    on expert 0, the capacity path drops and the dropless one does not."""
    mcfg = _tiny.model_config(CFG)
    gen = torch.Generator().manual_seed(7)
    T, D, F, E = 40, CFG["d_model"], CFG["d_ff"], CFG["n_experts"]
    x = torch.randn(T, D, generator=gen)
    r = torch.randn(D, E, generator=gen) * D**-0.5
    if router == "one_expert":
        x[:, 0] = x[:, 0].abs() + 1.0
        r[0, 0] = 50.0
    wg, wu = (torch.randn(E, D, F, generator=gen) * D**-0.5 for _ in range(2))
    wd = torch.randn(E, F, D, generator=gen) * F**-0.5
    want = _loop_moe(mcfg, x, r, wg, wu, wd)
    with moe.drop_tally() as drops:
        got, _ = moe.local_moe(mcfg, x, r, wg, wu, wd)
    assert drops == [] and torch.allclose(got, want, atol=1e-5, rtol=1e-4)
    if router == "one_expert":
        capped = dataclasses.replace(mcfg, moe_dropless=False)
        with moe.drop_tally() as drops:
            kept, _ = moe.local_moe(capped, x, r, wg, wu, wd)
        assert int(sum(drops)) > 0 and not torch.allclose(kept, want, atol=1e-3)


def test_dropless_moe_refuses_the_mesh_paths():
    from repro_torch.parallel import context as ctx

    mcfg = _tiny.model_config(CFG)
    w = _tiny.leaves(fam, CFG)
    p = moe.MoE(*(w["layers.1.ffn." + k] for k in moe.MoE.LEAVES))
    x = torch.zeros(1, 4, CFG["d_model"])
    with ctx.use_mesh(ctx.Mesh(("data", "model"), (1, 1), 0)):
        for impl in ("gather", "a2a"):
            with pytest.raises(ValueError, match="dropless"):
                moe.moe_apply(dataclasses.replace(mcfg, moe_impl=impl), p, x)


@pytest.mark.parametrize("undone", [dict(rotary=True), dict(attn_offset=0),
                                    dict(ssm_inner_norms=False), dict(moe_renormalize=True)],
                         ids=lambda d: next(iter(d)))
def test_each_departure_is_pinned(undone):
    """With one of the published model's departures from the
    repository's jamba undone, the program parts from the reference (or
    finds no leaves where it would put attention)."""
    tokens = _tokens(B=1)
    try:
        mcfg, w, lm = _model(**undone)
    except KeyError:
        assert "attn_offset" in undone
        return
    with torch.no_grad(), moe.choice_record() as choices:
        logits, _ = M.forward(mcfg, lm, {"tokens": tokens})
    want, _ = _reference(w, tokens, choices)
    assert not _close(logits, want, rel=1e-2)
