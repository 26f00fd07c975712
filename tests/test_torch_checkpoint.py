"""The port's checkpoint store and fault-tolerant runtime against the
reference: round trips (bf16 leaves, leaves chunked over their leading
axis, int and 0-d leaves, named tuples), checkpoints written by either
package restored by the other (a generic tree and a reduced LM's
reference-shaped parameter tree), ``latest_step``, the async
checkpointer, the straggler monitor, and a ``TrainLoop`` killed mid-run
and resumed on the CPU, bit-identical to an uninterrupted run, with a
real train step of a reduced LM."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as ref_store
from repro.configs.base import get_config as ref_get_config
from repro.models import model as RM
from repro.optim.adamw import AdamWState as RefAdamWState
from repro_torch.checkpoint import store
from repro_torch.configs.base import get_config
from repro_torch.convert import lm_params_from_reference, lm_params_to_reference
from repro_torch.data.pipeline import TokenStream
from repro_torch.launch import steps
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWState
from repro_torch.runtime.fault_tolerance import FailureInjector, StragglerMonitor, TrainLoop


def _arrays(seed=0):
    """numpy values of a state tree: float32, int32, bf16 (as float32
    values that bf16 holds exactly), a big leaf and a 0-d step."""
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((64, 32)).astype(np.float32),
        "b": np.arange(8, dtype=np.int32),
        "m": rng.standard_normal((16, 8)).astype(np.float32),  # stored as bf16
        "big": rng.standard_normal((4, 300_000)).astype(np.float32),
        "step": np.int32(7),
    }


def _port_tree(a):
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    t["m"] = t["m"].to(torch.bfloat16)
    return ({"w": t["w"], "nested": {"b": t["b"]}, "m": t["m"], "big": t["big"]},
            AdamWState(step=t["step"], m={"x": t["w"] * 2}, v={"x": t["w"] * 3}))


def _ref_tree(a):
    j = {k: jnp.asarray(v) for k, v in a.items()}
    j["m"] = j["m"].astype(jnp.bfloat16)
    return ({"w": j["w"], "nested": {"b": j["b"]}, "m": j["m"], "big": j["big"]},
            RefAdamWState(step=j["step"], m={"x": j["w"] * 2}, v={"x": j["w"] * 3}))


def _leaves(tree):
    return [leaf for _, leaf in store._items(tree)]


def _assert_same(port_tree, ref_tree):
    ours, theirs = _leaves(port_tree), jax.tree.leaves(ref_tree)
    assert len(ours) == len(theirs)
    for t, j in zip(ours, theirs):
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype)
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(j, np.float32))


def test_keys_follow_the_reference_flattening():
    a = _arrays()
    got = [k for k, _ in store._items(_port_tree(a))]
    want = ["/".join(str(getattr(p, "key", getattr(p, "idx", getattr(p, "name", None))))
                     for p in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(_ref_tree(a))[0]]
    assert got == want


def test_roundtrip_bf16_chunked_and_0d_leaves(tmp_path):
    tree = _port_tree(_arrays())
    store.save(tmp_path, 7, tree, chunk_mb=1)  # "big" (4.8 MB) in 4 chunks
    manifest = (tmp_path / "step_00000007" / "manifest.json").read_text()
    assert '"chunks": 4' in manifest and '"dtype": "bfloat16"' in manifest
    back = store.restore(tmp_path, 7, tree)
    assert type(back[1]) is AdamWState
    for x, y in zip(_leaves(tree), _leaves(back)):
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
    into = store._rebuild(tree, torch.zeros_like)
    assert store.restore_into(tmp_path, 7, into) is into
    assert all(torch.equal(x, y) for x, y in zip(_leaves(tree), _leaves(into)))
    with pytest.raises(ValueError):
        store.restore_into(tmp_path, 7, store._rebuild(tree, lambda t: t.double()))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    a = _arrays(1)
    store.save(tmp_path, 3, _port_tree(a), chunk_mb=1)
    ref = _ref_tree(a)
    back = ref_store.restore(tmp_path, 3, jax.eval_shape(lambda x: x, ref))
    for x, y in zip(jax.tree.leaves(ref), jax.tree.leaves(back)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    a = _arrays(2)
    ref_store.save(tmp_path, 4, _ref_tree(a), chunk_mb=1)
    like = _port_tree({k: np.zeros_like(v) for k, v in a.items()})
    _assert_same(store.restore(tmp_path, 4, like), _ref_tree(a))
    store.restore_into(tmp_path, 4, like)
    _assert_same(like, _ref_tree(a))


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_lm_parameter_trees_cross_both_packages(tmp_path, param_dtype):
    """A reduced jamba (attention, mamba and MoE slots) in the reference's
    stacked tree: written by the reference and read back through the port
    into an LM, and written by the port from an LM and read by the
    reference, value for value.  With bf16 parameters the leaves are bf16
    on disk both ways."""
    rcfg = dataclasses.replace(ref_get_config("jamba-1.5-large-398b").reduced(),
                               param_dtype=param_dtype)
    pcfg = dataclasses.replace(get_config("jamba-1.5-large-398b").reduced(),
                               param_dtype=param_dtype)
    ref_params = RM.init_params(rcfg, jax.random.PRNGKey(0))
    ref_store.save(tmp_path / "ref", 1, ref_params)
    like = jax.tree.map(lambda x: torch.zeros(x.shape, dtype=getattr(torch, str(x.dtype))),
                        ref_params)
    tree = store.restore(tmp_path / "ref", 1, like)
    if param_dtype == "float32":  # numpy, and so the LM round trip, has no bf16
        back = lm_params_to_reference(pcfg, lm_params_from_reference(pcfg, tree, device="cpu"))
        for (p, x), (_, y) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                                  jax.tree_util.tree_flatten_with_path(ref_params)[0]):
            np.testing.assert_array_equal(x, np.asarray(y), err_msg=jax.tree_util.keystr(p))
    store.save(tmp_path / "port", 2, tree)
    again = ref_store.restore(tmp_path / "port", 2, jax.eval_shape(lambda x: x, ref_params))
    for x, y in zip(jax.tree.leaves(ref_params), jax.tree.leaves(again)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_latest_step_ignores_tmp_and_missing_manifest(tmp_path):
    tree = _port_tree(_arrays())
    store.save(tmp_path, 3, tree)
    store.save(tmp_path, 9, tree)
    (tmp_path / "step_00000011.tmp").mkdir()  # a crashed writer
    (tmp_path / "step_00000012").mkdir()  # no manifest
    assert store.latest_step(tmp_path) == 9
    assert store.latest_step(tmp_path / "missing") is None


def test_async_checkpointer(tmp_path):
    ck = store.AsyncCheckpointer(tmp_path)
    tree = _port_tree(_arrays())
    ck.save(5, tree)
    ck.save(6, tree)  # waits for the first
    ck.wait()
    assert ck.saved_steps == [5, 6]
    assert store.latest_step(tmp_path) == 6
    assert ref_store.latest_step(tmp_path) == 6


def test_async_checkpointer_holds_the_tree_as_saved(tmp_path, monkeypatch):
    """A host tree updated in place right after ``save`` (as a train step
    updates its parameters and moments) is written as it was at the call:
    the writer is held back until the update is done."""
    go, write = __import__("threading").Event(), store.save
    monkeypatch.setattr(store, "save", lambda *a, **k: (go.wait(10), write(*a, **k))[1])
    a = _arrays()
    # both trees may share a's memory: the reference's reads a copy
    tree, ref = _port_tree(a), _ref_tree({k: np.copy(v) for k, v in a.items()})
    want = store._rebuild(tree, torch.clone)
    ck = store.AsyncCheckpointer(tmp_path)
    ck.save(3, tree)
    with torch.no_grad():
        for leaf in _leaves(tree):
            leaf.add_(1)
    go.set()
    ck.wait()
    _assert_same(store.restore(tmp_path, 3, tree), ref)
    for got, saved in zip(_leaves(store.restore(tmp_path, 3, tree)), _leaves(want)):
        assert torch.equal(got, saved)


def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor(threshold=2.0)
    for s in range(10):
        assert not mon.observe(s, 1.0)
    assert mon.observe(10, 5.0)
    assert mon.flagged and mon.flagged[0][0] == 10
    assert not mon.observe(11, 1.0)


def test_failure_injector_fires_once():
    inj = FailureInjector({2})
    inj.check(1)
    with pytest.raises(FailureInjector.NodeFailure):
        inj.check(2)
    inj.check(2)


def test_train_loop_restart_is_bit_identical(tmp_path):
    """A reduced llama3 trained for 6 steps (accum 2) from a TokenStream,
    uninterrupted, and killed before step 4, then resumed from step 3's
    checkpoint: equal losses for the steps both ran and equal final
    parameters and moments, bit for bit."""
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(), compute_dtype="float32")
    stream = TokenStream(cfg, 16, 4, seed=1, device="cpu")
    train_step = steps.make_train_step(cfg, accum=2,
                                       lr_schedule=adamw.cosine_schedule(3e-3, 1, 6))

    def run(directory, injector):
        params = M.train_mode(M.init_params(cfg, torch.Generator().manual_seed(0),
                                            device="cpu"))
        tree = steps.param_tree(params)
        state = (tree, adamw.init(tree, cfg.moment_dtype))

        def step_fn(state, step):
            _, opt = state
            _, opt, metrics = train_step(params, opt, stream.batch_at(step), step)
            return (tree, opt), {k: float(v) for k, v in metrics.items()}

        loop = TrainLoop(step_fn=step_fn, ckpt_dir=directory, save_every=3, injector=injector)
        if injector is None:
            return loop.run(state, 6)
        with pytest.raises(FailureInjector.NodeFailure):
            loop.run(state, 6)
        assert store.latest_step(directory) == 3
        return loop.run(state, 6)

    whole, step_a, hist_a = run(tmp_path / "a", None)
    resumed, step_b, hist_b = run(tmp_path / "b", FailureInjector({4}))
    assert step_a == step_b == 6
    assert [h["step"] for h in hist_b] == [3, 4, 5]
    assert [h["loss"] for h in hist_b] == [h["loss"] for h in hist_a[3:]]
    assert hist_a[-1]["loss"] < hist_a[0]["loss"]
    for x, y in zip(_leaves(whole), _leaves(resumed)):
        assert torch.equal(x, y)
    assert int(resumed[1].step) == 6
