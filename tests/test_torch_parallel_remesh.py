"""Training state across rank counts, and the training CLI across ranks.

* A whole training state (reduced llama3-8b's parameters and random AdamW
  moments) cut under (2, 4) and gathered is the state bit for bit, and
  cut again under (2, 2) (``remesh``) equals the direct cut.
* ``TrainLoop`` on 8 ranks ((2, 4), float32) killed at step 2 leaves the
  step-2 checkpoint, written by rank 0 alone; resumed on 8 ranks its
  steps 2-3 are the uninterrupted 8-rank run's bit for bit.  Resumed on
  4 ranks ((2, 2)) through ``remesh``, the restored state gathered is the
  saved one bit for bit, and steps 2-3 are bit for bit those of 4 ranks
  handed the same state without the loop's resume, and within rel 1e-4
  of the 8-rank run's (other ranks add their partial sums in other
  orders).
* ``torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train
  --reduced --mesh single --device cpu --steps 3`` (float32 compute):
  rank 0 prints losses within rel 1e-5 of ``--mesh none``'s.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from _torch_parallel import remesh_rank, run_ranks

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_remesh")
    eight = run_ranks(remesh_rank, 8, tmp, str(tmp), "eight")
    four = run_ranks(remesh_rank, 4, tmp, str(tmp), "four")
    return tmp, eight, four


def test_remesh_of_a_gathered_state_equals_the_direct_cut(runs):
    _, eight, _ = runs
    for got in eight:
        assert got["round_trip_equal"] and got["recut_equal"]
    shapes = eight[0]["cut_shapes"]
    # wq (64, 64) under (2, 4): d_model over data, one head of 16 over model
    assert shapes["0/layers/0/mixer/wq"] == (32, 16)
    assert shapes["1/m/layers/0/mixer/wq"] == (32, 16)


def test_killed_run_resumes_bit_identically_on_the_same_ranks(runs):
    tmp, eight, _ = runs
    for got in eight:
        assert got["killed_at"] == 2
        assert got["resumed"] == got["uninterrupted"][2:]
        assert got["resumed"] == eight[0]["resumed"]
    assert eight[0]["files"] == ["step_00000002", "step_00000004"]
    assert not any(".tmp" in p.name or ".trash" in p.name for p in (tmp / "killed").iterdir())


def test_eight_rank_checkpoint_resumes_on_four_ranks(runs):
    _, eight, four = runs
    saved, restored = eight[0]["saved"], four[0]["restored"]
    assert saved.keys() == restored.keys()
    for k in saved:
        np.testing.assert_array_equal(restored[k], saved[k], err_msg=k)
    want = eight[0]["uninterrupted"][2:]
    for got in four:
        assert got["resumed"] == got["handed"] == four[0]["resumed"]
        assert [s for s, _, _ in got["resumed"]] == [2, 3]
        for (_, loss, norm), (_, loss8, norm8) in zip(got["resumed"], want):
            assert abs(loss - loss8) <= 1e-4 * abs(loss8)
            assert abs(norm - norm8) <= 1e-4 * abs(norm8)


def _train_cli(args, tmp: Path, tag: str, *, nproc: int = 0) -> list[float]:
    launcher = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc-per-node", str(nproc)] if nproc else [sys.executable])
    run = subprocess.run(
        launcher + ["-m", "repro_torch.launch.train", "--reduced", "--device", "cpu",
                    "--steps", "3", "--compute-dtype", "float32",
                    "--ckpt-dir", str(tmp / tag), *args],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"},
    )
    assert run.returncode == 0, run.stderr[-4000:]
    printed = [line for line in run.stdout.splitlines() if line.startswith("losses:")]
    assert len(printed) == 1, run.stdout  # rank 0 alone prints
    assert "done: step=3" in run.stdout
    return ast.literal_eval(printed[0].removeprefix("losses:").strip())


def test_train_cli_across_ranks_matches_one_process(tmp_path):
    want = _train_cli(["--mesh", "none"], tmp_path, "none")
    got = _train_cli(["--mesh", "single"], tmp_path, "single", nproc=4)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert abs(a - b) <= 1e-5 * abs(b), (got, want)
    assert sorted(p.name for p in (tmp_path / "single").iterdir()) == ["step_00000003"]
