"""Both training CLIs of the port under ``torchrun`` on the CPU (gloo),
against one process at the same global batch, and the dry run.

``python -m torch.distributed.run --standalone --nproc_per_node=2 -m
loans_tpu_torch.cli.train_localizer ... --device cpu``: two processes,
each on its half of every batch, against ``python -m
loans_tpu_torch.cli.train_localizer`` with the same argv (R-18 32²→8²,
``synthetic:16 synthetic:16 synthetic:8``, global batch 8, 2 steps a
call, 4 iterations, a log entry every 2). The two processes run on past
iteration 4, with a snapshot every 4, until a ``quit`` written to their
control file stops both: their first two log entries and their snapshots
at 4 are held against the one process's, and the quit test reads the
same run. Tolerances, with their reasons:

* logged losses and means 1e-4 relative: each entry averages two steps,
  and the second follows Adam steps that may stand 2·lr apart where a
  gradient is within float32 error of 0 (below); the localizer's loss
  is mostly the out-of-image sum of its corners (measured 1.2e-5);
* mean IoU and mAP of the in-training eval 1e-3 absolute: the eval (rank
  0, the whole val batch) follows Adam steps that move a weight by about
  lr in its gradient's sign, so weights whose gradient is within float32
  error of 0 may step apart (``test_torch_train.py``);
* snapshot parameters within 2·lr a step everywhere, the same argument,
  and 1e-5 on at least 99% of their entries.

The SSD CLI is held the same way at the size of ``test_torch_ssd_cli.py``
(SSD300, ``synthetic:4``, global batch 2, 2 iterations in one call with
the on-device augmentation), its losses to 1e-4 relative and its snapshot
to 2·lr a step (lr 1e-4).
"""

import glob
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOCALIZER_ARGV = [
    "synthetic:16", "synthetic:16", "synthetic:8", "--batch-size", "8", "--n-layers", "18",
    "--target-size", "32", "32", "--crop-size", "8", "8", "--steps-per-call", "2",
    "--iterations", "4", "--log-interval", "2", "--eval-batches", "1", "--device", "cpu",
]
SSD_ARGV = [
    "synthetic:4", "synthetic:4", "-b", "2", "--steps-per-call", "2", "--iterations", "2", "--log-interval", "2",
    "--eval-interval", "2", "--eval-batches", "1", "--device", "cpu",
]
LR, SSD_LR = 1e-3, 1e-4
ENV = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)


def launch(module: str, argv: list[str], nproc: int = 0) -> subprocess.Popen:
    """``python -m module argv``, under ``torchrun --standalone`` with
    ``nproc`` processes where ``nproc`` > 0."""
    prefix = [sys.executable]
    if nproc:
        prefix += ["-m", "torch.distributed.run", "--standalone", f"--nproc_per_node={nproc}"]
    return subprocess.Popen(prefix + ["-m", module] + argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=ENV, cwd=ROOT)


def finish(proc: subprocess.Popen, timeout: float = 600) -> str:
    try:
        out = proc.communicate(timeout=timeout)[0]
    finally:
        proc.kill()
    assert proc.returncode == 0, out[-4000:]
    return out


def run_dir(root) -> str:
    dirs = glob.glob(os.path.join(root, "*"))
    assert len(dirs) == 1, dirs  # one log dir, written by rank 0
    return dirs[0]


def load_log(log_dir: str) -> list[dict]:
    with open(os.path.join(log_dir, "log")) as f:
        return json.load(f)


def hold_snapshots(got_dir: str, want_dir: str, steps: int, lr: float) -> None:
    """Every snapshot of ``want_dir`` against the one of that name in
    ``got_dir``."""
    names = sorted(os.path.basename(p) for p in glob.glob(os.path.join(want_dir, "*.pt")))
    assert names and set(names) <= {os.path.basename(p) for p in glob.glob(os.path.join(got_dir, "*.pt"))}
    for name in names:
        got, want = (torch.load(os.path.join(d, name), weights_only=False) for d in (got_dir, want_dir))
        got, want = (s.get("model", s) for s in (got, want))
        close = total = 0
        for k, w in want.items():
            if not torch.is_tensor(w) or not w.is_floating_point():
                continue
            diff = (got[k] - w).abs()
            assert float(diff.max()) <= 2 * steps * lr + 1e-6, (name, k)
            close, total = close + int((diff <= 1e-5).sum()), total + diff.numel()
        assert close >= 0.99 * total, (name, close, total)


def hold_logs(got: list[dict], want: list[dict], loose=("mean_iou", "map", "ap/object")) -> None:
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g["iteration"] == w["iteration"]
        for k, v in w.items():
            if k in ("elapsed_time", "images_per_sec", "log_dir") or not isinstance(v, float):
                continue
            if k in loose:
                assert abs(g[k] - v) <= 1e-3, k
            else:
                np.testing.assert_allclose(g[k], v, rtol=1e-4, err_msg=k)


@pytest.fixture(scope="module")
def localizer_runs(tmp_path_factory):
    """The localizer CLI as 2 processes under torchrun, told to quit through
    the control file once it has logged iteration 4 (snapshots every 4), and
    as 1 process for the 4 iterations, both at once: one launch serves the
    2-against-1 test and the quit test."""
    tmp = tmp_path_factory.mktemp("localizer")
    two = launch("loans_tpu_torch.cli.train_localizer", LOCALIZER_ARGV + [
        "--iterations", "100000", "--snapshot-interval", "4", "--log-dir", str(tmp / "two")], 2)
    one = launch("loans_tpu_torch.cli.train_localizer", LOCALIZER_ARGV + ["--log-dir", str(tmp / "one")])
    try:
        deadline = time.time() + 300
        log = tmp / "two" / "*" / "log"
        while not glob.glob(str(log)) or load_log(os.path.dirname(glob.glob(str(log))[0]))[-1]["iteration"] < 4:
            assert two.poll() is None and time.time() < deadline
            time.sleep(0.2)
        with open(os.path.join(run_dir(tmp / "two"), "control"), "a") as f:
            f.write("quit\n")
        out_two, _ = finish(two), finish(one)
    finally:
        two.kill()
        one.kill()
    return {"out": out_two, "got": run_dir(tmp / "two"), "want": run_dir(tmp / "one")}


def test_localizer_cli_on_two_processes_is_one_process_s(localizer_runs):
    assert "2 process(es)" in localizer_runs["out"]
    got_dir, want_dir = localizer_runs["got"], localizer_runs["want"]
    # one log dir, written by rank 0: one process's files, and the later
    # snapshots and the control file of the longer run
    extra = set(os.listdir(got_dir)) - set(os.listdir(want_dir))
    assert set(os.listdir(want_dir)) <= set(os.listdir(got_dir))
    assert all(name.endswith(".pt") or name == "control" for name in extra), extra
    with open(os.path.join(got_dir, "manifest.json")) as f:
        assert json.load(f)["config"]["batch_size"] == 8
    got, want = load_log(got_dir), load_log(want_dir)
    assert [e["iteration"] for e in got[:2]] == [2, 4]
    hold_logs(got[:2], want)
    hold_snapshots(got_dir, want_dir, 4, LR)


def test_quit_stops_every_rank_at_the_same_iteration(localizer_runs):
    done = [line for line in localizer_runs["out"].splitlines() if "done at iteration" in line]
    assert len(done) == 2 and len(set(line.split(";")[0].split()[-1] for line in done)) == 1, done
    iteration = int(done[0].split(";")[0].split()[-1])
    assert 4 <= iteration < 100000
    assert os.path.exists(os.path.join(localizer_runs["got"], f"Localizer_{iteration}.pt"))


def test_batch_not_divisible_by_the_world_is_refused(tmp_path):
    argv = LOCALIZER_ARGV[:3] + ["--batch-size", "5", "--device", "cpu", "--log-dir", str(tmp_path)]
    proc = launch("loans_tpu_torch.cli.train_localizer", argv, 2)
    out = proc.communicate(timeout=300)[0]
    assert proc.returncode != 0
    assert "--batch-size 5 not divisible by 2 devices" in out
    assert not os.listdir(tmp_path)


def test_ssd_cli_on_two_processes_is_one_process_s(tmp_path):
    two = launch("loans_tpu_torch.cli.train_ssd", SSD_ARGV + ["--log-dir", str(tmp_path / "two")], 2)
    one = launch("loans_tpu_torch.cli.train_ssd", SSD_ARGV + ["--log-dir", str(tmp_path / "one")])
    finish(two), finish(one)
    got_dir, want_dir = run_dir(tmp_path / "two"), run_dir(tmp_path / "one")
    assert sorted(os.listdir(got_dir)) == sorted(os.listdir(want_dir))
    hold_logs(load_log(got_dir), load_log(want_dir))
    hold_snapshots(got_dir, want_dir, 2, SSD_LR)


@pytest.mark.parametrize("processes", [2])
def test_dryrun(processes):
    proc = subprocess.Popen([sys.executable, "-m", "loans_tpu_torch.parallel.dryrun", "--processes", str(processes),
                             "--device", "cpu"],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=ENV, cwd=ROOT)
    out = finish(proc)
    assert f"dryrun: {processes} processes (gloo on cpu), global batch {2 * processes}" in out
    assert "agree across ranks: True" in out
