"""The port's training supervisor (``loans_tpu_torch/cli/supervise.py``)
against the JAX package's (``loans_tpu/cli/supervise.py``).

The fake children of ``tests/test_supervise.py`` (a Python script that
writes a JSON log, ``.pt`` snapshots and hangs, crashes or exits), with
stall timeouts of a few seconds and the pause between attempts patched to
0: a healthy child, a stalled child resumed from ``Localizer_1.pt``, an
immediate clean death (rc 1), ``--min-iterations 0``, a grandchild killed
with its process group, the SSD trainer's ``--resume``, a resumed run whose
run dir appears only after some polls, and the launch commands against
JAX's supervisor on the same child (``.msgpack`` in JAX's run, ``.pt`` in
the port's).
"""

import json
import os
import sys
import time

import pytest

from loans_tpu.cli import supervise as jax_supervise
from loans_tpu_torch.cli import supervise

FAST = ["--stall-timeout", "60", "--poll-interval", "0.2", "--max-restarts", "1"]


@pytest.fixture(autouse=True)
def no_pause(monkeypatch):
    monkeypatch.setattr(supervise, "RESTART_PAUSE_S", 0.0)


def child(tmp_path, body):
    script = tmp_path / "fake_train.py"
    script.write_text("import json, os, subprocess, sys, time\n"
                      "base = sys.argv[sys.argv.index('--log-dir') + 1]\n" + body)
    return [sys.executable, str(script), "--log-dir", str(tmp_path / "logs")]


def run_dir_log(tmp_path, name="run"):
    with open(tmp_path / "logs" / name / "log") as f:
        return json.load(f)


def test_healthy_child_completes(tmp_path):
    cmd = child(tmp_path, """
log_dir = os.path.join(base, 'run')
os.makedirs(log_dir, exist_ok=True)
entries = []
for it in (1, 2, 3):
    entries.append({'iteration': it})
    json.dump(entries, open(os.path.join(log_dir, 'log'), 'w'))
    time.sleep(0.1)
""")
    assert supervise.main(FAST + ["--"] + cmd) == 0
    assert run_dir_log(tmp_path)[-1]["iteration"] == 3


def test_stalled_child_resumes_from_pt_snapshot(tmp_path, capsys):
    """A child that writes a snapshot and hangs is killed after the stall
    timeout and relaunched with --resume-localizer at that ``.pt`` file."""
    cmd = child(tmp_path, """
log_dir = os.path.join(base, 'run')
os.makedirs(log_dir, exist_ok=True)
if '--resume-localizer' in sys.argv:
    snap = sys.argv[sys.argv.index('--resume-localizer') + 1]
    assert snap.endswith('Localizer_1.pt') and os.path.exists(snap), snap
    json.dump([{'iteration': 9}], open(os.path.join(log_dir, 'log'), 'w'))
    sys.exit(0)
json.dump([{'iteration': 1}], open(os.path.join(log_dir, 'log'), 'w'))
open(os.path.join(log_dir, 'Localizer_1.pt'), 'wb').write(b'x')
open(os.path.join(log_dir, 'Localizer_1.msgpack'), 'wb').write(b'x')  # not the port's
time.sleep(3600)
""")
    rc = supervise.main(["--stall-timeout", "2", "--poll-interval", "0.2", "--max-restarts", "2",
                         "--snapshot-names", "Localizer", "--"] + cmd)
    assert rc == 0
    assert run_dir_log(tmp_path)[-1]["iteration"] == 9
    out = capsys.readouterr().out
    assert "[supervise] stall: no progress for 2s at iteration 1; restarting" in out
    assert "--resume-localizer " + str(tmp_path / "logs" / "run" / "Localizer_1.pt") in out


def test_immediate_clean_death_is_a_failure(tmp_path, capsys):
    cmd = child(tmp_path, "sys.exit(0)\n")
    assert supervise.main(FAST + ["--"] + cmd) == 1
    out = capsys.readouterr().out
    assert out.count("treating as FAILURE") == 2 and "giving up after max restarts" in out


def test_min_iterations_zero_disables_the_check(tmp_path):
    cmd = child(tmp_path, "sys.exit(0)\n")
    assert supervise.main(FAST + ["--min-iterations", "0", "--"] + cmd) == 0


def _alive(pid: int) -> bool:
    """Running and not a zombie waiting to be reaped."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def test_stall_kills_the_grandchild_with_its_group(tmp_path):
    """As torchrun's workers: a grandchild of the supervised process dies
    with it when a stall kills the process group."""
    cmd = child(tmp_path, """
log_dir = os.path.join(base, 'run')
os.makedirs(log_dir, exist_ok=True)
if '--resume-localizer' in sys.argv:
    json.dump([{'iteration': 2}], open(os.path.join(log_dir, 'log'), 'w'))
    sys.exit(0)
worker = subprocess.Popen([sys.executable, '-c', 'import time; time.sleep(3600)'])
open(os.path.join(base, 'worker.pid'), 'w').write(str(worker.pid))
json.dump([{'iteration': 1}], open(os.path.join(log_dir, 'log'), 'w'))
open(os.path.join(log_dir, 'Localizer_1.pt'), 'wb').write(b'x')
time.sleep(3600)
""")
    rc = supervise.main(["--stall-timeout", "2", "--poll-interval", "0.2", "--max-restarts", "1",
                         "--snapshot-names", "Localizer", "--"] + cmd)
    assert rc == 0
    pid = int((tmp_path / "logs" / "worker.pid").read_text())
    for _ in range(50):
        if not _alive(pid):
            break
        time.sleep(0.1)
    assert not _alive(pid)


def test_ssd_trainer_resume_flag(tmp_path):
    """``--snapshot-names SSD300 --resume-flags=--resume``: the SSD
    trainer's one snapshot, after a crash."""
    cmd = child(tmp_path, """
log_dir = os.path.join(base, 'run')
os.makedirs(log_dir, exist_ok=True)
if '--resume' in sys.argv:
    assert sys.argv[sys.argv.index('--resume') + 1].endswith('SSD300_4.pt'), sys.argv
    assert '--resume-localizer' not in sys.argv and '--no-freeze' not in sys.argv, sys.argv
    json.dump([{'iteration': 8}], open(os.path.join(log_dir, 'log'), 'w'))
    sys.exit(0)
json.dump([{'iteration': 4}], open(os.path.join(log_dir, 'log'), 'w'))
open(os.path.join(log_dir, 'SSD300_2.pt'), 'wb').write(b'x')
open(os.path.join(log_dir, 'SSD300_4.pt'), 'wb').write(b'x')
sys.exit(1)
""")
    rc = supervise.main(FAST + ["--snapshot-names", "SSD300", "--resume-flags=--resume", "--"] + cmd)
    assert rc == 0 and run_dir_log(tmp_path)[-1]["iteration"] == 8


def test_late_run_dir_of_a_resumed_run_is_watched(tmp_path):
    """The port's CLIs write a new timestamped run dir when they resume,
    after their start-up. The supervisor must watch that dir once it
    appears, not the previous attempt's: here the resumed child logs for
    3.5 s in a dir it makes after 0.5 s, past a 2.5 s stall timeout that
    the previous dir's stale log would trip."""
    cmd = child(tmp_path, """
if '--resume-localizer' in sys.argv:
    time.sleep(0.5)
    log_dir = os.path.join(base, 'run1')
    os.makedirs(log_dir)
    for it in range(2, 16):
        json.dump([{'iteration': it}], open(os.path.join(log_dir, 'log'), 'w'))
        time.sleep(0.25)
    sys.exit(0)
log_dir = os.path.join(base, 'run0')
os.makedirs(log_dir)
json.dump([{'iteration': 1}], open(os.path.join(log_dir, 'log'), 'w'))
open(os.path.join(log_dir, 'Localizer_1.pt'), 'wb').write(b'x')
sys.exit(1)
""")
    rc = supervise.main(["--stall-timeout", "2.5", "--poll-interval", "0.1", "--max-restarts", "1",
                         "--snapshot-names", "Localizer", "--"] + cmd)
    assert rc == 0 and run_dir_log(tmp_path, "run1")[-1]["iteration"] == 15


def test_launch_commands_equal_jax(tmp_path, capsys, monkeypatch):
    """The same child under both supervisors: it crashes twice after
    writing snapshots of both models (the second time from the resumed
    snapshots) and completes on the third attempt. The printed lines,
    launch commands included, are JAX's with ``.msgpack`` read as ``.pt``
    and the run's directory as a placeholder."""
    body = """
ext = os.environ['SNAPSHOT_EXT']
log_dir = os.path.join(base, 'run')
os.makedirs(log_dir, exist_ok=True)
it = 1
if '--resume-localizer' in sys.argv:
    it = int(sys.argv[sys.argv.index('--resume-localizer') + 1].rsplit('_', 1)[1].split('.')[0]) + 1
json.dump([{'iteration': it}], open(os.path.join(log_dir, 'log'), 'w'))
if it < 3:
    for name in ('Localizer', 'ResnetAssessor'):
        open(os.path.join(log_dir, f'{name}_{it}{ext}'), 'wb').write(b'x')
    sys.exit(3)
"""
    argv = ["--stall-timeout", "60", "--poll-interval", "0.2", "--max-restarts", "3"]
    real_sleep = time.sleep
    # JAX's supervisor pauses 5 s between attempts: skip that pause here
    monkeypatch.setattr(jax_supervise, "time", type("T", (), {
        "time": staticmethod(time.time), "sleep": staticmethod(lambda s: s != 5 and real_sleep(s))}))
    printed = {}
    for package, module, ext in (("jax", jax_supervise, ".msgpack"), ("port", supervise, ".pt")):
        work = tmp_path / package
        work.mkdir()
        monkeypatch.setenv("SNAPSHOT_EXT", ext)
        assert module.main(argv + ["--"] + child(work, body)) == 0
        out = capsys.readouterr().out.replace(str(work), "<work>").replace(ext, "<ext>")
        printed[package] = [line for line in out.splitlines() if line.startswith("[supervise]")]
    assert printed["port"] == printed["jax"]
    attempts = [line for line in printed["port"] if " attempt " in line]
    assert len(attempts) == 3
    assert attempts[2].endswith("--resume-localizer <work>/logs/run/Localizer_2<ext> --resume-discriminator "
                                "<work>/logs/run/ResnetAssessor_2<ext> --no-freeze")
