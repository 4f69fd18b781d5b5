"""Training supervisor: stall detection and automatic resume (port of
``loans_tpu/cli/supervise.py``).

    python -m loans_tpu_torch.cli.supervise --stall-timeout 900 -- \\
        python -m loans_tpu_torch.cli.train_localizer ... --log-dir logs --snapshot-interval 1000
    python -m loans_tpu_torch.cli.supervise --snapshot-names SSD300 --resume-flags=--resume -- \\
        python -m loans_tpu_torch.cli.train_ssd ... --log-dir logs --snapshot-interval 1000
    python -m loans_tpu_torch.cli.supervise -- \\
        torchrun --standalone --nproc_per_node=N -m loans_tpu_torch.cli.train_localizer ... --log-dir logs

Runs a training CLI as a child process, watches its JSON log for
progress, and on a stall (no new log entry within ``--stall-timeout``) or
a crash kills the child and relaunches it resuming from the newest
``<Name>_<iteration>.pt`` snapshots of its run dir. The same flags,
defaults, messages and return codes as the JAX package's supervisor. A
resume flag that starts with ``--`` (the SSD trainer's ``--resume``) is
given as ``--resume-flags=--resume``: argparse reads
``--resume-flags --resume`` as two options.

The child starts in a session of its own and a stall kills its whole
process group, so under ``torchrun`` the workers die with the launcher.
The stall clock starts at launch: a ``--stall-timeout`` shorter than the
CLI's start-up (imports, data generation, the kernels' first build) reads
as a stall. A resumed snapshot at or past ``--iterations`` makes the CLI
exit non-zero (``Trainer.resume``), which counts as a failed attempt.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time

from loans_tpu_torch.train.checkpoint import list_snapshots

# seconds between a failed attempt and the next: a killed process's CUDA
# context (and its memory on the card) is released by the driver after the
# process is reaped, not at once
RESTART_PAUSE_S = 5.0


def get_parser():
    p = argparse.ArgumentParser(
        description="supervise a training run with auto-resume"
    )
    p.add_argument("--stall-timeout", type=float, default=900.0,
                   help="seconds without log progress before restart; the "
                   "clock starts at launch, so keep it above the CLI's "
                   "start-up time (imports, data, the kernels' build)")
    p.add_argument("--max-restarts", type=int, default=5)
    p.add_argument("--poll-interval", type=float, default=20.0)
    p.add_argument("--snapshot-names", nargs="+",
                   default=["Localizer", "ResnetAssessor"],
                   help="snapshot prefixes to resume from (order matches "
                   "the train CLI's -rl / -rd flags)")
    p.add_argument("--min-iterations", type=int, default=1,
                   help="a child that exits rc=0 with log progress below "
                   "this iteration count is treated as FAILED (an "
                   "immediate clean death must not read as success). "
                   "0 disables the check.")
    p.add_argument("--resume-flags", nargs="+", default=None,
                   help="CLI flags to pass each resumed snapshot with, "
                   "matching --snapshot-names order (default: "
                   "--resume-localizer / --resume-discriminator+--no-freeze; "
                   "use '--resume' for the SSD trainer: every word up to "
                   "the next option of this CLI or '--' is a flag)")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="training command after '--'")
    return p


def _find_log_dir(base_dir: str, after: float) -> str | None:
    """Newest run dir created after ``after`` under the --log-dir."""
    if not os.path.isdir(base_dir):
        return None
    candidates = [
        os.path.join(base_dir, d)
        for d in os.listdir(base_dir)
        if os.path.isdir(os.path.join(base_dir, d))
    ]
    candidates = [d for d in candidates if os.path.getmtime(d) >= after - 5]
    return max(candidates, key=os.path.getmtime) if candidates else None


def _log_progress(log_dir: str | None) -> tuple[float, int]:
    """(mtime, last_iteration) of the run's JSON log."""
    if not log_dir:
        return 0.0, 0
    path = os.path.join(log_dir, "log")
    if not os.path.exists(path):
        return 0.0, 0
    try:
        with open(path) as f:
            entries = json.load(f)
        it = int(entries[-1].get("iteration", 0)) if entries else 0
    except Exception:
        it = 0
    return os.path.getmtime(path), it


def _newest_snapshots(log_dir: str, names) -> dict[str, str]:
    out = {}
    for name in names:
        snaps = list_snapshots(log_dir, name + "_")
        if snaps:
            out[name] = snaps[-1][1]
    return out


def _extract_base_log_dir(cmd: list[str]) -> str:
    for i, tok in enumerate(cmd):
        if tok in ("--log-dir", "-l") and i + 1 < len(cmd):
            return cmd[i + 1]
    return "logs"


def _resume_args(names, resume: dict[str, str], resume_flags) -> list[str]:
    out = []
    if resume_flags:
        for name, flag in zip(names, resume_flags):
            if name in resume:
                out += [flag, resume[name]]
        return out
    if names and names[0] in resume:
        out += ["--resume-localizer", resume[names[0]]]
    if len(names) > 1 and names[1] in resume:
        out += ["--resume-discriminator", resume[names[1]], "--no-freeze"]
    return out


def main(argv=None):
    args = get_parser().parse_args(argv)
    cmd = [c for c in args.command if c != "--"]
    if not cmd:
        raise SystemExit("no training command given (use -- <command>)")
    base_log_dir = _extract_base_log_dir(cmd)
    resume: dict[str, str] = {}
    prev_log_dir: str | None = None

    for attempt in range(args.max_restarts + 1):
        launch = cmd + _resume_args(args.snapshot_names, resume, args.resume_flags)
        print(f"[supervise] attempt {attempt}: {' '.join(launch)}",
              flush=True)
        start = time.time()
        child = subprocess.Popen(launch, start_new_session=True)
        log_dir = None
        last_progress = time.time()
        last_iter = 0
        stalled = False
        while child.poll() is None:
            time.sleep(args.poll_interval)
            # the resumed run writes a run dir of its own, which may appear
            # only after a few polls: until then the previous one stands in,
            # and a newer one replaces it as soon as it exists
            log_dir = _find_log_dir(base_log_dir, start) or log_dir \
                or prev_log_dir
            mtime, it = _log_progress(log_dir)
            if it > last_iter or mtime > last_progress:
                last_iter = max(last_iter, it)
                last_progress = max(mtime, last_progress)
            if time.time() - last_progress > args.stall_timeout:
                print(
                    f"[supervise] stall: no progress for "
                    f"{args.stall_timeout:.0f}s at iteration {last_iter}; "
                    f"restarting", flush=True,
                )
                stalled = True
                try:
                    os.killpg(child.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
                child.wait()
                break
        if not stalled and child.returncode == 0:
            # a child that exits cleanly without ever logging an iteration
            # (a refused flag combination, a launcher that died) is a failed
            # run; a resumed child may have reused the previous attempt's
            # run dir, so that one stands in for the check
            log_dir = _find_log_dir(base_log_dir, start) or log_dir \
                or prev_log_dir
            _, it = _log_progress(log_dir)
            done_iter = max(last_iter, it)
            if args.min_iterations and done_iter < args.min_iterations:
                print(
                    f"[supervise] child exited rc=0 but log shows only "
                    f"iteration {done_iter} (< --min-iterations "
                    f"{args.min_iterations}); treating as FAILURE",
                    flush=True,
                )
            else:
                print("[supervise] training completed", flush=True)
                return 0
        elif not stalled:
            print(f"[supervise] child exited rc={child.returncode}",
                  flush=True)
        if log_dir:
            prev_log_dir = log_dir
            # a run dir without a snapshot yet keeps the ones this attempt
            # resumed from: a restart never falls back to iteration 0
            resume = _newest_snapshots(log_dir, args.snapshot_names) or resume
            if resume:
                print(f"[supervise] will resume from {resume}", flush=True)
        time.sleep(RESTART_PAUSE_S)
    print("[supervise] giving up after max restarts", flush=True)
    return 1


if __name__ == "__main__":
    sys.exit(main())
