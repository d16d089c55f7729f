"""Preempt one rank of a ``torchrun`` job mid-run and hold the resume to an
uninterrupted run.

    python -m mpi4dl_tpu_torch.benchmarks.preempt_check --nproc 4 \\
        --module mpi4dl_tpu_torch.benchmarks.spatial_parallelism.benchmark_amoebanet_sp \\
        --workdir DIR --signal-rank 1 --after-step 2 -- \\
        --image-size 2048 --num-layers 18 --num-filters 416 --num-classes 1000 \\
        --batch-size 1 --precision bf_16 --halo-d2 --pallas-conv --no-remat \\
        --steps-per-epoch 4 --num-epochs 2

runs the runner three times under ``torchrun --standalone``, each with its
own ``--checkpoint-dir`` under ``DIR``:

1. ``control``: uninterrupted.
2. ``killed``: once rank 0 has printed the step line of global step
   ``--after-step``, SIGTERM goes to the one worker whose ``RANK`` is
   ``--signal-rank`` (found among torchrun's descendants), as a preemption
   notice reaches one host of a job.  The ranks agree on the flag after
   their step (``resilience/loop.py``), so every rank stops after the same
   step, saves, and exits 0; a disagreement would hang the job instead.
3. ``resumed``: the same directory, restarted.

Rank 0's summary line of each run is read.  The last line is one JSON
object: each run's exit code, losses, saves (the training thread's wait,
the time until durable, peak pending bytes) and step ms; where the killed
run stopped; and ``bitwise``: whether the killed run's losses followed by
the resumed run's equal the control's, bit for bit.  ``ok`` needs every
exit code 0, the killed run preempted before its end, a valid checkpoint
at its final step, the resume starting there, and ``bitwise``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time

_STEP_LINE = re.compile(r"^epoch (\d+) step (\d+) ")


def _descendants(root: int):
    """Pids of every live descendant of ``root`` (from /proc)."""
    parents = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                stat = f.read()
            parents[int(name)] = int(stat.rsplit(")", 1)[1].split()[1])
        except (OSError, ValueError, IndexError):
            continue
    out, frontier = [], [root]
    while frontier:
        p = frontier.pop()
        kids = [c for c, pp in parents.items() if pp == p]
        out += kids
        frontier += kids
    return out


def _rank_of(pid: int):
    try:
        with open(f"/proc/{pid}/environ", "rb") as f:
            env = dict(kv.split(b"=", 1) for kv in f.read().split(b"\0") if b"=" in kv)
        return int(env[b"RANK"]) if b"RANK" in env else None
    except (OSError, ValueError):
        return None


def _run(cmd, env, log_path, on_line=None, timeout=1800):
    """Run ``cmd``, echoing and logging its output; ``on_line(line, proc)``
    sees each line.  Returns (exit code, last JSON line)."""
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    killer = threading.Timer(timeout, proc.kill)
    killer.start()
    summary = None
    try:
        with open(log_path, "w") as log:
            for line in proc.stdout:
                log.write(line)
                sys.stdout.write(line)
                if on_line is not None:
                    on_line(line, proc)
                if line.startswith("{"):
                    try:
                        summary = json.loads(line)
                    except ValueError:
                        pass
        rc = proc.wait()
    finally:
        killer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return rc, summary


def _brief(out):
    if out is None:
        return None
    return {k: out.get(k) for k in ("start_step", "final_step", "preempted", "anomalies",
                                    "losses", "step_ms", "write_overlap", "checkpoint",
                                    "images_per_sec", "peak_bytes", "tail_differing")}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--" in argv:
        cut = argv.index("--")
        argv, flags = argv[:cut], argv[cut + 1:]
    else:
        flags = []
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--module", required=True, help="the runner's module")
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--signal-rank", type=int, default=1)
    ap.add_argument("--after-step", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=1800.0,
                    help="seconds each torchrun may take")
    args = ap.parse_args(argv)
    from mpi4dl_tpu_torch.checkpoint import cheap_validate

    os.makedirs(args.workdir, exist_ok=True)
    env = dict(os.environ)
    env.pop("MPI4DL_FAULT", None)

    def cmd(ckdir):
        return [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", str(args.nproc), "-m", args.module, *flags,
                "--checkpoint-dir", os.path.join(args.workdir, ckdir)]

    runs = {}
    t0 = time.perf_counter()
    runs["control"] = _run(cmd("control"), env, os.path.join(args.workdir, "control.log"),
                           timeout=args.timeout)
    sent = {}

    def preempt_one(line, proc):
        m = _STEP_LINE.match(line)
        if sent or m is None:
            return
        # Rank 0's "epoch E step I" line: global step E * steps + I is done.
        spe = int(flags[flags.index("--steps-per-epoch") + 1])
        g = int(m.group(1)) * spe + int(m.group(2))
        if g < args.after_step:
            return
        for pid in _descendants(proc.pid):
            if _rank_of(pid) == args.signal_rank:
                os.kill(pid, signal.SIGTERM)
                sent.update(pid=pid, after_step=g, t=time.perf_counter() - t0)
                return

    runs["killed"] = _run(cmd("killed"), env, os.path.join(args.workdir, "killed.log"),
                          preempt_one, timeout=args.timeout)
    runs["resumed"] = _run(cmd("killed"), env, os.path.join(args.workdir, "resumed.log"),
                           timeout=args.timeout)
    (rc_c, control), (rc_k, killed), (rc_r, resumed) = (
        runs["control"], runs["killed"], runs["resumed"])
    valid = False
    if killed is not None:
        try:
            cheap_validate(os.path.join(args.workdir, "killed", f"ckpt_{killed['final_step']}"))
            valid = True
        except Exception as e:  # noqa: BLE001 — reported in the result line
            print(f"preempt_check: ckpt_{killed['final_step']} invalid: {e!r}", flush=True)
    bitwise = bool(control and killed and resumed
                   and killed["losses"] + resumed["losses"] == control["losses"])
    ok = (rc_c == rc_k == rc_r == 0 and bool(sent) and killed is not None
          and killed["preempted"] and killed["final_step"] < control["final_step"]
          and valid and resumed["start_step"] == killed["final_step"] and bitwise)
    print(json.dumps({"signal": {"rank": args.signal_rank, **sent},
                      "exit_codes": [rc_c, rc_k, rc_r], "checkpoint_valid": valid,
                      "control": _brief(control), "killed": _brief(killed),
                      "resumed": _brief(resumed), "bitwise": bitwise, "ok": ok}),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
