"""The four-card crash cascade's retry check and the leg launcher's
rendezvous (``benchmarks/fleet_check.py``, ``resilience/supervisor.py``).

A cascade job's first leg must save step 2 and die of the injected
``OSError``; its retry must restore step 2.  A leg whose rank 0 could not
bind its rendezvous port died before any step instead, and its retry
trained from step 0 while the drill's verdict still read
``verified_recovery``.  The launcher now serves each leg's rendezvous
store itself, holding the port from before the ranks start."""

from __future__ import annotations

import errno
import os
import socket
import subprocess
import time

import pytest

from mpi4dl_tpu_torch.benchmarks import fleet_check
from mpi4dl_tpu_torch.obs import RunLog


class _Rank:
    """A rank that, as it starts, tries to take the leg's rendezvous port;
    then exits 0."""

    spawned = []

    def __init__(self, cmd, env=None, stdout=None, stderr=None):
        self.env, self.returncode = env, None
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            s.bind(("127.0.0.1", int(env["MASTER_PORT"])))
            self.bind_error = None
        except OSError as e:
            self.bind_error = e.errno
        finally:
            s.close()
        _Rank.spawned.append(self)

    def poll(self):
        self.returncode = 0
        return 0

    def kill(self):
        pass

    def wait(self, timeout=None):
        return self.poll()


def test_the_leg_holds_its_rendezvous_port_while_its_ranks_start(tmp_path, monkeypatch):
    """No other process can take the port between the launcher's choice and
    the ranks' rendezvous: every rank finds it bound, and the ranks join
    the launcher's store as clients."""
    from mpi4dl_tpu_torch.resilience import supervisor as sup

    monkeypatch.setattr(sup.subprocess, "Popen", _Rank)
    _Rank.spawned = []
    launch = sup.subprocess_leg_launcher("sp", "resnet", str(tmp_path), job="alpha")
    out = launch({"num-spatial-parts": "2", "slice-method": "vertical"}, {}, 1)
    assert out.rc == 0 and len(_Rank.spawned) == 2
    assert [r.bind_error for r in _Rank.spawned] == [errno.EADDRINUSE] * 2
    assert {r.env["TORCHELASTIC_USE_AGENT_STORE"] for r in _Rank.spawned} == {"True"}
    port = int(_Rank.spawned[0].env["MASTER_PORT"])
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", port))  # released when the leg ended


def test_each_ranks_exit_and_kill_ride_the_evidence():
    """``_wait_ranks`` records each rank's exit seconds and whether the
    launcher killed it after the grace."""
    from mpi4dl_tpu_torch.resilience.supervisor import _wait_ranks

    procs = {0: subprocess.Popen(["sleep", "30"]),
             1: subprocess.Popen(["sh", "-c", "exit 1"])}
    t0 = time.monotonic()
    rcs, order, exits = _wait_ranks(procs, timeout=None, grace=0.2)
    assert time.monotonic() - t0 < 10
    assert rcs == {1: 1, 0: -9} and order == [1]
    assert exits[1]["killed"] is False and exits[0]["killed"] is True
    assert exits[0]["exit_s"] >= exits[1]["exit_s"] + 0.2


def _leg(swd, launch, job, attempt, saved=(), restored=None):
    tele = os.path.join(swd, "legs", launch, job, f"attempt{attempt}", "tele")
    os.makedirs(tele, exist_ok=True)
    with RunLog(os.path.join(tele, "sp-resnet.jsonl")) as rl:
        if restored is not None:
            rl.write("restore", path=f"ck/ckpt_{restored}", step_id=restored)
        for g in saved:
            rl.write("checkpoint", gstep=g, path=f"ck/ckpt_{g}")


def _incident(swd, job, n, attempt, cls, gstep):
    os.makedirs(os.path.join(swd, "jobs", job), exist_ok=True)
    with RunLog(os.path.join(swd, "jobs", job, f"supervisor{n:02d}.jsonl")) as rl:
        rl.write("supervisor", attempt=attempt, failure_class=cls, policy="retry",
                 evidence={"marker_phase": "step" if gstep >= 0 else "build",
                           "marker_gstep": gstep,
                           "ranks": [{"rank": 0, "rc": 1, "exit_s": 7.4, "killed": False}]})


@pytest.mark.parametrize("alpha_retry,problem", [
    ((("transient_io", 2), [0, 2], 2), False),
    # The first leg died at the rendezvous; its retry trained from step 0.
    ((("unknown", -1), [], None), True),
    # The step-2 save was not restorable: the retry walked back to step 0.
    ((("transient_io", 2), [0], 0), True),
], ids=["restored_step_2", "first_leg_died_at_the_rendezvous", "restored_step_0"])
def test_the_cascade_requires_every_retry_to_restore_step_2(tmp_path, alpha_retry, problem):
    (cls, gstep), saved, restored = alpha_retry
    swd = str(tmp_path)
    _leg(swd, "launch001", "alpha", 1, saved=saved)
    _leg(swd, "launch001", "alpha", 2, saved=[4], restored=restored)
    _incident(swd, "alpha", 1, 1, cls, gstep)
    _leg(swd, "launch002", "beta", 1, saved=[0, 2])
    _leg(swd, "launch002", "beta", 2, saved=[4], restored=2)
    _incident(swd, "beta", 1, 1, "transient_io", 2)
    row = {}
    reason = fleet_check.retry_check(row, swd, 2, ("alpha", "beta"))
    assert bool(reason) is problem, reason
    assert row["retry_restores"] == {"alpha": [restored], "beta": [2]}
    first = row["legs"]["alpha"][0]
    assert first["attempt"] == 1 and first["saved"] == saved and first["restored"] is None
    assert first["incident"]["class"] == cls and first["incident"]["marker_gstep"] == gstep
    assert row["legs"]["alpha"][1]["incident"] is None
    assert f"{cls} (crash marker" in fleet_check._ended(first["incident"])
    assert "r0 rc 1 at 7.4 s" in fleet_check._ended(first["incident"])
