"""True multi-controller integration: two OS processes, 4 fake CPU devices
each, joined by jax.distributed into one 8-device mesh over localhost —
the particle-sharded step must reproduce the single-device trajectory
(BASELINE.json config #5, SURVEY.md §5 'distributed communication
backend')."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(port, ckpt):
    runner = os.path.join(os.path.dirname(__file__), "multihost_runner.py")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)       # runner sets its own device count
    procs = [
        subprocess.Popen(
            [sys.executable, runner, str(pid), "2", str(port), ckpt],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        )
        for pid in range(2)
    ]
    outs = []
    ok = True
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            ok = False
            outs.append("<timeout>")
            continue
        outs.append(out.decode())
        ok = ok and p.returncode == 0
    return ok, procs, outs


def test_two_process_mesh_matches_single_device(tmp_path):
    ckpt = str(tmp_path / "mh")
    # The free port can be stolen between probing and the coordinator's
    # bind (TOCTOU); retry once on a fresh port before failing.
    for attempt in range(2):
        ok, procs, outs = _launch(_free_port(), ckpt)
        if ok:
            break
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"MULTIHOST-OK-{pid}" in out, out
        assert f"MULTIHOST-RING-GRID-OK-{pid}" in out, out

    # Process 0 wrote the single shared global checkpoint.
    assert os.path.exists(ckpt)
    assert not os.path.exists(ckpt + ".p1")
    np.load(ckpt)  # parses


def _launch_crash(port, ckpt, mode):
    runner = os.path.join(os.path.dirname(__file__),
                          "multihost_crash_runner.py")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, runner, str(pid), "2", str(port), ckpt, mode],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        )
        for pid in range(2)
    ]
    outs, codes = [], []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
            outs.append(out.decode())
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            outs.append("<timeout>")
        codes.append(p.returncode)
    return codes, outs


def test_two_process_crash_resume(tmp_path):
    """The multi-host CRASH DRILL (VERDICT r3 item #6): process 1 dies
    hard right after the first checkpoint chunk (simulated worker loss;
    process 0 follows, as a real scheduler tears the job down), then a
    full relaunch broadcast-resumes from the checkpoint
    (utils/recovery.py) and the finished trajectory equals an
    uninterrupted single-device run."""
    ckpt = str(tmp_path / "crash_ck")
    for attempt in range(2):
        codes, outs = _launch_crash(_free_port(), ckpt, "crash")
        if "<timeout>" not in outs:
            break
    assert codes == [17, 17], (codes, outs)
    assert all("CRASH-MODE-DID-NOT-CRASH" not in o for o in outs), outs
    # The step-2 checkpoint survived the crash.
    assert os.path.exists(ckpt)
    ck = np.load(ckpt, allow_pickle=True)
    assert ck is not None

    for attempt in range(2):
        codes, outs = _launch_crash(_free_port(), ckpt, "resume")
        if "<timeout>" not in outs:
            break
    for pid_, (code, out) in enumerate(zip(codes, outs)):
        assert code == 0, f"resume proc {pid_} failed:\n{out}"
        assert f"CRASH-RESUME-OK-{pid_}" in out, out
