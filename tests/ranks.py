"""Subprocesses of the port's multi-process tests (the gloo ranks of
tests/test_torch_mesh.py, test_torch_parallel.py and
test_torch_checkpoint.py, and the CLI under torchrun).

Each command starts in a session of its own, so that what it starts in turn
(torchrun's workers) is in its process group. `wait` waits for all of them
with one deadline and then, on every path, kills every group that is still
there and reaps its leader: no rank outlives its test, even when a rank
fails, hangs at a rendezvous or the test is interrupted.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env() -> dict:
    """The environment of a rank: one CPU thread, the repo importable, no
    forced JAX devices (the ranks import no JAX)."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    env.pop("XLA_FLAGS", None)
    return env


def script_commands(script: str, case: str, world: int, port: int, out: str) -> list:
    """`python <script> <case> <rank> <world> <port> <out>` for each rank."""
    return [[sys.executable, script, case, str(r), str(world), str(port), out]
            for r in range(world)]


def start(cmds: list, cwd: str | None = None, env: dict | None = None) -> list:
    """Each command as a subprocess leading a process group of its own,
    its output captured."""
    env = rank_env() if env is None else env
    procs = []
    try:
        for c in cmds:
            procs.append(subprocess.Popen(c, cwd=cwd, env=env, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True,
                                          start_new_session=True))
    except BaseException:
        stop(procs)
        raise
    return procs


def stop(procs: list) -> None:
    """Kill the process group of every process (the ranks a command started
    too) and reap each one."""
    for p in procs:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
    for p in procs:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            pass
        if p.stdout is not None:
            p.stdout.close()


def wait(procs: list, timeout_s: float) -> list:
    """Wait for every process within `timeout_s` in all, then stop what is
    left; assert that each exited with 0 and return their outputs."""
    deadline = time.monotonic() + timeout_s
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        stop(procs)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"{p.args}: rc {p.returncode}\n{log[-4000:]}"
    return logs
