"""Server subprocesses as process groups: each started as the leader of a
process group of its own, stopped with everything they spawned.

A ``simon server --workers N`` owner spawns its fleet workers into its own
process group, and a hot standby adopts them when it takes over. Signalling
the group, not only the leader, is what stops a fleet without leaving a
worker serving on loopback after its owner is gone. The group stays in
the caller's session: on Linux a new session is also a scheduler
autogroup of its own, which would share the cores with the caller's whole
session as an equal instead of thread by thread. Stdlib only.
"""

from __future__ import annotations

import contextlib
import os
import signal
import subprocess
import time
from typing import List, Optional, Sequence

__all__ = ["group_gone", "pid_gone", "spawn_group", "stop_group"]


def spawn_group(argv: Sequence[str], **popen_kw) -> subprocess.Popen:
    """``subprocess.Popen(argv)`` as the leader of a new process group (its
    id is the leader's pid), in the caller's session."""
    return subprocess.Popen(list(argv), process_group=0, **popen_kw)


def pid_gone(pid: int) -> bool:
    """True when `pid` no longer runs: absent, or a zombie awaiting its
    parent's wait."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            state = f.read().rsplit(")", 1)[1].split()[0]
    except (OSError, IndexError):
        return True
    return state == "Z"


def _group_members(pgid: int) -> List[int]:
    """Pids whose process group is `pgid` and that still run."""
    members = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if len(fields) > 2 and int(fields[2]) == pgid and fields[0] != "Z":
            members.append(int(entry))
    return members


def group_gone(pgid: int) -> bool:
    """True when no process of group `pgid` still runs."""
    return not _group_members(pgid)


def stop_group(proc: subprocess.Popen, timeout_s: float = 60.0, sig: int = signal.SIGTERM,
               reap_s: float = 10.0) -> Optional[int]:
    """Send `sig` to `proc` (a :func:`spawn_group` leader) and wait up to
    `timeout_s` for it to exit (a fleet owner's SIGTERM drains its workers
    first); then SIGKILL whatever is left of its process group, workers a
    deposed owner left behind included, and wait up to `reap_s` for them.
    Returns the leader's exit code."""
    pgid = proc.pid
    if proc.poll() is None:
        with contextlib.suppress(ProcessLookupError, PermissionError):
            os.kill(proc.pid, sig)
        try:
            proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            pass
    with contextlib.suppress(ProcessLookupError, PermissionError):
        os.killpg(pgid, signal.SIGKILL)
    if proc.poll() is None:
        proc.wait(timeout=reap_s)
    deadline = time.monotonic() + reap_s
    while not group_gone(pgid) and time.monotonic() < deadline:
        time.sleep(0.05)
    return proc.returncode
