"""CUDA reachability probe — the port's counterpart of
``opensim_tpu/utils/probe.py``.

A wedged card can hang any CUDA call, ``torch.cuda.is_available()``
included, with no message. So every CLI entry point that would run on the
card by default first runs a trivial CUDA op in a child interpreter that
imports only torch, with a timeout, and kills the child when it runs out.
Unlike the reference, a failed probe never selects the CPU:
:func:`ensure_card` raises, and only an explicit ``--device cpu`` runs the
plain versions. The verdict is cached briefly, per user, so a batch of
invocations (a fleet's workers, a script's loop) pays for the child once;
the cache is ``OPENSIM_PROBE_CACHE``, by default a file named for the port
in ``XDG_RUNTIME_DIR`` (a per-user directory) when that is set, else in
the temporary directory, as the reference places its own; the port's
file name differs, so the port never reads the JAX package's verdict.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import Tuple

from . import envknobs
from .procgroup import spawn_group, stop_group

_PROBE_TTL_S = 600
#: the child's program: a sum on the card, read back to the host
_PROBE_CODE = (
    "import torch; s = torch.ones(8, 8, device='cuda').sum().item(); "
    "print('ok' if s == 64.0 else f'sum {s}')"
)


def cache_path() -> str:
    """The verdict's file: ``OPENSIM_PROBE_CACHE``, else in
    ``XDG_RUNTIME_DIR`` or the temporary directory
    (``opensim_tpu/utils/probe.py:23-31``). Scoped by uid: a world-shared
    fixed name would let another user's file pin a stale verdict (or hold
    the name, so that ``os.replace`` fails for ever)."""
    uid = os.getuid() if hasattr(os, "getuid") else 0
    base = os.environ.get("XDG_RUNTIME_DIR") or tempfile.gettempdir()
    return envknobs.raw("OPENSIM_PROBE_CACHE") or os.path.join(base, f"opensim-tpu-torch-probe-{uid}")


def _cached(path: str) -> Tuple[bool, float] | None:
    """(verdict, age in seconds) of a cached verdict this user wrote less
    than the TTL ago, else None."""
    try:
        st = os.stat(path)
        owned = not hasattr(os, "getuid") or st.st_uid == os.getuid()
        age = time.time() - st.st_mtime
        if owned and age < _PROBE_TTL_S:
            with open(path) as f:
                return f.read().strip() == "ok", age
    except OSError:
        pass
    return None


def _run_child(timeout_s: float) -> Tuple[bool, str]:
    """(verdict, why not) of one child run; the child and anything it
    started are killed once `timeout_s` has passed."""
    try:
        proc = spawn_group([sys.executable, "-c", _PROBE_CODE], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    except OSError as e:
        return False, f"the probe's child did not start ({e})"
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        try:
            stop_group(proc, timeout_s=0.0, sig=signal.SIGKILL, reap_s=5.0)
        except subprocess.TimeoutExpired:
            pass  # unkillable (stuck in the kernel module): leave it, never hang here
        for pipe in (proc.stdout, proc.stderr):
            pipe.close()
        return False, f"a trivial CUDA op did not finish within {timeout_s:g} s"
    if proc.returncode == 0 and out.strip() == "ok":
        return True, ""
    lines = [line for line in (err or out).strip().splitlines() if line.strip()]
    return False, lines[-1].strip() if lines else f"the probe's child exited {proc.returncode}"


def probe(timeout_s: float = 90, fresh: bool = False) -> Tuple[bool, str]:
    """(reachable, why not): :func:`accelerator_reachable`'s verdict with a
    one-line reason when it is False."""
    path = cache_path()
    if not fresh:
        hit = _cached(path)
        if hit is not None:
            ok, age = hit
            return ok, "" if ok else f"a probe {age:.0f} s ago found none (cached in {path})"
    ok, why = _run_child(timeout_s)
    try:
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            f.write("ok" if ok else "dead")
        os.replace(tmp, path)  # atomic: a concurrent reader never sees a torn write
    except OSError:
        pass
    return ok, why


def accelerator_reachable(timeout_s: float = 90, fresh: bool = False) -> bool:
    """True when a trivial CUDA op completes in a child process within
    `timeout_s`. ``fresh=True`` skips the cached verdict (a pre-outage
    "ok" must not be trusted for up to the TTL) but still records the new
    one."""
    return probe(timeout_s, fresh)[0]


def ensure_card(timeout_s: float = 90) -> None:
    """Probe, and raise ``RuntimeError`` with a one-line reason when the
    card is unreachable. Never selects the CPU. Call before anything
    touches CUDA (``device.resolve_device`` included)."""
    ok, why = probe(timeout_s)
    if not ok:
        raise RuntimeError(f"no CUDA device reachable: {why}; pass --device cpu to run the plain versions on the CPU")
