"""Where the port's kernel libraries live — the port's copy of
``opensim_tpu/utils/jitcache.py``.

What the port compiles is one ``nvcc`` shared object per kernel variant
(``ops/fast_scan.py``), cached by source, flags and variant in a build
directory; the cold build of every variant a run needs is the port's
largest start-up cost. ``OPENSIM_JIT_CACHE`` keeps the reference's meaning
for that directory:

  unset or ``1``   the default directory, ``opensim_tpu_torch/_build/``
  ``<path>``       that directory (shared by checkouts, or writable where
                   the package directory is not)
  ``0``            no reuse: a temporary directory of this process's own,
                   removed at exit, so every variant compiles cold

A directory that cannot be created or written logs a warning and builds as
``0`` does, as the reference warns and compiles cold. The CLI resolves the
directory at start (:func:`maybe_enable`); a library caller gets it on its
first build (:func:`build_dir`). A process the port spawns is handed the
resolved directory (:func:`export`), so a fleet worker loads the libraries
its owner built instead of building them again, under ``0`` too.
Framework-free: nothing here imports torch.
"""

from __future__ import annotations

import atexit
import logging
import os
import shutil
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional

from . import envknobs

DEFAULT_DIR = Path(__file__).resolve().parents[1] / "_build"

_LOCK = threading.Lock()
#: the build directory in effect, once resolved (guarded-by: _LOCK)
_DIR: Optional[Path] = None
#: this process's own cold directory under ``0``, removed at exit
_COLD: Optional[Path] = None


def _cold_dir() -> Path:
    global _COLD
    if _COLD is None:
        _COLD = Path(tempfile.mkdtemp(prefix="opensim-torch-build-"))
        # at exit, a failed build's exit included (its temp files go too)
        atexit.register(shutil.rmtree, str(_COLD), True)
    return _COLD


def _writable(path: Path) -> Optional[str]:
    """None when `path` is (made) a writable directory, else why not."""
    try:
        path.mkdir(parents=True, exist_ok=True)
    except OSError as e:
        return str(e)
    if not os.access(path, os.W_OK | os.X_OK):
        return "not writable"
    return None


def maybe_enable(default: bool = False, path: Optional[str] = None) -> Optional[str]:
    """Resolve the build directory from ``OPENSIM_JIT_CACHE`` and make it
    the one :func:`build_dir` returns.

    Returns the reused directory, or None when nothing is reused (``0``,
    an unwritable directory, or the knob unset with neither `default` nor
    `path`): the build directory is then this process's cold one. `path`
    takes the place of the default directory."""
    global _DIR
    raw = envknobs.raw("OPENSIM_JIT_CACHE")
    chosen: Optional[Path] = None
    if raw != "0" and (raw or default or path):
        chosen = Path(raw if raw not in ("", "1") else (path or DEFAULT_DIR))
        why = _writable(chosen)
        if why is not None:
            # never fail the caller, but say so: a wrong path must not look
            # like a cache that is merely cold
            logging.getLogger("opensim_tpu_torch").warning(
                "kernel build cache disabled: cannot use %s (%s); building cold", chosen, why
            )
            chosen = None
    with _LOCK:
        _DIR = chosen if chosen is not None else _cold_dir()
    return None if chosen is None else str(chosen)


def build_dir() -> Path:
    """The directory the kernel libraries are built into and loaded from,
    resolved on first use as the CLI resolves it (``maybe_enable(default=True)``)."""
    with _LOCK:
        resolved = _DIR
    if resolved is None:
        maybe_enable(default=True)
        with _LOCK:
            resolved = _DIR
    return resolved


def export(env: Dict[str, str]) -> Dict[str, str]:
    """`env`, a child process's environment, naming this process's build
    directory in ``OPENSIM_JIT_CACHE``."""
    env["OPENSIM_JIT_CACHE"] = str(build_dir())
    return env


def cache_stats() -> Optional[dict]:
    """``{"dir", "files", "bytes"}`` over the files directly in the build
    directory (the libraries and their ptxas reports), None when it does not
    exist yet. Not yet resolved, it reads the directory the knob names
    without creating one. An O(entries) scan, for debug and metrics reads,
    never a request's path."""
    with _LOCK:
        cache_dir = _DIR
    if cache_dir is None:
        raw = envknobs.raw("OPENSIM_JIT_CACHE")
        if raw == "0":
            return None
        cache_dir = Path(raw) if raw not in ("", "1") else DEFAULT_DIR
    files = total = 0
    try:
        with os.scandir(cache_dir) as it:
            for entry in it:
                try:
                    if entry.is_file():
                        files += 1
                        total += entry.stat().st_size
                except OSError:
                    continue  # removed mid-scan (a concurrent build's temp file)
    except OSError:
        return None
    return {"dir": str(cache_dir), "files": files, "bytes": total}
