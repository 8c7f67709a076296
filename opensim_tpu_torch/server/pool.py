"""Bounded worker pool for the server's concurrent core — the port's copy
of ``opensim_tpu/server/pool.py``.

Unbatchable requests (newnodes, and every request with the encode cache
off) run concurrently through this pool instead of serializing behind a
single-flight TryLock, bounded by ``OPENSIM_WORKERS`` so a traffic spike
degrades into queueing and shedding (``server/admission.py``) instead of
unbounded thread creation.

Two modes (``OPENSIM_WORKERS_MODE``):

- ``thread`` (the ``auto`` default): a ``ThreadPoolExecutor``. A request's
  kernel launch and its host copies release the GIL, so threads overlap
  the card's work; host prep (expand and encode, Python and numpy) still
  contends.
- ``process``: a forked worker pool for the GIL-bound host half, proven
  live by a probe task at start, running picklable top-level tasks; the
  rest run on threads. A forked child cannot use its parent's CUDA
  context, so a server on a card refuses this mode at start (``device``);
  on the CPU it runs as the reference's, whose fork probe and thread
  fallback it keeps.

The pool never owns correctness: per-entry prep-cache locks still
serialize touches of shared pod objects, exactly as on the solo path.
"""

from __future__ import annotations

import concurrent.futures
import logging
import multiprocessing
import os
from typing import Callable, Optional

from ..utils import envknobs

log = logging.getLogger("opensim_tpu_torch.server")

__all__ = ["WorkerPool", "worker_count", "worker_mode"]


def worker_count() -> int:
    """``OPENSIM_WORKERS``: bounded concurrency for unbatchable requests.
    Default: half the visible cores, clamped to [2, 8]. A typo degrades
    to the default with a warning, never a startup crash."""
    raw = envknobs.raw("OPENSIM_WORKERS")
    if raw:
        try:
            return max(1, int(raw))
        except ValueError:
            log.warning("ignoring unparseable OPENSIM_WORKERS=%r", raw)
    return max(2, min(8, (os.cpu_count() or 2) // 2))


def worker_mode() -> str:
    raw = envknobs.raw("OPENSIM_WORKERS_MODE", "auto").strip().lower() or "auto"
    if raw not in ("auto", "thread", "process"):
        log.warning("ignoring unknown OPENSIM_WORKERS_MODE=%r (using auto)", raw)
        return "auto"
    return raw


def _probe() -> int:
    """Trivial top-level task proving a forked worker can execute and
    answer (module-level, so it pickles by reference)."""
    return 42


class WorkerPool:
    """submit(fn, *args) -> Future, over threads or forked processes.

    In process mode only picklable tasks cross into the forked workers;
    anything that cannot pickle (bound methods, admission Tickets carrying
    ``threading.Event``s) runs on the thread executor instead, with a
    one-time warning, so a submit() never hangs a client on a pickling
    error. `device` (the server's): on a CUDA device process mode raises
    here, at the server's start."""

    def __init__(self, workers: Optional[int] = None, mode: Optional[str] = None, device=None):
        self.workers = workers if workers is not None else worker_count()
        want = mode if mode is not None else worker_mode()
        if want == "process" and getattr(device, "type", device) == "cuda":
            raise RuntimeError(
                "OPENSIM_WORKERS_MODE=process: a forked worker cannot use the server's CUDA context (CUDA does "
                "not survive fork); use thread mode on a card"
            )
        self.mode = "thread"
        self._proc_pool: Optional[concurrent.futures.Executor] = None
        # a one-shot flag whose worst race is a duplicate log line
        self._warned_unpicklable = False
        if want == "process":
            pool = self._try_process_pool()
            if pool is not None:
                self._proc_pool, self.mode = pool, "process"
            else:
                log.warning("OPENSIM_WORKERS_MODE=process unavailable on this platform; falling back to threads")
        # the thread executor always exists: the sole executor in thread
        # mode and the unpicklable-task fallback in process mode
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=self.workers, thread_name_prefix="simon-worker")

    def _try_process_pool(self) -> Optional[concurrent.futures.Executor]:
        """Fork-based pool, proven live by a probe task: a runtime whose
        forked children wedge must surface now, at start, not on the first
        real request."""
        if "fork" not in multiprocessing.get_all_start_methods():
            return None
        try:
            ctx = multiprocessing.get_context("fork")
            pool = concurrent.futures.ProcessPoolExecutor(max_workers=self.workers, mp_context=ctx)
            if pool.submit(_probe).result(timeout=10.0) != 42:
                pool.shutdown(wait=False)
                return None
            return pool
        except Exception as e:  # platform-specific fork/pipe failures
            log.warning("process worker pool probe failed (%s: %s)", type(e).__name__, e)
            return None

    def submit(self, fn: Callable, *args, **kwargs) -> concurrent.futures.Future:
        if self._proc_pool is not None:
            import pickle

            try:
                pickle.dumps((fn, args, kwargs))
            except Exception:
                if not self._warned_unpicklable:
                    self._warned_unpicklable = True
                    log.warning("process worker pool: task %r is not picklable; running such tasks on threads "
                                "instead", getattr(fn, "__qualname__", fn))
                return self._pool.submit(fn, *args, **kwargs)
            return self._proc_pool.submit(fn, *args, **kwargs)
        return self._pool.submit(fn, *args, **kwargs)

    def shutdown(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)
        if self._proc_pool is not None:
            self._proc_pool.shutdown(wait=False, cancel_futures=True)
