#!/usr/bin/env python3
"""What stalls a fleet owner's other threads, its lease renewals first, at
the server plan's size:

    python3 tools/owner_stalls.py          # on the card (--device cpu: a CPU run)

Builds the server plan's live cluster (the capacity fleet of 5,000 nodes
with 25,000 pods bound by a ``simulate()`` on the device, the pods as
their watch manifests and as model objects, as a twin owner holds them),
prepares its base entry on the device as ``FleetSupervisor.publish_once``
does and publishes it through ``TwinPublisher``. A probe thread sleeps 1 ms
at a time and records the longest it waited to run again (a stall: a call
that held the GIL, or a full collection, which holds it too). It times,
each with the probe's longest stall beside it:

- the publication as the port writes it (its arrays hashed and copied
  into shared memory without the GIL);
- the same arrays copied as the publisher did before (``tobytes`` and a
  slice assignment into the segment, both holding the GIL);
- a full collection of the cyclic collector over that heap, and again
  after ``gc.freeze()``, as the owner does once it has built its twin.

Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


class Probe:
    """The longest gap between a 1 ms sleeper's wake-ups while it runs."""

    def __init__(self) -> None:
        self.max_s = 0.0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        last = time.perf_counter()
        while not self._stop.is_set():
            time.sleep(0.001)
            now = time.perf_counter()
            self.max_s = max(self.max_s, now - last)
            last = now

    def __enter__(self) -> "Probe":
        self._thread.start()
        time.sleep(0.02)
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()


def _timed(fn) -> dict:
    with Probe() as probe:
        t0 = time.perf_counter()
        fn()
        seconds = time.perf_counter() - t0
    return {"seconds": round(seconds, 6), "longest_stall_s": round(probe.max_s, 6)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cpu for a CPU run; the card by default")
    ap.add_argument("--nodes", type=int, default=5000, help="nodes of the capacity fleet (the server plan's 5,000)")
    ap.add_argument("--pods", type=int, default=50000,
                    help="the capacity plan's pods, of which the first half are bound (the server plan's 50,000)")
    args = ap.parse_args()
    import io

    import numpy as np

    sys.path.insert(0, str(ROOT))
    from opensim_tpu_torch.device import resolve_device
    from opensim_tpu_torch.engine import prepcache
    from opensim_tpu_torch.engine.simulator import AppResource, prepare, simulate
    from opensim_tpu_torch.models import expand, fixtures as fx
    from opensim_tpu_torch.server.fleet import TwinPublisher, _shm_cls, _ShmPickler

    device = resolve_device(args.device)
    card = "CPU"
    if device.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    seed = simulate(fx.synthetic_cluster(args.nodes),
                    [AppResource("seed", fx.server_apps(args.pods, 0, fx.SERVER_BOUND))], device=device)
    manifests = [fx.snapshot_pod(p) for ns in seed.node_status for p in ns.pods]
    del seed
    cluster = fx.synthetic_cluster(args.nodes)
    live, skipped = expand.resources_from_dicts([json.loads(json.dumps(m)) for m in manifests])
    cluster.pods = live.pods
    build_s = time.perf_counter() - t0
    out = {"card": card, "nodes": args.nodes, "pods": len(cluster.pods), "skipped": len(skipped),
           "build_s": round(build_s, 3)}

    holder = {}

    def prepare_base():
        holder["base"] = prepcache.CacheEntry("owner|base", prepare(cluster, [], device=device),
                                              watch=prepcache.watch_snapshot(cluster, []))

    out["prepare"] = _timed(prepare_base)
    base = holder["base"]
    with base.lock:
        base.restore()
        parts = prepcache.publication_parts(base)
    arrays = []  # every buffer the publication externalizes, as its pickler finds them

    def found(a):
        arrays.append(np.ascontiguousarray(a))
        return f"array-{len(arrays)}"

    _ShmPickler(io.BytesIO(), found).dump({"cluster": cluster, "parts": parts})
    out["arrays"] = {"count": len(arrays), "bytes": int(sum(a.nbytes for a in arrays)),
                     "largest": int(max(a.nbytes for a in arrays))}
    pub = TwinPublisher()
    try:
        out["publish"] = _timed(lambda: pub.publish(1, cluster, parts))
        out["publish"]["footprint"] = pub.footprint()

        def copy_holding_the_gil():
            segments = []
            try:
                for i, a in enumerate(arrays):
                    data = np.ascontiguousarray(a).tobytes()
                    segments.append(_shm_cls()(name=f"simon-fleet-stalls-{i}", create=True, size=max(1, len(data))))
                    segments[-1].buf[: len(data)] = data
            finally:
                for seg in segments:
                    seg.close()
                    seg.unlink()

        out["copy_holding_the_gil"] = _timed(copy_holding_the_gil)
    finally:
        pub.close()
    out["objects_tracked"] = len(gc.get_objects())
    out["full_collection"] = _timed(gc.collect)
    gc.freeze()
    out["frozen"] = gc.get_freeze_count()
    out["full_collection_after_freeze"] = _timed(gc.collect)
    gc.unfreeze()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
