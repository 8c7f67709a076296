"""Checkpoint / resume of simulation state — the port's copy of
``opensim_tpu/utils/checkpoint.py``, in its file format (version 1, the
same keys), so a checkpoint written by either package loads in the other.

The encoded cluster and the scan's state are plain arrays, so snapshotting
mid-plan is a single ``np.savez_compressed``: a long plan resumes from the
state after its first k pods, or an encoded 50k-pod cluster is shared
between processes. :func:`save_state` takes the host NamedTuples or
tensors on any device; :func:`load_state` returns host NamedTuples, which
``encoding.state.to_device`` moves. A resume is one launch from the loaded
state: ``engine.fastpath.schedule(prep, [(build_inputs(prep,
segment=True), k, P)], init=state)``, with ``engine.explain.replay_state``
giving the state after the first k pods of a run.
"""

from __future__ import annotations

import json
from typing import Tuple

import numpy as np
import torch

from ..encoding.dtypes import log_size_table
from ..encoding.state import EncodedCluster, ScanState

_FORMAT_VERSION = 1


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def save_state(path: str, ec: EncodedCluster, st: ScanState, extra: dict | None = None) -> None:
    arrays = {}
    for name, arr in ec._asdict().items():
        arrays[f"ec_{name}"] = _host(arr)
    for name, arr in st._asdict().items():
        arrays[f"st_{name}"] = _host(arr)
    arrays["__meta__"] = np.frombuffer(
        json.dumps({"version": _FORMAT_VERSION, "extra": extra or {}}).encode(), dtype=np.uint8
    )
    np.savez_compressed(_npz_path(path), **arrays)


def load_state(path: str) -> Tuple[EncodedCluster, ScanState, dict]:
    with np.load(_npz_path(path)) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        if meta.get("version") != _FORMAT_VERSION:
            raise ValueError(f"{path}: unsupported checkpoint version {meta.get('version')}")
        fields = {k[3:]: data[k] for k in data.files if k.startswith("ec_")}
        # additive-field compatibility: version-1 checkpoints written before
        # gc_mask and log_sizes existed load with the conservative default
        # (all-static allocatable, exactly their behaviour when saved) and
        # the shared log table the encoder builds
        if "gc_mask" not in fields:
            fields["gc_mask"] = np.zeros((fields["alloc"].shape[1],), dtype=bool)
        if "log_sizes" not in fields:
            fields["log_sizes"] = log_size_table(fields["alloc"].shape[0])
        ec = EncodedCluster(**fields)
        st = ScanState(**{k[3:]: data[k] for k in data.files if k.startswith("st_")})
    return ec, st, meta.get("extra", {})
