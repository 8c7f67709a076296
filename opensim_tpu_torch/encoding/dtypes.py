"""Encoder dtype policy — the single place width decisions live.

The scheduler does resource math in float32-comparable space and keys
everything else by integer id, and placements are compared bit-exactly
across engines. Every array the encoder builds therefore names its dtype
from here.

``ARENA_CONTRACTS``/``STATE_CONTRACTS`` declare, for every
``EncodedCluster``/``ScanState`` field, its ``(policy dtype name, symbolic
axis names)``; ``encoding.state.to_device`` moves each field to torch with
the dtype its contract names (torch's own defaults are int64/float32, so
nothing is left to inference).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

#: All resource/score/weight tensors. Go parity: float32 end to end — a
#: float64 leak changes rounding and can flip score ties.
FLOAT_DTYPE = np.float32

#: All id/index tensors (template ids, vocab ids, domain ids, node indices).
INT_DTYPE = np.int32

#: Quantities that must round-trip Go int64 exactly (resourceVersion,
#: replica counts) stay host-side Python ints; when they must enter an
#: array, this is the dtype.
INT64_DTYPE = np.int64

#: Accumulation dtype for the log(k+2) topology-spread weight table — the
#: one sanctioned float64 in the encoder. The table is computed in float64
#: and cast to FLOAT_DTYPE so every engine gathers bitwise-identical
#: weights (an f32 log differs from numpy's by 1 ulp on ~3% of inputs,
#: enough to flip score ties).
LOG_ACC_DTYPE = np.float64


def log_size_table(n: int) -> np.ndarray:
    """The shared [n+1] float32 log(k+2) lookup (see LOG_ACC_DTYPE).

    Used by the encoder (encoding/state.py); every consumer must see the
    same bits for the same node count."""
    return np.log(np.arange(n + 1, dtype=LOG_ACC_DTYPE) + 2.0).astype(FLOAT_DTYPE)


# --------------------------------------------------------------------------
# Array contract registry
# --------------------------------------------------------------------------

#: Structural dtype for mask arenas.
BOOL_DTYPE = np.bool_

#: (policy-constant name, symbolic axes) for every ``EncodedCluster`` field.
#: Key set equals ``EncodedCluster._fields`` (tests/test_torch_encoding.py).
ARENA_CONTRACTS: Dict[str, Tuple[str, Tuple[str, ...]]] = {
    # nodes
    "node_valid": ("BOOL_DTYPE", ("N",)),
    "alloc": ("FLOAT_DTYPE", ("N", "R")),
    "unschedulable": ("BOOL_DTYPE", ("N",)),
    "taint_key": ("INT_DTYPE", ("N", "Tt")),
    "taint_val": ("INT_DTYPE", ("N", "Tt")),
    "taint_effect": ("INT_DTYPE", ("N", "Tt")),
    "label_val": ("INT_DTYPE", ("N", "K")),
    "label_num": ("FLOAT_DTYPE", ("N", "K")),
    "node_domain": ("INT_DTYPE", ("N", "Tk")),
    "domain_topo": ("INT_DTYPE", ("D+1",)),
    # templates
    "req": ("FLOAT_DTYPE", ("U", "R")),
    "tol_valid": ("BOOL_DTYPE", ("U", "Tl")),
    "tol_key": ("INT_DTYPE", ("U", "Tl")),
    "tol_op": ("INT_DTYPE", ("U", "Tl")),
    "tol_val": ("INT_DTYPE", ("U", "Tl")),
    "tol_effect": ("INT_DTYPE", ("U", "Tl")),
    "ns_key": ("INT_DTYPE", ("U", "Qs")),
    "ns_val": ("INT_DTYPE", ("U", "Qs")),
    "has_req_aff": ("BOOL_DTYPE", ("U",)),
    "aff_term_valid": ("BOOL_DTYPE", ("U", "T")),
    "aff_key": ("INT_DTYPE", ("U", "T", "Q")),
    "aff_op": ("INT_DTYPE", ("U", "T", "Q")),
    "aff_val": ("INT_DTYPE", ("U", "T", "Q", "Vv")),
    "aff_num": ("FLOAT_DTYPE", ("U", "T", "Q")),
    "pna_weight": ("FLOAT_DTYPE", ("U", "Pp")),
    "pna_key": ("INT_DTYPE", ("U", "Pp", "Q")),
    "pna_op": ("INT_DTYPE", ("U", "Pp", "Q")),
    "pna_val": ("INT_DTYPE", ("U", "Pp", "Q", "Vv")),
    "pna_num": ("FLOAT_DTYPE", ("U", "Pp", "Q")),
    "ports": ("INT_DTYPE", ("U", "Hp")),
    "port_conflict": ("BOOL_DTYPE", ("Hports", "Hports")),
    "spr_topo": ("INT_DTYPE", ("U", "Cs")),
    "spr_sel": ("INT_DTYPE", ("U", "Cs")),
    "spr_skew": ("INT_DTYPE", ("U", "Cs")),
    "spr_hard": ("BOOL_DTYPE", ("U", "Cs")),
    "at_sel": ("INT_DTYPE", ("U", "Ti")),
    "at_topo": ("INT_DTYPE", ("U", "Ti")),
    "an_sel": ("INT_DTYPE", ("U", "Tn")),
    "an_topo": ("INT_DTYPE", ("U", "Tn")),
    "pt_sel": ("INT_DTYPE", ("U", "Tpp")),
    "pt_topo": ("INT_DTYPE", ("U", "Tpp")),
    "pt_w": ("FLOAT_DTYPE", ("U", "Tpp")),
    "matches_sel": ("BOOL_DTYPE", ("U", "A")),
    "anti_g": ("BOOL_DTYPE", ("U", "G")),
    "prefg_w": ("FLOAT_DTYPE", ("U", "Gp")),
    "pin": ("INT_DTYPE", ("U",)),
    # global term tables
    "anti_g_sel": ("INT_DTYPE", ("G",)),
    "anti_g_topo": ("INT_DTYPE", ("G",)),
    "prefg_sel": ("INT_DTYPE", ("Gp",)),
    "prefg_topo": ("INT_DTYPE", ("Gp",)),
    # gpu-share extension
    "gpu_mem": ("FLOAT_DTYPE", ("U",)),
    "gpu_count": ("INT_DTYPE", ("U",)),
    "node_gpu_mem": ("FLOAT_DTYPE", ("N", "Gd")),
    "gc_mask": ("BOOL_DTYPE", ("R",)),
    # open-local extension
    "avoid_score": ("FLOAT_DTYPE", ("U", "N")),
    "lvm_req": ("FLOAT_DTYPE", ("U",)),
    "dev_req": ("FLOAT_DTYPE", ("U", "2")),
    "dev_req_count": ("INT_DTYPE", ("U", "2")),
    "dev_req_sizes": ("FLOAT_DTYPE", ("U", "2", "Mv")),
    "node_vg_cap": ("FLOAT_DTYPE", ("N", "Vg")),
    "node_dev_cap": ("FLOAT_DTYPE", ("N", "Dv")),
    "node_dev_media": ("INT_DTYPE", ("N", "Dv")),
    "log_sizes": ("FLOAT_DTYPE", ("N+1",)),
}

#: (policy-constant name, symbolic axes) for every ``ScanState`` field —
#: the scan carry is float32 end to end (Go score parity).
STATE_CONTRACTS: Dict[str, Tuple[str, Tuple[str, ...]]] = {
    "used": ("FLOAT_DTYPE", ("N", "R")),
    "port_used": ("FLOAT_DTYPE", ("N", "Hports")),
    "dom_sel": ("FLOAT_DTYPE", ("D+1", "A")),
    "dom_anti": ("FLOAT_DTYPE", ("D+1", "G")),
    "dom_prefw": ("FLOAT_DTYPE", ("D+1", "Gp")),
    "gpu_free": ("FLOAT_DTYPE", ("N", "Gd")),
    "vg_free": ("FLOAT_DTYPE", ("N", "Vg")),
    "dev_free": ("FLOAT_DTYPE", ("N", "Dv")),
}
