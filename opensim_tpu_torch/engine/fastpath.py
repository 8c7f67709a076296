"""Envelope check and input marshalling for the bind-scan kernel.

`why_not()` decides whether a prepared simulation lies inside what the
port's kernel computes (fit, spread, least/balanced/share scores, GPU
share with the dynamic gpu-count allocatable, the NodeAffinity,
TaintToleration and NodePreferAvoidPods score tables, host ports,
inter-pod affinity, Open-Local storage, selectHost, bind; under a
scheduler config, its weights, filter switches and fit-ignored
resources); `build_inputs()` turns the encoded cluster into the kernel's
tensors for one config; `schedule()` runs it over the stream (one launch,
or one launch per profile segment carrying the state), `sweep()` over a
batch of scenarios. The counterpart in the JAX package is
``opensim_tpu/engine/fastpath.py``; the TPU layout rules there (128-lane
node padding, 8-row GPU, VG, device, port and term-row padding,
transposed scalar tables, chunked pod streams) and its VMEM- and
SMEM-derived caps have no place here, but the kernel gets the same
quantities.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..encoding import vocab as V
from ..ops import kernels
from ..ops.fast_scan import MAX_CS, MAX_DV, MAX_GD, MAX_R, FastInputs, fast_scan, fast_scan_sweep, variant
from .schedconfig import SchedulerConfig

HOSTNAME = "kubernetes.io/hostname"

#: Zone-like topology keys besides the hostname (per-key count blocks).
MAX_ZONE_KEYS = 4
#: Float32 holds every integer below 2^24 exactly: the bound on the
#: inter-pod weight sums that the kernel and its plain version add in
#: different orders.
EXACT_INT = 2 ** 24


def interpod_weight_bound(ec, tmpl_ids: np.ndarray) -> float:
    """An upper bound on |the inter-pod raw score| of any node at any step
    of the stream: every pod counted under each of its template's preferred
    terms, plus every pod's symmetric preferred and hard-affinity weights."""
    pt = np.abs(np.asarray(ec.pt_w, np.float64)).sum(1)  # [U]
    prefg = np.abs(np.asarray(ec.prefg_w, np.float64)).sum(1)  # [U]
    P = len(tmpl_ids)
    return float(P * (pt.max() if pt.size else 0.0) + prefg[np.asarray(tmpl_ids)].sum())


def why_not(prep, cfg: Optional[SchedulerConfig] = None) -> Optional[str]:
    """None when the prepared simulation runs on the port's bind-scan
    kernel under scheduler config `cfg` (None: the default), else a
    one-line reason. Every config that ``schedconfig`` parses runs; one
    built by hand must keep finite weights and ignore only resource rows
    the cluster has. The caps are what the CUDA kernel
    takes: R ≤ 8 resources, Cs ≤ 8 spread constraints per template and
    Gd ≤ 8 GPUs per node (per-thread tables), Dv ≤ 64 exclusive devices per
    node (the bits of the bind's per-pod taken mask), hostname plus at most
    four zone keys, and hostname domains that identify nodes. The number of
    templates is not capped: the template tables live in global memory and
    the kernel reads them with 64-bit offsets. Nor are host-port ids,
    inter-pod terms per template, existing-pod term rows, volume groups per
    node or device volumes per template: the kernel loops over them in
    global memory and holds no per-thread table of them. The inter-pod
    sums must stay exact in any order, so `interpod_weight_bound` must stay
    below 2^24."""
    f = prep.features
    ec = prep.ec_np
    R = int(ec.alloc.shape[1])
    Cs = int(ec.spr_topo.shape[1])
    Gd = int(ec.node_gpu_mem.shape[1])
    Dv = int(ec.node_dev_cap.shape[1])
    if R > MAX_R or Cs > MAX_CS:
        return f"R={R} resources or Cs={Cs} spread constraints per template exceed the kernel's {MAX_R}/{MAX_CS}"
    if f.gpu and Gd > MAX_GD:
        return f"{Gd} GPUs per node exceed the kernel's {MAX_GD}"
    if f.local and Dv > MAX_DV:
        return f"{Dv} exclusive devices per node exceed the kernel's {MAX_DV}"
    topo_keys = prep.meta.vocab.topo_keys.items()
    non_host = [k for k in topo_keys if k != HOSTNAME]
    if len(non_host) > MAX_ZONE_KEYS:
        return f"{len(non_host)} non-hostname topology keys > {MAX_ZONE_KEYS} supported"
    # hostname domains must be node-identity (each valid node carries its
    # own hostname label) for the per-node count layout to be exact
    if HOSTNAME in topo_keys:
        tk = topo_keys.index(HOSTNAME)
        nd = np.asarray(ec.node_domain)[:, tk]
        nv = np.asarray(ec.node_valid)
        trash = np.asarray(ec.domain_topo).shape[0] - 1
        if (nd[nv] == trash).any():
            return "some valid nodes carry no hostname label"
        if len(np.unique(nd[nv])) != int(nv.sum()):
            return "hostname domains are not node-identity (duplicate hostname labels)"
    if f.interpod or f.prefg:
        bound = interpod_weight_bound(ec, prep.tmpl_ids)
        if bound >= EXACT_INT:
            return f"inter-pod weights may sum to {bound:.0f} >= 2^24, past float32's exact integers"
    try:
        kernels.kernel_config(cfg, R)
    except ValueError as e:
        return f"scheduler config: {e}"
    return None


def _to(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)


def build_inputs(
    prep, node_valid: Optional[np.ndarray] = None, cfg: Optional[SchedulerConfig] = None, segment: bool = False,
) -> Tuple[FastInputs, Dict[str, np.ndarray]]:
    """The kernel's tensors on ``prep.device``, plus the static first-fail
    counts over the valid nodes. `node_valid` ([N] bool) masks the node
    axis down to a sub-cluster (None: the encoded validity); three inputs
    follow it: the kernel's validity row, the spread weights (log of the
    topology domains the valid nodes span) and the static first-fail
    counts, so a masked run places and attributes as a fresh prepare of
    the sub-cluster would. Static tables are computed with every node
    valid; validity is the kernel's runtime row (static filters are per
    node, so this is equivalent). `cfg` (a scheduler config; None or the
    default: the default variant) switches the static filters in the
    tables and goes to the kernel as ``FastInputs.cfg``; a `segment` of a
    segmented multi-profile run takes the cfg variant whatever its config
    (``kernels.kernel_config``)."""
    ec = prep.ec_np
    core = kernels.precompute_core_np(ec)
    stat = kernels.precompute_static_np(ec._replace(node_valid=np.ones_like(ec.node_valid)), cfg, core=core)
    nv = np.asarray(ec.node_valid if node_valid is None else node_valid, dtype=bool)
    masked = kernels.precompute_static_np(ec._replace(node_valid=nv), cfg, core=core)
    N = int(ec.node_valid.shape[0])
    topo_keys = prep.meta.vocab.topo_keys.items()
    zone_tks = [i for i, k in enumerate(topo_keys) if k != HOSTNAME]
    trash = np.asarray(ec.domain_topo).shape[0] - 1
    node_domain = np.asarray(ec.node_domain)

    # zone column of each node per zone key (columns in domain-id order),
    # -1 where the node lacks the label
    K = max(len(zone_tks), 1)
    zone_idx = np.full((K, N), -1, np.int32)
    for ki, tk in enumerate(zone_tks):
        zd = node_domain[:, tk]
        _ids, inv = np.unique(zd, return_inverse=True)
        present = zd != trash
        zone_idx[ki, present] = inv.reshape(-1)[present]
    n_zones = max(int(zone_idx.max()) + 1, 1)

    # topology-key index → kernel key: 0 = hostname, 1..K = zone keys
    key_lut = np.zeros((max(len(topo_keys), 1) + 1,), np.int32)
    for ki, tk in enumerate(zone_tks):
        key_lut[tk] = ki + 1
    spr_topo = np.asarray(ec.spr_topo)
    active = spr_topo >= 0
    spr_sel = np.maximum(np.asarray(ec.spr_sel), 0).astype(np.int32)
    matches_sel = np.asarray(ec.matches_sel)
    spread_weight = np.asarray(masked.spread_weight)
    spr_self = np.where(
        active, np.take_along_axis(matches_sel, spr_sel, axis=1), False
    ).astype(np.float32)
    spr_weight = np.where(active, spread_weight[np.maximum(spr_topo, 0)], 0.0).astype(np.float32)

    req = np.asarray(ec.req).astype(np.float32)
    cpu, mem = req[:, V.RES_CPU], req[:, V.RES_MEMORY]
    cpu_nz = np.where(cpu > 0, cpu, 100.0).astype(np.float32)
    mem_nz = np.where(mem > 0, mem, 200.0 * 1024 * 1024).astype(np.float32)

    # flag branches: a feature that is off gets zero-size tables
    f = prep.features
    off_un = np.zeros((0, N), np.float32)
    gpu_on = bool(f.gpu)
    gpu0 = np.asarray(prep.st0_np.gpu_free).T if gpu_on else off_un  # [Gd, N]
    ports = _port_tables(ec) if f.ports else np.zeros((2, 0, len(req)), np.float32)
    terms = _term_tables(ec, key_lut) if (f.interpod or f.prefg) else _no_terms(len(req))
    local = _local_tables(prep) if f.local else _no_local(N)

    dev = prep.device
    f32, i32 = torch.float32, torch.int32
    fi = FastInputs(
        alloc_T=_to(np.asarray(ec.alloc).T, f32, dev),
        used0_T=_to(np.asarray(prep.st0_np.used).T, f32, dev),
        static_pass=_to(stat.static_pass, f32, dev),
        aff_mask=_to(stat.aff_mask, f32, dev),
        share_raw=_to(stat.share_raw, f32, dev),
        zone_idx=_to(zone_idx, i32, dev),
        matches_AU=_to(matches_sel.T, f32, dev),
        node_valid=_to(nv, f32, dev),
        req=_to(req, f32, dev),
        cpu_nz=_to(cpu_nz, f32, dev),
        mem_nz=_to(mem_nz, f32, dev),
        pin=_to(ec.pin, i32, dev),
        spr_active=_to(active, i32, dev),
        spr_key=_to(key_lut[np.maximum(spr_topo, 0)], i32, dev),
        spr_sel=_to(spr_sel, i32, dev),
        spr_skew=_to(ec.spr_skew, f32, dev),
        spr_hard=_to(ec.spr_hard, i32, dev),
        spr_self=_to(spr_self, f32, dev),
        spr_weight=_to(spr_weight, f32, dev),
        gpu_mem=_to(np.asarray(ec.gpu_mem) if gpu_on else np.zeros(0), f32, dev),
        gpu_cnt=_to(np.asarray(ec.gpu_count) if gpu_on else np.zeros(0), f32, dev),
        gpu0=_to(gpu0, f32, dev),
        na_raw=_to(stat.na_raw if f.pref_node_affinity else off_un, f32, dev),
        tt_raw=_to(stat.tt_raw if f.prefer_taints else off_un, f32, dev),
        avoid_raw=_to(ec.avoid_score if f.prefer_avoid else off_un, f32, dev),
        port_HU=_to(ports[0], f32, dev),
        port_conf_HU=_to(ports[1], f32, dev),
        **{name: _to(t, i32 if name in _TERM_I32 else f32, dev) for name, t in terms.items()},
        **{name: _to(t, f32, dev) for name, t in local.items()},
        n_zones=n_zones,
        gc_row=kernels.gc_row_of(ec) if f.gc_dyn else -1,
        cfg=kernels.kernel_config(cfg, req.shape[1], segment),
    )
    return fi, {"static_fail": masked.static_fail}


def _local_tables(prep) -> Dict[str, np.ndarray]:
    """The Open-Local tables: per template its LVM bytes, largest device
    volume and volume count per media and each media's volume sizes
    (``dev_sizes [U, 2·Mv]``, ssd slots then hdd, descending); per node its
    VG and device capacities and initial free bytes, and the device media
    as one-hot rows (``dev_media [2·Dv, N]``, row m·Dv + d)."""
    ec, meta = prep.ec_np, prep.meta
    media = np.asarray(meta.node_dev_media)  # [N, Dv] 0 ssd, 1 hdd, -1 none
    return {
        "lvm_req": np.asarray(ec.lvm_req),
        "dev_req": np.asarray(ec.dev_req),
        "dev_need": np.asarray(ec.dev_req_count),
        "dev_sizes": np.asarray(ec.dev_req_sizes).reshape(len(ec.req), -1),
        "vg_cap": np.asarray(meta.node_vg_cap).T,
        "vg0": np.asarray(prep.st0_np.vg_free).T,
        "dev_cap": np.asarray(meta.node_dev_cap).T,
        "dev0": np.asarray(prep.st0_np.dev_free).T,
        "dev_media": np.concatenate([media.T == m for m in range(2)]),
    }


def _no_local(N: int) -> Dict[str, np.ndarray]:
    """Zero-size Open-Local tables: the variant without local storage."""
    z = np.zeros
    return {"lvm_req": z(0), "dev_req": z((0, 2)), "dev_need": z((0, 2)), "dev_sizes": z((0, 0)),
            **{name: z((0, N)) for name in ("vg_cap", "vg0", "dev_cap", "dev0", "dev_media")}}


def _port_tables(ec) -> np.ndarray:
    """``[port_HU, port_conf_HU]``, each ``[Hp, U]`` over the port ids the
    templates use (Hp = the largest id + 1): how often each template uses
    each id, and which ids conflict with one of its own. The wildcard
    expansion (0.0.0.0 overlaps every address on the same port,
    nodeports.go) is done here, on the host."""
    ports_u = np.asarray(ec.ports)  # [U, Hp_tmpl] port ids, -1 pad
    Hp = int(ports_u.max()) + 1
    port_HU = np.zeros((Hp, ports_u.shape[0]), np.float32)
    for u, row in enumerate(ports_u):
        for h in row[row >= 0]:
            port_HU[int(h), u] += 1.0
    conf = np.asarray(ec.port_conflict)[:Hp, :Hp].astype(np.float32)
    port_conf_HU = (conf @ port_HU > 0).astype(np.float32)
    return np.stack([port_HU, port_conf_HU])


def _term_tables(ec, key_lut: np.ndarray) -> Dict[str, np.ndarray]:
    """The inter-pod term tables: the incoming pod's required affinity
    (``at_*``), required anti-affinity (``an_*``) and preferred (``pt_*``)
    terms, ``[U, T]`` each with keys 0 = hostname, 1..K = zone keys; and the
    existing pods' term rows, one per (selector, key): anti rows
    (``anti_g_key``, ``antig_GU``, ``gmatch_GU``) and preferred plus
    hard-affinity weight rows (``prefg_key``, ``prefg_GU``, ``pmatch_GU``)."""
    matches_sel = np.asarray(ec.matches_sel)
    out: Dict[str, np.ndarray] = {}
    for prefix, sel, topo in (("at", ec.at_sel, ec.at_topo), ("an", ec.an_sel, ec.an_topo),
                              ("pt", ec.pt_sel, ec.pt_topo)):
        sel = np.asarray(sel)
        out[f"{prefix}_active"] = (sel >= 0).astype(np.int32)
        out[f"{prefix}_key"] = key_lut[np.maximum(np.asarray(topo), 0)].astype(np.int32)
        out[f"{prefix}_sel"] = np.maximum(sel, 0).astype(np.int32)
    out["at_self"] = np.where(
        out["at_active"] == 1, np.take_along_axis(matches_sel, out["at_sel"], axis=1), 0.0
    ).astype(np.float32)
    out["pt_w"] = np.asarray(ec.pt_w).astype(np.float32)
    for key, carry, match, sel, topo in (
        ("anti_g_key", "antig_GU", "gmatch_GU", ec.anti_g_sel, ec.anti_g_topo),
        ("prefg_key", "prefg_GU", "pmatch_GU", ec.prefg_sel, ec.prefg_topo),
    ):
        out[key] = key_lut[np.maximum(np.asarray(topo), 0)].astype(np.int32)
        out[match] = matches_sel[:, np.asarray(sel)].T.astype(np.float32)
    out["antig_GU"] = np.asarray(ec.anti_g).T.astype(np.float32)
    out["prefg_GU"] = np.asarray(ec.prefg_w).T.astype(np.float32)
    return out


_TERM_I32 = {f"{p}_{f}" for p in ("at", "an", "pt") for f in ("active", "key", "sel")} | {"anti_g_key", "prefg_key"}


def _no_terms(U: int) -> Dict[str, np.ndarray]:
    """Zero-size inter-pod tables: the variant without inter-pod terms."""
    i32, f32 = np.zeros((U, 0), np.int32), np.zeros((U, 0), np.float32)
    out = {f"{p}_{f}": i32 for p in ("at", "an", "pt") for f in ("active", "key", "sel")}
    out.update(at_self=f32, pt_w=f32, anti_g_key=np.zeros(0, np.int32), prefg_key=np.zeros(0, np.int32))
    out.update({name: np.zeros((0, U), np.float32) for name in ("antig_GU", "gmatch_GU", "prefg_GU", "pmatch_GU")})
    return out


def inputs_from_reference(
    arrays: Dict[str, np.ndarray],
    device,
    features,
    gc_row: int = -1,
    n_nodes: Optional[int] = None,
    n_gpus: Optional[int] = None,
    n_ports: Optional[int] = None,
    n_anti: Optional[int] = None,
    n_pref: Optional[int] = None,
    n_vg: Optional[int] = None,
    n_dev: Optional[int] = None,
) -> FastInputs:
    """The port's inputs from the JAX package's ``FastInputs`` as numpy
    (``fi._asdict()`` of ``opensim_tpu.engine.fastpath.build_inputs``),
    with the flags of its ``features`` and its ``gc_row``: drops the
    node-lane padding past `n_nodes`, and the GPU, port-id, anti and
    preferred term, VG and device rows padded past `n_gpus`, `n_ports`,
    `n_anti`, `n_pref`, `n_vg` and `n_dev` (None keeps every lane or row),
    gives the tables of a feature that is off zero size, turns the one-hot
    zone blocks ``zone_NZ [K, N, Z]`` into zone columns, flattens
    ``node_valid [1, N]``. Other tables keep their layout; the selector
    rows padded to a multiple of 8 stay, as no constraint names them."""
    a = {k: np.asarray(v) for k, v in arrays.items()}
    N = a["alloc_T"].shape[1] if n_nodes is None else int(n_nodes)
    Gd = a["gpu0_DN"].shape[0] if n_gpus is None else int(n_gpus)
    zone_NZ = a["zone_NZ"][:, :N]  # [K, N, Z]
    has_zone = a["has_zone"][:, :N] > 0
    zone_idx = np.where(has_zone, zone_NZ.argmax(-1), -1).astype(np.int32)
    f32, i32 = torch.float32, torch.int32
    nodes = lambda name: a[name][..., :N]
    off_un = np.zeros((0, N), np.float32)
    gpu_on = bool(features.gpu)
    U = a["req"].shape[0]
    ports = [a[name][:n_ports] if features.ports else np.zeros((0, U)) for name in ("port_HU", "port_conf_HU")]
    if features.interpod or features.prefg:
        terms = {name: a[name] for name in _no_terms(U)}
        for names, rows in ((("anti_g_key", "antig_GU", "gmatch_GU"), n_anti),
                            (("prefg_key", "prefg_GU", "pmatch_GU"), n_pref)):
            terms.update({name: a[name][:rows] for name in names})
    else:
        terms = _no_terms(U)
    if features.local:
        Dp = a["dev0_DN"].shape[0]  # the JAX package's padded device rows
        Vg = a["vg0_VN"].shape[0] if n_vg is None else int(n_vg)
        Dv = Dp if n_dev is None else int(n_dev)
        media = a["dev_media_DN"]
        local = {
            "lvm_req": a["lvm_req"], "dev_req": a["dev_req"], "dev_need": a["dev_need"],
            "dev_sizes": a["dev_sizes"], "vg_cap": nodes("vg_cap_VN")[:Vg], "vg0": nodes("vg0_VN")[:Vg],
            "dev_cap": nodes("dev_cap_DN")[:Dv], "dev0": nodes("dev0_DN")[:Dv],
            "dev_media": np.concatenate([media[:Dv, :N], media[Dp:Dp + Dv, :N]]),
        }
    else:
        local = _no_local(N)
    return FastInputs(
        alloc_T=_to(nodes("alloc_T"), f32, device),
        used0_T=_to(nodes("used0_T"), f32, device),
        static_pass=_to(nodes("static_pass"), f32, device),
        aff_mask=_to(nodes("aff_mask"), f32, device),
        share_raw=_to(nodes("share_raw"), f32, device),
        zone_idx=_to(zone_idx, i32, device),
        matches_AU=_to(a["matches_AU"], f32, device),
        node_valid=_to(a["node_valid"].reshape(-1)[:N], f32, device),
        req=_to(a["req"], f32, device),
        cpu_nz=_to(a["cpu_nz"], f32, device),
        mem_nz=_to(a["mem_nz"], f32, device),
        pin=_to(a["pin"], i32, device),
        spr_active=_to(a["spr_active"], i32, device),
        spr_key=_to(a["spr_key"], i32, device),
        spr_sel=_to(a["spr_sel"], i32, device),
        spr_skew=_to(a["spr_skew"], f32, device),
        spr_hard=_to(a["spr_hard"], i32, device),
        spr_self=_to(a["spr_self"], f32, device),
        spr_weight=_to(a["spr_weight"], f32, device),
        gpu_mem=_to(a["gpu_mem"] if gpu_on else np.zeros(0), f32, device),
        gpu_cnt=_to(a["gpu_cnt"] if gpu_on else np.zeros(0), f32, device),
        gpu0=_to(nodes("gpu0_DN")[:Gd] if gpu_on else off_un, f32, device),
        na_raw=_to(nodes("na_raw") if features.pref_node_affinity else off_un, f32, device),
        tt_raw=_to(nodes("tt_raw") if features.prefer_taints else off_un, f32, device),
        avoid_raw=_to(nodes("avoid_raw") if features.prefer_avoid else off_un, f32, device),
        port_HU=_to(ports[0], f32, device),
        port_conf_HU=_to(ports[1], f32, device),
        **{name: _to(t, i32 if name in _TERM_I32 else f32, device) for name, t in terms.items()},
        **{name: _to(t, f32, device) for name, t in local.items()},
        n_zones=max(int(zone_idx.max()) + 1, 1),
        gc_row=int(gc_row) if features.gc_dyn else -1,
    )


def pod_stream(prep, pod_valid: Optional[np.ndarray] = None):
    """(tmpl, valid, forced) int32 tensors of the prepared stream on
    ``prep.device``; `pod_valid` ([P] bool) masks pods out of the stream
    (None: every pod is valid)."""
    valid = np.ones(len(prep.tmpl_ids), bool) if pod_valid is None else np.asarray(pod_valid, dtype=bool)
    i32 = torch.int32
    return (
        _to(prep.tmpl_ids, i32, prep.device),
        _to(valid, i32, prep.device),
        _to(prep.forced, i32, prep.device),
    )


class Scheduled(NamedTuple):
    """Host copies of a scan's results, in the encoder's layouts, and the
    failure attribution of the pods that found no node (in explain mode
    of every pod not forced): the dynamic filters' first-fail counts and
    the shortages of each pod (zero rows for the others), and the static
    filters' of each pod (its template's row under the config of its
    launch)."""

    chosen: np.ndarray  # [P] i32 node index, -1 unplaced
    used: np.ndarray  # [N, R] f32
    gpu_take: np.ndarray  # [P, Gd] f32 GPU slots per device
    gpu_free: np.ndarray  # [N, Gd] f32 final free memory per GPU
    port_used: np.ndarray  # [N, Hports] f32 final use of each host-port id
    vg_free: np.ndarray  # [N, Vg] f32 final free bytes per volume group
    dev_free: np.ndarray  # [N, Dv] f32 final free bytes per device, 0 once taken
    fail_counts: np.ndarray  # [P, fast_scan.N_FAIL] i32 nodes failing each dynamic filter first
    insufficient: np.ndarray  # [P, R] i32 nodes short of each resource
    static_fail: np.ndarray  # [P, 4] i32 nodes failing each static filter first, per pod


def schedule(
    prep,
    segments: List[Tuple[Tuple[FastInputs, Dict[str, np.ndarray]], int, int]],
    pod_valid: Optional[np.ndarray] = None,
    tie_seed: Optional[int] = None,
    explain: bool = False,
) -> Scheduled:
    """Run the bind scan over the prepared stream: the kernel on a card,
    the plain version on the CPU. `segments` (``[(built, lo, hi)]``,
    contiguous runs covering the stream in order, each with
    :func:`build_inputs`'s result for its config and node mask) are one
    launch each, each starting from the previous launch's final state: one
    run for a single config, one per profile segment for the reference's
    segmented multi-profile path. `pod_valid` ([P] bool) masks pods out of
    the stream; `tie_seed` samples each step's node among the best scores
    (the one scan's ``tie_seed``); `explain` runs each launch in explain
    mode, which counts the rejections of every pod not forced, so
    ``fail_counts``/``insufficient`` hold a row per such pod. Without
    GPU-share pods the scan leaves the GPUs as they were (no takes, the
    initial free memory), without host ports the ports, and without
    local-storage pods the volume groups and devices."""
    tmpl, valid, forced = pod_stream(prep, pod_valid)
    outs, state = [], None
    for (fi, meta), lo, hi in segments:
        if hi <= lo:
            continue
        out = fast_scan(fi, tmpl[lo:hi], valid[lo:hi], forced[lo:hi], init=state, tie_seed=tie_seed, draw_base=lo,
                        explain=explain)
        outs.append((out, meta, lo, hi))
        state = out.state
    host = lambda t: t.T.contiguous().cpu().numpy()
    cat = lambda field: np.concatenate([getattr(o, field).cpu().numpy() for o, *_ in outs])
    chosen = cat("chosen")
    static_fail = np.concatenate([meta["static_fail"][prep.tmpl_ids[lo:hi]] for _o, meta, lo, hi in outs])
    out, fi = outs[-1][0], segments[-1][0][0]
    v = variant(fi)
    st0 = prep.st0_np
    if v.gpu:
        gpu_take, gpu_free = cat("gpu_take"), host(out.gpu_free)
    else:
        gpu_free = np.asarray(st0.gpu_free)
        gpu_take = np.zeros((len(chosen), gpu_free.shape[1]), np.float32)
    port_used = np.array(st0.port_used, copy=True)  # port ids past the templates' stay unused
    port_used[:, : fi.port_HU.shape[0]] = host(out.port_used)
    vg_free, dev_free = (host(out.vg_free), host(out.dev_free)) if v.local else (st0.vg_free, st0.dev_free)
    return Scheduled(chosen, host(out.used), gpu_take, gpu_free, port_used, np.asarray(vg_free),
                     np.asarray(dev_free), cat("fail_counts"), cat("insufficient"), static_fail)


class _SweepContext:
    """Host-side tables hoisted out of the per-scenario loop
    (``opensim_tpu/engine/fastpath.py:449-472``)."""

    def __init__(self, prep) -> None:
        ec = prep.ec_np
        self.node_domain = np.asarray(ec.node_domain)
        self.trash = np.asarray(ec.domain_topo).shape[0] - 1
        self.spr_topo = np.asarray(ec.spr_topo)
        self.log_sizes = np.asarray(ec.log_sizes)

    def spread_weights(self, node_valid: np.ndarray) -> np.ndarray:
        """[U, Cs] log(size + 2) table for a scenario's valid nodes (domain
        counts depend on them). The weights are gathers from the shared
        ``ec.log_sizes`` table, never a log on the device: a 1-ulp
        difference would flip ties."""
        Tk = self.node_domain.shape[1]
        sizes = np.zeros((Tk,), np.int64)
        for tk in range(Tk):
            doms = self.node_domain[node_valid, tk]
            sizes[tk] = len(np.unique(doms[doms != self.trash]))
        weights = self.log_sizes[np.clip(sizes, 0, self.log_sizes.shape[0] - 1)]
        return np.where(self.spr_topo >= 0, weights[np.maximum(self.spr_topo, 0)], 0.0).astype(np.float32)


def sweep_inputs(prep, node_valid_masks, pod_valid_masks, forced_masks):
    """The scenario grid's tensors on ``prep.device`` for the kernel's
    sweep: ``tmpl [P]``, ``valid``/``forced`` int32 ``[S, P]`` from the
    bool masks, ``node_valid`` float32 ``[S, N]`` and ``spr_weight`` float32
    ``[S, U, Cs]``, the spread weights of each scenario's valid nodes."""
    nv = np.asarray(node_valid_masks, dtype=bool)
    ctx = _SweepContext(prep)
    sw = np.stack([ctx.spread_weights(row) for row in nv])
    dev = prep.device
    i32, f32 = torch.int32, torch.float32
    return (_to(prep.tmpl_ids, i32, dev), _to(np.asarray(pod_valid_masks, dtype=bool), i32, dev),
            _to(np.asarray(forced_masks, dtype=bool), i32, dev), _to(nv, f32, dev), _to(sw, f32, dev))


def sweep(prep, node_valid_masks, pod_valid_masks, forced_masks,
          segments: Optional[List[Tuple[Optional[SchedulerConfig], int, int]]] = None):
    """Scenario sweep over the prepared stream: scenario s runs the bind
    scan with node validity ``node_valid_masks[s]`` ([S, N] bool), pod
    validity ``pod_valid_masks[s]`` and forced pods ``forced_masks[s]``
    ([S, P] bool), and the spread weights of its valid nodes. `segments`
    (``[(config, lo, hi)]``, contiguous runs covering the stream; None: the
    whole stream under the default config) are one grid each on its
    config's inputs, each scenario starting from its own final state of the
    run before. All S in one launch per run on a card (B scenarios per
    block), the plain version scenario by scenario on the CPU. Returns host
    arrays (unscheduled [S] i32, used [S, N, R] f32, chosen [S, P] i32,
    vg_used [S] f32), as ``opensim_tpu/engine/fastpath.py:sweep``; VG usage
    counts only the scenario's valid nodes."""
    nv = np.asarray(node_valid_masks, dtype=bool)
    pv = np.asarray(pod_valid_masks, dtype=bool)
    if segments is None:
        segments = [(None, 0, len(prep.tmpl_ids))]
    tmpl, valid, forced, node_valid, spr_weight = sweep_inputs(prep, nv, pv, forced_masks)
    chosen, state = [], None
    for seg_cfg, lo, hi in segments:
        if hi <= lo:
            continue
        fi, _ = build_inputs(prep, cfg=seg_cfg, segment=len(segments) > 1)
        out = fast_scan_sweep(fi, tmpl[lo:hi], valid[:, lo:hi].contiguous(), forced[:, lo:hi].contiguous(),
                              node_valid, spr_weight, init=state)
        chosen.append(out.chosen.cpu().numpy())
        state = out.state
    chosen = np.concatenate(chosen, axis=1)
    unscheduled = ((chosen < 0) & pv).sum(axis=1).astype(np.int32)
    used = out.used.transpose(1, 2).contiguous().cpu().numpy()
    if variant(fi).local:
        vg0, vg_b = fi.vg0.cpu().numpy(), out.vg_free.cpu().numpy()  # [Vg, N], [S, Vg, N]
        vg_used = ((vg0[None] - vg_b) * nv[:, None, :]).sum(axis=(1, 2)).astype(np.float32)
    else:
        vg_used = np.zeros((len(nv),), np.float32)
    return unscheduled, used, chosen, vg_used
