"""Delta re-encoding for node addition — the part of
``opensim_tpu/engine/prepcache.py`` that ``simon apply`` uses.

The planner's first simulation prepares the cluster; its candidate sweep
needs the same cluster plus ``max_new_nodes`` candidate nodes.
:func:`extend_with_nodes` encodes only the candidates into a fork of the
first encoder and splices their DaemonSet pods into the stream at the
positions a fresh full expansion would give them, so the result equals
``prepare(cluster + candidates, apps)``: the same stream order and the
same encoded arrays. The cache of prepared inputs (``PrepareCache``) is
ROADMAP Queue 1 item 6.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..encoding.state import to_device
from ..models import expand
from ..models.objects import ResourceTypes
from ..ops import kernels
from .simulator import AppResource, Prepared, _owner_selector, _tmpl_hint, ds_targets


def _assemble_delta(
    base: Prepared,
    enc,
    ordered: List,
    tmpl_parts: List,
    forced_parts: List,
    n_cluster: int,
    ds_group_sizes: List[int],
) -> Prepared:
    """Build the forked encoder and put the result on the base's device."""
    ec_np, st0_np, meta = enc.build()
    ec, st0 = to_device(ec_np, st0_np, base.device)
    return Prepared(
        ec=ec,
        st0=st0,
        ec_np=ec_np,
        st0_np=st0_np,
        meta=meta,
        ordered=ordered,
        tmpl_ids=np.concatenate([np.asarray(p, dtype=np.int32) for p in tmpl_parts]),
        forced=np.concatenate([np.asarray(p, dtype=bool) for p in forced_parts]),
        ds_target=ds_targets(ordered, meta),
        features=kernels.features_of(ec_np),
        device=base.device,
        encoder=enc,
        n_cluster=n_cluster,
        ds_group_sizes=ds_group_sizes,
    )


def extend_with_nodes(
    base: Prepared,
    new_nodes: List,
    cluster: ResourceTypes,
    apps: List[AppResource],
    use_greed: bool = False,
) -> Optional[Prepared]:
    """`base` (prepared from `cluster` and `apps`, its pods as prepared:
    restore them first if a simulation ran on it) plus `new_nodes`, as
    ``prepare`` of the cluster with those nodes appended would encode it.
    Returns None where a delta cannot reproduce a fresh prepare, and the
    caller prepares afresh:

    - the greedy sort orders app pods by node totals, which the new nodes
      change, so the whole stream may reorder;
    - an app's DaemonSets expand one pod per node inside the app's sorted
      region, where a splice need not keep the order.
    """
    if use_greed or any(a.resources.daemon_sets for a in apps):
        return None
    # per-DaemonSet pods for the new nodes, in cluster.daemon_sets order:
    # the order _cluster_pods expands them in
    groups_new = [expand.pods_from_daemon_set(ds, new_nodes) for ds in cluster.daemon_sets]
    if len(groups_new) != len(base.ds_group_sizes):
        return None  # the cluster's DaemonSets are not the base's: not a pure node delta
    enc = base.encoder.fork()
    enc.extend_nodes(new_nodes)

    b = base.n_cluster - sum(base.ds_group_sizes)
    ordered: List = list(base.ordered[:b])
    tmpl_parts: List = [base.tmpl_ids[:b]]
    forced_parts: List = [base.forced[:b]]
    ds_group_sizes: List[int] = []
    off = b
    for size, pods_k in zip(base.ds_group_sizes, groups_new):
        ordered.extend(base.ordered[off : off + size])
        tmpl_parts.append(base.tmpl_ids[off : off + size])
        forced_parts.append(base.forced[off : off + size])
        off += size
        ordered.extend(pods_k)
        tmpl_parts.append([enc.add_pod(p, (lambda p=p: _owner_selector(p)), hint=_tmpl_hint(p)) for p in pods_k])
        forced_parts.append([bool(p.spec.node_name) for p in pods_k])
        ds_group_sizes.append(size + len(pods_k))
    # the apps' region rides along unchanged (they have no DaemonSets here)
    ordered.extend(base.ordered[base.n_cluster :])
    tmpl_parts.append(base.tmpl_ids[base.n_cluster :])
    forced_parts.append(base.forced[base.n_cluster :])
    return _assemble_delta(
        base,
        enc,
        ordered=ordered,
        tmpl_parts=tmpl_parts,
        forced_parts=forced_parts,
        n_cluster=base.n_cluster + sum(len(g) for g in groups_new),
        ds_group_sizes=ds_group_sizes,
    )
