"""Campaign engine — a declarative cluster-lifecycle scenario DSL: the
port of ``opensim_tpu/planner/campaign.py``.

The reference's only lifecycle scenario is the interactive add-node
capacity loop (``pkg/apply/apply.go:203-259``). A *campaign* replays an
ordered list of typed lifecycle steps — PDB-aware drain waves, spot
reclaim storms, deploys/scales, autoscaler what-ifs, defrag plans —
against the prepared cluster, scoring every step with the capacity
observatory (``obs/capacity.py``).

Execution contract (``OPENSIM_CAMPAIGN_EXEC``):

- **warm** (default): ONE full ``prepare()`` for the whole campaign.
  Every later mutation is a prepcache delta — ``derive_with_app_slices``
  appends deployed pods onto the cached arenas, ``extend_with_nodes``
  splices added nodes (and their DaemonSet pods) in, drains/reclaims/
  deletes are mask flips. The scheduling carry between steps is rebuilt
  host-side from the recorded placements (``explain.replay_state``), so no
  kernel state needs to survive a delta re-encode.
- **cold**: every step re-prepares the materialized cluster from scratch
  (pods as bare pre-bound objects in campaign stream order). The
  verification mode: warm and cold give equal step fingerprints, which
  holds the delta path equal to a per-step full prepare.

Every scheduling pass is one launch of the one-scan kernel on the card
(``fastpath.schedule`` with the pass's pod mask, forced pods and node
mask, starting from the carried state; the plain version on the CPU),
and a step's scheduling set is processed in campaign stream order, so
placements — and the step fingerprints derived from them — are
mode-independent. Steps are identified by stable ids, never by pod names,
which carry a process counter.

Step types are declared in :data:`STEP_TYPES` via :func:`register_step`.
The ``from-journal`` step replays a generation range of the live twin's
journal (``server/journal.py``) through the campaign's own admission and
scan path.
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
import logging
import math
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Type

import numpy as np

from ..device import DeviceLike
from ..engine import reasons
from ..models import expand
from ..models.objects import (
    ANNO_WORKLOAD_KIND,
    ANNO_WORKLOAD_NAME,
    ANNO_WORKLOAD_NAMESPACE,
    LABEL_NEW_NODE,
    Node,
    Pod,
    PodDisruptionBudget,
    ResourceTypes,
    Workload,
)
from ..models.selectors import match_label_selector
from ..utils import envknobs, validate

log = logging.getLogger("opensim_tpu_torch.planner")

__all__ = [
    "CampaignError",
    "CampaignResult",
    "CampaignSpec",
    "STEP_TYPES",
    "StepReport",
    "load_campaign",
    "register_step",
    "run_campaign",
]


class CampaignError(ValueError):
    """Typed campaign-spec/execution error. ``step`` names the offending
    step (``"<index> (<name>)"``), ``field`` the offending spec field —
    the validation contract the spec tests pin down."""

    def __init__(self, message: str, step: Optional[str] = None, field: Optional[str] = None):
        self.step = step
        self.field = field
        prefix = f"step {step}: " if step is not None else ""
        body = f"{field}: {message}" if field else message
        super().__init__(prefix + body)


def exec_mode() -> str:
    """``OPENSIM_CAMPAIGN_EXEC``: ``warm`` (one full prepare + deltas) or
    ``cold`` (per-step full prepare — the verification mode)."""
    return str(envknobs.value("OPENSIM_CAMPAIGN_EXEC"))


def max_steps() -> int:
    return int(envknobs.value("OPENSIM_CAMPAIGN_MAX_STEPS"))


def max_waves() -> int:
    return int(envknobs.value("OPENSIM_CAMPAIGN_MAX_WAVES"))


# ---------------------------------------------------------------------------
# spec parsing: typed steps via the central registry
# ---------------------------------------------------------------------------

#: the central step registry: the ONLY place step types are declared;
#: dispatch anywhere else goes through this table
STEP_TYPES: Dict[str, Type["Step"]] = {}


def register_step(type_name: str):
    def deco(cls: Type["Step"]) -> Type["Step"]:
        cls.type_name = type_name
        STEP_TYPES[type_name] = cls
        return cls

    return deco


def _where(index: int, name: str) -> str:
    return f"{index} ({name})" if name else str(index)


class _Fields:
    """Strict per-step field reader: unknown keys are typed errors naming
    the step and field (a typo'd key must not silently no-op)."""

    def __init__(self, d: dict, where: str):
        self.d = dict(d)
        self.where = where
        self.d.pop("type", None)
        self.d.pop("name", None)

    def take(self, key: str, default=None):
        return self.d.pop(key, default)

    def done(self) -> None:
        if self.d:
            bad = sorted(self.d)[0]
            raise CampaignError(
                "unknown field (known fields are step-type specific; see docs/campaigns.md)",
                step=self.where,
                field=bad,
            )


@dataclass
class NodeSelection:
    """Shared node-targeting block: explicit ``nodes`` names, a label
    ``selector``, and an optional ``count``/``percent`` cap over the
    matched set (axis order, deterministic)."""

    nodes: List[str] = field(default_factory=list)
    selector: Optional[dict] = None
    count: Optional[int] = None
    percent: Optional[float] = None

    @classmethod
    def parse(cls, f: _Fields, require: bool = True) -> "NodeSelection":
        sel = cls(
            nodes=list(f.take("nodes") or []),
            selector=f.take("selector"),
            count=f.take("count"),
            percent=f.take("percent"),
        )
        if sel.selector is not None and not isinstance(sel.selector, dict):
            raise CampaignError("must be a label-selector mapping", step=f.where, field="selector")
        if sel.count is not None:
            try:
                sel.count = int(sel.count)
            except (TypeError, ValueError):
                raise CampaignError("must be an integer", step=f.where, field="count") from None
            if sel.count < 1:
                raise CampaignError("must be >= 1", step=f.where, field="count")
        if sel.percent is not None:
            try:
                sel.percent = float(sel.percent)
            except (TypeError, ValueError):
                raise CampaignError("must be a number", step=f.where, field="percent") from None
            if not 0.0 < sel.percent <= 100.0:
                raise CampaignError("must be in (0, 100]", step=f.where, field="percent")
        if require and not sel.nodes and sel.selector is None and sel.count is None and sel.percent is None:
            raise CampaignError(
                "needs a node selection ('nodes', 'selector', 'count' or 'percent')",
                step=f.where,
                field="nodes",
            )
        return sel

    def resolve(self, ex: "_Executor", where: str, sched_only: bool = True) -> List[int]:
        """State node indices, in axis order. Named nodes must exist and be
        alive (a typo'd node name is a typed error, not an empty drain)."""
        if self.nodes:
            out = []
            for name in self.nodes:
                si = ex.node_by_name.get(name)
                if si is None or not ex.node_alive[si]:
                    raise CampaignError(
                        f"unknown or already-removed node {name!r}", step=where, field="nodes"
                    )
                out.append(si)
        else:
            out = [
                si
                for si in range(len(ex.nodes))
                if ex.node_alive[si]
                and (not sched_only or ex.node_sched[si])
                and (
                    self.selector is None
                    or match_label_selector(self.selector, ex.nodes[si].metadata.labels)
                )
            ]
        cap = None
        if self.count is not None:
            cap = self.count
        if self.percent is not None:
            pct_cap = int(math.ceil(self.percent / 100.0 * len(out)))
            cap = pct_cap if cap is None else min(cap, pct_cap)
        return out[:cap] if cap is not None else out


class Step:
    """One typed campaign step. Subclasses are registered in
    :data:`STEP_TYPES` and implement ``parse`` + ``run``."""

    type_name = ""

    def __init__(self, index: int, name: str):
        self.index = index
        self.name = name or self.type_name
        self.where = _where(index, name)

    @classmethod
    def parse(cls, index: int, name: str, f: _Fields) -> "Step":
        raise NotImplementedError

    def run(self, ex: "_Executor", rep: "StepReport") -> None:
        raise NotImplementedError


def parse_steps(raw_steps: object) -> List[Step]:
    """``spec.steps`` → typed Step list. Every malformed shape is a
    :class:`CampaignError` naming the step and field. Step numbers are
    1-based and match the executed report's indices (the baseline scoring
    pass occupies index 0)."""
    if not isinstance(raw_steps, list) or not raw_steps:
        raise CampaignError("spec.steps must be a non-empty list", field="steps")
    if len(raw_steps) > max_steps():
        raise CampaignError(
            f"{len(raw_steps)} steps exceed OPENSIM_CAMPAIGN_MAX_STEPS={max_steps()}",
            field="steps",
        )
    steps: List[Step] = []
    for i, d in enumerate(raw_steps, start=1):
        if not isinstance(d, dict):
            raise CampaignError("step must be a mapping", step=str(i), field="steps")
        name = str(d.get("name") or "")
        where = _where(i, name)
        type_name = d.get("type")
        if not type_name:
            raise CampaignError("missing step type", step=where, field="type")
        cls = STEP_TYPES.get(str(type_name))
        if cls is None:
            raise CampaignError(
                f"unknown step type {type_name!r} (known: {', '.join(sorted(STEP_TYPES))})",
                step=where,
                field="type",
            )
        f = _Fields(d, where)
        step = cls.parse(i, name, f)
        f.done()
        steps.append(step)
    return steps


@dataclass
class CampaignSpec:
    """A parsed campaign file (``kind: Campaign``)."""

    name: str
    steps: List[Step]
    cluster: Dict[str, str] = field(default_factory=dict)  # customConfig | kubeConfig
    base_dir: str = ""


def load_campaign(path: str) -> CampaignSpec:
    import yaml

    try:
        with open(path) as fh:
            doc = yaml.safe_load(fh)
    except yaml.YAMLError as e:
        # CampaignError is a ValueError: CLI/REST surfaces render it as the
        # usual one-liner instead of a raw parser traceback
        raise CampaignError(f"{path}: invalid YAML: {e}") from e
    if not isinstance(doc, dict) or doc.get("kind") != "Campaign":
        raise CampaignError(f"{path}: not a simon Campaign document (kind: Campaign)")
    spec = doc.get("spec") or {}
    base_dir = os.path.dirname(os.path.abspath(path))
    prev = _BASE_DIR[0]
    _BASE_DIR[0] = base_dir
    try:
        steps = parse_steps(spec.get("steps"))
    finally:
        _BASE_DIR[0] = prev
    return CampaignSpec(
        name=(doc.get("metadata") or {}).get("name", "") or os.path.basename(path),
        steps=steps,
        cluster=dict(spec.get("cluster") or {}),
        base_dir=base_dir,
    )


#: base dir for relative paths inside step specs (set while parsing a file)
_BASE_DIR: List[str] = [""]

#: False while evaluating a campaign submitted over the REST API: a remote
#: caller must not make the SERVER dereference filesystem paths (the paths
#: are client-local anyway) — see :func:`remote_spec_context`
_ALLOW_PATHS: List[bool] = [True]


@contextlib.contextmanager
def remote_spec_context():
    """Evaluate a remotely-submitted campaign: any step field that names a
    filesystem path is rejected with a typed :class:`CampaignError`
    instead of being opened server-side (arbitrary-file-read hardening;
    REST campaigns inline their manifests)."""
    prev = _ALLOW_PATHS[0]
    _ALLOW_PATHS[0] = False
    try:
        yield
    finally:
        _ALLOW_PATHS[0] = prev


@validate.sanitizer
def _resolve_path(p: str) -> str:
    """The campaign planner's registered validator: every path
    a campaign YAML names passes through here — remote campaigns may not
    name server paths at all, control characters are rejected, and
    relative paths resolve against (and must stay under) the spec's
    directory. Rejections surface as :class:`CampaignError` so the
    CLI/REST surfaces keep the typed one-liner (400, not a generic 500)."""
    if not _ALLOW_PATHS[0]:
        raise CampaignError(
            "file paths are not allowed in campaigns submitted over the "
            "REST API (the server will not dereference them); inline the "
            "manifests instead",
            field="path",
        )
    try:
        return validate.child_path(_BASE_DIR[0], p, label="campaign path")
    except CampaignError:
        raise
    except ValueError as e:
        raise CampaignError(str(e), field="path") from e


# ---------------------------------------------------------------------------
# reports
# ---------------------------------------------------------------------------


@dataclass
class StepReport:
    """Everything one step did and what it cost — placements delta,
    disruption budgets consumed, and the capacity observatory's sample."""

    index: int
    name: str
    type: str
    evicted: int = 0
    deleted: int = 0
    rescheduled: int = 0
    pods_added: int = 0
    waves: int = 0
    unschedulable: List[dict] = field(default_factory=list)  # {pod, reason}
    blocked: List[dict] = field(default_factory=list)  # {pod, pdb, node}
    nodes_cordoned: List[str] = field(default_factory=list)
    nodes_drained: List[str] = field(default_factory=list)
    nodes_removed: List[str] = field(default_factory=list)
    nodes_added: List[str] = field(default_factory=list)
    pdb_spent: Dict[str, int] = field(default_factory=dict)
    pdb_allowed: Dict[str, int] = field(default_factory=dict)
    checks: List[dict] = field(default_factory=list)  # scale-down-check verdicts
    capacity: dict = field(default_factory=dict)
    headroom_fit: Dict[str, int] = field(default_factory=dict)
    headroom_recovered: Dict[str, int] = field(default_factory=dict)
    fragmentation_delta: Dict[str, float] = field(default_factory=dict)
    journal_events: int = 0
    fingerprint: str = ""

    def to_dict(self) -> dict:
        return {
            "index": self.index,
            "name": self.name,
            "type": self.type,
            "evicted": self.evicted,
            "deleted": self.deleted,
            "rescheduled": self.rescheduled,
            "podsAdded": self.pods_added,
            "waves": self.waves,
            "unschedulable": list(self.unschedulable),
            "blocked": list(self.blocked),
            "nodesCordoned": list(self.nodes_cordoned),
            "nodesDrained": list(self.nodes_drained),
            "nodesRemoved": list(self.nodes_removed),
            "nodesAdded": list(self.nodes_added),
            "pdbSpent": dict(sorted(self.pdb_spent.items())),
            "pdbAllowed": dict(sorted(self.pdb_allowed.items())),
            "checks": list(self.checks),
            "capacity": dict(self.capacity),
            "headroomFit": dict(sorted(self.headroom_fit.items())),
            "headroomRecovered": dict(sorted(self.headroom_recovered.items())),
            "fragmentationDelta": {k: round(v, 6) for k, v in sorted(self.fragmentation_delta.items())},
            "journalEvents": self.journal_events,
            "fingerprint": self.fingerprint,
        }


@dataclass
class CampaignResult:
    name: str
    mode: str
    steps: List[StepReport]
    fingerprint: str = ""
    full_prepares: int = 0

    def to_dict(self) -> dict:
        from . import report as report_mod

        steps = [s.to_dict() for s in self.steps]
        out = {
            "name": self.name,
            "mode": self.mode,
            "steps": steps,
            "fingerprint": self.fingerprint,
            "fullPrepares": self.full_prepares,
        }
        # the SAME rows the text renderer prints (byte-parity contract —
        # every report table in this repo goes through planner/report.py)
        rows = report_mod.campaign_step_rows(steps)
        out["table"] = {"header": rows[0], "rows": rows[1:]}
        return out


# ---------------------------------------------------------------------------
# the executor: campaign state + warm/cold scheduling
# ---------------------------------------------------------------------------


class _Executor:
    """Campaign state machine. The pod/node books are arrays parallel to
    the campaign stream (pods in admission order); scheduling runs over a
    ``Prepared`` whose stream mirrors the book — persistent and delta-
    extended in warm mode, rebuilt from the materialized state per step in
    cold mode — on `device` (the card unless the caller names another)."""

    def __init__(self, cluster: ResourceTypes, mode: str, device: DeviceLike = None):
        from ..device import resolve_device
        from ..engine.simulator import prepare

        if mode not in ("warm", "cold"):
            raise CampaignError(f"unknown execution mode {mode!r} (warm|cold)", field="mode")
        self.mode = mode
        self.cluster = cluster
        self.device = resolve_device(device)
        self.full_prepares = 0

        # -- node book (stable axis: rows never move; alive/sched flags flip)
        self.nodes: List[Node] = list(cluster.nodes)
        self.node_ids: List[str] = [n.metadata.name for n in self.nodes]
        self.node_by_name: Dict[str, int] = {n.metadata.name: i for i, n in enumerate(self.nodes)}
        self.node_alive = np.ones(len(self.nodes), dtype=bool)
        self.node_sched = np.ones(len(self.nodes), dtype=bool)

        # -- workload book (scale steps look templates up here)
        self.workloads: Dict[Tuple[str, str, str], Workload] = {}
        for w in (
            list(cluster.deployments)
            + list(cluster.replica_sets)
            + list(cluster.stateful_sets)
            + list(cluster.jobs)
        ):
            self.workloads[(w.kind, w.metadata.namespace or "default", w.metadata.name)] = w

        self.pdbs: List[PodDisruptionBudget] = [
            p for p in (self._as_pdb(obj) for obj in cluster.pdbs) if p is not None and p.selects()
        ]

        # -- the one full prepare of the campaign (warm mode keeps it; cold
        # mode re-prepares per step but starts from the same stream)
        prep = prepare(cluster, [], device=self.device)
        self.full_prepares += 1
        if prep is None and cluster.daemon_sets:
            raise CampaignError(
                "cluster expanded to no schedulable pods but carries DaemonSets; "
                "campaigns need at least one schedulable pod to anchor the stream"
            )
        if prep is None and self.mode == "warm":
            # a zero-pod cluster has no warm stream to keep: per-step
            # rebuilds are the only way to encode later admissions
            log.info("campaign cluster has no pods; warm mode degrades to cold rebuilds")
            self.mode = "cold"
        self.prep = prep

        # -- pod book, mirroring prep.ordered
        self.pods: List[Pod] = list(prep.ordered) if prep is not None else []
        P = len(self.pods)
        self.alive = np.ones(P, dtype=bool)
        self.assigned = np.full(P, -1, dtype=np.int32)
        self.forced = (
            np.array(prep.forced, dtype=bool, copy=True) if prep is not None else np.zeros(0, bool)
        )
        self.is_ds = (
            np.array([t >= 0 for t in prep.ds_target], dtype=bool)
            if prep is not None
            else np.zeros(0, bool)
        )
        gd = int(prep.ec_np.node_gpu_mem.shape[1]) if prep is not None else 0
        self.gpu_take = np.zeros((P, gd), dtype=np.float32)
        self.stable_ids: List[str] = []
        self._wl_ordinal: Dict[Tuple[str, str, str], int] = {}
        for p in self.pods:
            self.stable_ids.append(self._stable_id(p))

        # deterministic naming for campaign-added nodes: generated node
        # names differ per process run, so fingerprints use stable ids
        self._added_node_seq = 0
        self._prev_sample: Optional[dict] = None
        self._prev_headroom: Dict[str, int] = {}
        # per-pod facts that never change while a pod is in the book, kept
        # as arrays parallel to it (grown with it, dropped on a reorder):
        # each pod's (namespace, labels) as an integer key, which a PDB's
        # selector reads alone, and each pod's controller (namespace, uid)
        # as an integer key, -1 for a pod with none; per label key, whether
        # each PDB selects it (one pod of each key kept to ask)
        self._label_ids: Dict[Tuple[str, tuple], int] = {}
        self._label_pods: List[Pod] = []
        self._label_key = np.zeros(0, np.int64)
        self._pdb_match: Dict[int, np.ndarray] = {}
        self._owner_ids: Dict[Tuple[str, str], int] = {}
        self._owner_key = np.zeros(0, np.int64)

    # -- identity -----------------------------------------------------------

    @staticmethod
    def _as_pdb(obj) -> Optional[PodDisruptionBudget]:
        if isinstance(obj, PodDisruptionBudget):
            return obj
        raw = getattr(obj, "raw", None)
        if isinstance(raw, dict) and raw.get("kind") == "PodDisruptionBudget":
            return PodDisruptionBudget.from_dict(raw)
        if isinstance(obj, dict) and obj.get("kind") == "PodDisruptionBudget":
            return PodDisruptionBudget.from_dict(obj)
        return None

    @staticmethod
    def _canon_workload(name: str) -> str:
        """Expansion-generated intermediate workloads (a Deployment's
        ReplicaSet, a CronJob's Job) carry a 10-hex process-counter suffix
        that differs between runs — strip it so ids stay run-stable."""
        import re

        m = re.match(r"^(.+)-[0-9a-f]{10}$", name)
        return m.group(1) if m else name

    def _stable_id(self, pod: Pod) -> str:
        """Run-independent pod identity: expansion-generated names carry a
        process-global random suffix, so workload-owned pods are identified
        by (workload, ordinal) and DaemonSet pods by (workload, target
        node) instead of the generated name."""
        kind = pod.metadata.annotations.get(ANNO_WORKLOAD_KIND, "")
        wname = self._canon_workload(pod.metadata.annotations.get(ANNO_WORKLOAD_NAME, ""))
        ns = pod.metadata.annotations.get(ANNO_WORKLOAD_NAMESPACE, "") or pod.metadata.namespace
        if kind == "DaemonSet" and wname:
            from ..engine.simulator import pinned_node_name

            pin = pinned_node_name(pod) or pod.spec.node_name
            si = self.node_by_name.get(pin)
            node_id = self.node_ids[si] if si is not None else pin
            return f"{ns}/DaemonSet/{wname}@{node_id}"
        if kind and wname:
            key = (ns, kind, wname)
            ordinal = self._wl_ordinal.get(key, 0)
            self._wl_ordinal[key] = ordinal + 1
            return f"{ns}/{kind}/{wname}#{ordinal}"
        return f"{pod.metadata.namespace}/{pod.metadata.name}"

    def _node_stable_id(self, si: int) -> str:
        return self.node_ids[si]

    # -- pdb ledger ---------------------------------------------------------

    def _label_keys(self) -> np.ndarray:
        """[P] int64: each pod's (namespace, labels) key."""
        n0 = len(self._label_key)
        if n0 < len(self.pods):
            keys = []
            for p in self.pods[n0:]:
                k = (p.metadata.namespace, tuple(sorted((p.metadata.labels or {}).items())))
                if k not in self._label_ids:
                    self._label_ids[k] = len(self._label_pods)
                    self._label_pods.append(p)
                keys.append(self._label_ids[k])
            self._label_key = np.concatenate([self._label_key, np.asarray(keys, np.int64)])
        return self._label_key

    def _matches(self, pdb: PodDisruptionBudget) -> np.ndarray:
        """[P] bool: the book's pods `pdb` selects (alive or not)."""
        keys = self._label_keys()
        have = self._pdb_match.get(id(pdb), np.zeros(0, bool))
        if len(have) < len(self._label_pods):
            more = np.fromiter((pdb.matches(p) for p in self._label_pods[len(have):]), bool,
                               len(self._label_pods) - len(have))
            have = self._pdb_match[id(pdb)] = np.concatenate([have, more])
        return have[keys]

    def _owners(self) -> np.ndarray:
        """[P] int64: each pod's controller key, -1 for a pod with none."""
        n0 = len(self._owner_key)
        if n0 < len(self.pods):
            keys = []
            for p in self.pods[n0:]:
                ctrl = next((r.uid for r in p.metadata.owner_references if r.controller), None)
                keys.append(-1 if ctrl is None else
                            self._owner_ids.setdefault((p.metadata.namespace, ctrl), len(self._owner_ids)))
            self._owner_key = np.concatenate([self._owner_key, np.asarray(keys, np.int64)])
        return self._owner_key

    def pdb_budgets(self) -> List[dict]:
        """``disruptionsAllowed`` per PDB from the CURRENT campaign state —
        the disruption controller's arithmetic over the live book (healthy
        = alive matching pods currently placed; expected = the alive stream
        pods sharing the matching pods' controllers, plus matching bare
        pods). Recomputed per wave so budgets recover as displaced pods
        land again. ``matching`` is a [P] bool mask over the book."""
        out = []
        owner = self._owners()
        for pdb in self.pdbs:
            matching = self.alive & self._matches(pdb)
            healthy = int((matching & (self.assigned >= 0)).sum())
            expected = int((matching & (owner < 0)).sum())
            owners = np.unique(owner[matching & (owner >= 0)])
            if len(owners):
                expected += int((self.alive & np.isin(owner, owners)).sum())
            out.append(
                {
                    "pdb": pdb,
                    "key": pdb.key(),
                    "allowed": pdb.disruptions_allowed(healthy, expected),
                    "matching": matching,
                }
            )
        return out

    def try_evict(self, idxs: List[int], rep: StepReport, respect_pdbs: bool = True) -> Tuple[List[int], List[int]]:
        """Attempt evictions in stream order against the current budgets.
        Returns ``(evicted, blocked)`` — blocked evictions are NEVER
        dropped: the caller carries them into the next wave and any
        still-blocked remainder lands loudly in ``rep.blocked``."""
        budgets = self.pdb_budgets() if respect_pdbs else []
        evicted: List[int] = []
        blocked: List[int] = []
        for i in sorted(set(idxs)):
            holds = [b for b in budgets if b["matching"][i]]
            if any(b["allowed"] <= 0 for b in holds):
                blocked.append(i)
                continue
            for b in holds:
                b["allowed"] -= 1
                rep.pdb_spent[b["key"]] = rep.pdb_spent.get(b["key"], 0) + 1
            self.displace(i)
            evicted.append(i)
        rep.evicted += len(evicted)
        return evicted, blocked

    # -- state mutations ----------------------------------------------------

    def _ensure_gpu_width(self, width: int) -> None:
        """Grow the gpu-take book when a prep's per-node GPU dim exceeds it
        (an add-nodes step introducing wider GPU nodes) — truncating takes
        would replay those devices as free."""
        if width > self.gpu_take.shape[1]:
            pad = np.zeros((self.gpu_take.shape[0], width - self.gpu_take.shape[1]), np.float32)
            self.gpu_take = np.concatenate([self.gpu_take, pad], axis=1)

    def displace(self, i: int) -> None:
        """Unbind a pod (eviction/node loss): it re-enters the pending set
        and schedules normally on the next scan (the template's old node
        pin no longer forces it — the defrag mask semantics)."""
        self.assigned[i] = -1
        self.forced[i] = False
        if self.gpu_take.shape[1]:
            self.gpu_take[i, :] = 0.0

    def delete_pod(self, i: int) -> None:
        self.alive[i] = False
        self.assigned[i] = -1
        if self.gpu_take.shape[1]:
            self.gpu_take[i, :] = 0.0

    def bound_on(self, si: int, include_ds: bool = False) -> List[int]:
        on = self.alive & (self.assigned == si)
        return np.nonzero(on if include_ds else on & ~self.is_ds)[0].tolist()

    # -- prep maintenance (the warm-delta / cold-rebuild split) -------------

    def _nodes_view(self) -> ResourceTypes:
        rt = ResourceTypes()
        rt.nodes = [n for i, n in enumerate(self.nodes) if self.node_alive[i]]
        return rt

    def _grow_books(self, new_pods: List[Pod], forced: List[bool], is_ds: bool = False) -> List[int]:
        lo = len(self.pods)
        n = len(new_pods)
        if not n:
            return []
        for p in new_pods:
            self.pods.append(p)
            self.stable_ids.append(self._stable_id(p))
        self.alive = np.concatenate([self.alive, np.ones(n, bool)])
        self.assigned = np.concatenate([self.assigned, np.full(n, -1, np.int32)])
        self.forced = np.concatenate([self.forced, np.array(forced, bool)])
        self.is_ds = np.concatenate([self.is_ds, np.full(n, is_ds, bool)])
        self.gpu_take = np.concatenate(
            [self.gpu_take, np.zeros((n, self.gpu_take.shape[1]), np.float32)]
        )
        return list(range(lo, len(self.pods)))

    def admit_app(self, name: str, rt: ResourceTypes, where: str) -> List[int]:
        """Append an app's expanded pods to the campaign stream — the
        deploy/scale-up/from-journal admission path. Warm mode delta
        re-encodes onto the cached arenas (``derive_with_app_slices``);
        cold mode runs the same expansion pipeline and lets the next
        rebuild encode them. Returns the new book indices."""
        from ..engine import prepcache
        from ..engine.simulator import AppResource

        if rt.daemon_sets:
            raise CampaignError(
                "app DaemonSets are not supported in campaign steps (the node-delta "
                "splice cannot reproduce their expansion order); model DaemonSets in "
                "the base cluster instead",
                step=where,
                field="app",
            )
        # deployed workloads join the scale-step lookup book, so a later
        # `scale` step can grow an app this campaign introduced
        for w in (
            list(rt.deployments) + list(rt.replica_sets)
            + list(rt.stateful_sets) + list(rt.jobs)
        ):
            self.workloads[(w.kind, w.metadata.namespace or "default", w.metadata.name)] = w
        app = AppResource(name, rt)
        if self.mode == "warm":
            got = prepcache.derive_with_app_slices(self.prep, self._nodes_view(), [app])
            if got is None:
                return []
            new_prep, slices = got
            lo, hi = slices[0]
            new_pods = list(new_prep.ordered[lo:hi])
            self.prep = new_prep
        else:
            new_pods = prepcache._expand_app(self._nodes_view(), app, use_greed=False)
        return self._grow_books(new_pods, [bool(p.spec.node_name) for p in new_pods])

    def add_nodes(self, new_nodes: List[Node], rep: StepReport, where: str) -> None:
        """Extend the node axis (autoscaler add / journal node ADDED) and
        run the new nodes' DaemonSet pods through their own scan first (a
        deterministic order both modes share: DS-major, node-minor)."""
        from ..engine import prepcache

        for n in new_nodes:
            if n.metadata.name in self.node_by_name:
                raise CampaignError(
                    f"node {n.metadata.name!r} already exists", step=where, field="nodes"
                )
        base = len(self.nodes)
        for k, n in enumerate(new_nodes):
            self.nodes.append(n)
            sid = n.metadata.name
            if n.metadata.labels.get(LABEL_NEW_NODE) is not None:
                # generated fake-node names differ per run: stable id by
                # admission ordinal instead
                sid = f"added#{self._added_node_seq}"
                self._added_node_seq += 1
            self.node_ids.append(sid)
            self.node_by_name[n.metadata.name] = base + k
            self.node_alive = np.append(self.node_alive, True)
            self.node_sched = np.append(self.node_sched, True)
            rep.nodes_added.append(sid)

        ds_idxs: List[int] = []
        if self.mode == "warm" and self.prep is not None:
            old_ids = {id(p): i for i, p in enumerate(self.prep.ordered)}
            new_prep = prepcache.extend_with_nodes(
                self.prep, new_nodes, self.cluster, [], use_greed=False
            )
            if new_prep is None:
                raise CampaignError(
                    "node delta declined (cluster DaemonSet set changed mid-campaign)",
                    step=where,
                    field="count",
                )
            # the splice reorders the stream: rebuild the books in the new
            # prep order, carrying each existing pod's row by identity
            order = []
            spliced_new: List[Pod] = []
            for p in new_prep.ordered:
                oi = old_ids.get(id(p))
                if oi is None:
                    spliced_new.append(p)
                    order.append(-1)
                else:
                    order.append(oi)
            self.prep = new_prep
            self._reorder_books(order, spliced_new, new_prep)
            ds_idxs = [i for i, o in enumerate(order) if o == -1]
        else:
            # cold: expand the new nodes' DS pods in the SAME order the warm
            # splice produces them (cluster.daemon_sets-major, node-minor)
            for ds in self.cluster.daemon_sets:
                pods_k = expand.pods_from_daemon_set(ds, new_nodes)
                ds_idxs.extend(self._grow_books(pods_k, [False] * len(pods_k), is_ds=True))
        if ds_idxs:
            self.run_scan(ds_idxs, rep, count_as="rescheduled")

    def _reorder_books(self, order: List[int], spliced_new: List[Pod], new_prep) -> None:
        """Re-index every book array to the new prep order (``order[j]`` =
        old index or -1 for a spliced-in DaemonSet pod)."""
        order_a = np.asarray(order, dtype=np.int64)
        old = order_a >= 0
        src = order_a[old]
        P = len(order_a)
        alive = np.ones(P, bool)
        assigned = np.full(P, -1, np.int32)
        forced = np.zeros(P, bool)
        is_ds = np.ones(P, bool)  # a spliced-in pod is a DaemonSet pod
        alive[old], assigned[old] = self.alive[src], self.assigned[src]
        forced[old], is_ds[old] = self.forced[src], self.is_ds[src]
        gd = int(new_prep.ec_np.node_gpu_mem.shape[1])
        gpu = np.zeros((P, gd), np.float32)
        w = min(gd, self.gpu_take.shape[1])
        if w:
            gpu[old, :w] = self.gpu_take[src, :w]
        it_new = iter(spliced_new)
        pods = [self.pods[oi] if oi >= 0 else next(it_new) for oi in order]
        ids = [self.stable_ids[oi] if oi >= 0 else self._stable_id(p) for oi, p in zip(order, pods)]
        self.pods, self.stable_ids = pods, ids
        self.alive, self.assigned, self.forced, self.is_ds, self.gpu_take = (
            alive, assigned, forced, is_ds, gpu,
        )
        # the per-pod facts follow the old order
        self._label_key = np.zeros(0, np.int64)
        self._owner_key = np.zeros(0, np.int64)

    def _materialize(self) -> Tuple[ResourceTypes, List[int], Dict[int, int]]:
        """The current campaign state as plain cluster objects: alive nodes
        in axis order, alive pods as bare (pre-bound where placed) pods in
        stream order. Also returns the state→materialized index maps."""
        rt = ResourceTypes()
        node_pos: Dict[int, int] = {}
        for si, n in enumerate(self.nodes):
            if self.node_alive[si]:
                node_pos[si] = len(rt.nodes)
                rt.nodes.append(n)
        pod_rows: List[int] = []
        for i, p in enumerate(self.pods):
            if not self.alive[i]:
                continue
            q = copy.copy(p)
            q.spec = copy.copy(p.spec)
            a = int(self.assigned[i])
            if a >= 0:
                q.spec.node_name = self.nodes[a].metadata.name
                q.phase = "Running"
            elif self.forced[i]:
                q.phase = "Pending"  # keep the spec pin: the bind is still owed
            else:
                q.spec.node_name = ""
                q.phase = "Pending"
            rt.pods.append(q)
            pod_rows.append(i)
        rt.pdbs = list(self.pdbs)
        return rt, pod_rows, node_pos

    def _rebuild_prep(self) -> Tuple[List[int], Dict[int, int]]:
        """Cold-mode prep: one full prepare of the materialized state.
        Returns the state-index list in prep order and the node map."""
        from ..engine.simulator import prepare

        rt, pod_rows, node_pos = self._materialize()
        prep = prepare(rt, [], device=self.device)
        self.full_prepares += 1
        self.prep = prep
        self._cold_rows = pod_rows
        self._cold_node_pos = node_pos
        return pod_rows, node_pos

    # -- the scan: one engine pass over the to-schedule set -----------------

    def run_scan(self, idxs: List[int], rep: StepReport, count_as: str = "rescheduled") -> None:
        """Schedule the given book indices (plus nothing else) against the
        current carry, in campaign stream order, and commit the placements.
        The carry is rebuilt host-side from the book (``replay_state``), so
        warm deltas and cold rebuilds see byte-identical initial state."""
        idxs = [i for i in sorted(set(idxs)) if self.alive[i] and self.assigned[i] < 0]
        if not idxs or self.prep is None and self.mode == "warm":
            self._report_pending(rep, idxs)
            return

        if self.mode == "cold":
            rows, node_pos = self._rebuild_prep()
        else:
            rows = list(range(len(self.pods)))
            node_pos = {si: si for si in range(len(self.nodes))}
        prep = self.prep
        if prep is None:
            self._report_pending(rep, idxs)
            return
        pos_of = {bi: j for j, bi in enumerate(rows)}

        P = len(prep.ordered)
        pod_valid = np.zeros(P, dtype=bool)
        forced_vec = np.zeros(P, dtype=bool)
        scan_set = [i for i in idxs if i in pos_of]
        for i in scan_set:
            pod_valid[pos_of[i]] = True
            forced_vec[pos_of[i]] = bool(self.forced[i])

        nv = np.array(np.asarray(prep.ec_np.node_valid), dtype=bool, copy=True)
        n_real = prep.meta.n_real_nodes
        for si in range(len(self.nodes)):
            pj = node_pos.get(si)
            if pj is not None and pj < n_real:
                nv[pj] = bool(self.node_alive[si] and self.node_sched[si])

        st0 = self._carry_state(prep, rows, pos_of)
        out = self._run_engine(prep, pod_valid, forced_vec, nv, st0)

        chosen = np.asarray(out.chosen)[:P]
        gpu = np.asarray(out.gpu_take)[:P]
        self._ensure_gpu_width(gpu.shape[1])
        inv_node = {pj: si for si, pj in node_pos.items()}
        placed = 0
        for i in scan_set:
            j = pos_of[i]
            c = int(chosen[j])
            if c >= 0:
                self.assigned[i] = inv_node.get(c, c)
                w = min(self.gpu_take.shape[1], gpu.shape[1])
                if w:
                    self.gpu_take[i, :w] = gpu[j, :w]
                placed += 1
        if count_as == "rescheduled":
            rep.rescheduled += placed
        self._report_pending(rep, scan_set, out=out, pos_of=pos_of, nv=nv)

    def _carry_state(self, prep, rows: List[int], pos_of: Dict[int, int]):
        from ..engine.explain import replay_state

        P = len(prep.ordered)
        gd = int(prep.ec_np.node_gpu_mem.shape[1])
        rows_a = np.asarray(rows, dtype=np.int64)
        a = self.assigned[rows_a].astype(np.int64)
        placed = self.alive[rows_a] & (a >= 0)
        if self.mode == "cold":
            # campaign node -> materialized node (-1: not materialized)
            pos = np.full(len(self.nodes), -1, np.int64)
            for si, pj in self._cold_node_pos.items():
                pos[si] = pj
            a = np.where(placed, pos[np.maximum(a, 0)], -1)
        chosen = np.full(P, -1, dtype=np.int32)
        chosen[: len(rows_a)] = np.where(placed, a, -1)
        gpu = np.zeros((P, gd), np.float32)
        w = min(gd, self.gpu_take.shape[1])
        if w:
            gpu[: len(rows_a)][placed, :w] = self.gpu_take[rows_a[placed], :w]
        return replay_state(prep, chosen, gpu, upto=P)

    def _run_engine(self, prep, pod_valid, forced_vec, nv, st0):
        """One launch of the one-scan kernel over the prepared stream with
        this pass's pod, forced and node masks, from the carried state (the
        cfg variant under the default config, the variant that takes an
        initial state; the plain version on the CPU). Nothing falls back to
        another engine."""
        from ..engine import fastpath

        miss = fastpath.why_not(prep)
        if miss is not None:
            raise NotImplementedError(f"outside the port's bind-scan envelope: {miss}")
        built = fastpath.build_inputs(prep, node_valid=nv, segment=True)
        return fastpath.schedule(prep, [(built, 0, len(prep.tmpl_ids))], pod_valid, forced=forced_vec, init=st0)

    def _report_pending(self, rep: StepReport, scan_set: List[int], out=None, pos_of=None, nv=None) -> None:
        """Record every scanned-but-unplaced pod with its engine-attributed
        reason (the ``engine/explain`` failure rows) in the step report."""
        n_nodes = int(nv.sum()) if nv is not None else int(self.node_alive.sum())
        for i in scan_set:
            if self.assigned[i] >= 0 or not self.alive[i]:
                continue
            pod = self.pods[i]
            if self.forced[i]:
                reason = reasons.node_not_found(pod.spec.node_name)
            elif out is not None and pos_of is not None and i in pos_of:
                j = pos_of[i]
                # the port's static rows are per pod already (its template's
                # row over the launch's valid nodes): indexed by stream
                # position, not by template id
                counts = reasons.counts_from_rows(
                    out.static_fail[j],
                    out.fail_counts[j],
                    out.insufficient[j],
                    self.prep.meta.resource_names,
                )
                reason = reasons.render_unschedulable(n_nodes, counts)
            else:
                reason = reasons.render_unschedulable(n_nodes, [])
            rep.unschedulable.append({"pod": self.stable_ids[i], "reason": reason})

    def pending_idxs(self) -> List[int]:
        return np.nonzero(self.alive & (self.assigned < 0) & ~self.is_ds)[0].tolist()

    # -- scoring ------------------------------------------------------------

    def score(self, rep: StepReport) -> None:
        """Per-step capacity sample + resource-fit headroom through the
        capacity observatory (``obs/capacity.py``) — utilization, spread,
        fragmentation and headroom deltas are measured quantities, not
        estimates."""
        from ..obs.capacity import CapacityEngine, headroom_profiles

        eng = CapacityEngine(topk=0)
        view, _, _ = self._materialize()
        eng.bootstrap(view, generation=rep.index)
        sample = eng.sample()
        cap = sample.to_dict() if sample is not None else {}
        cap.pop("ts", None)
        cap.pop("hottest", None)
        cap.pop("headroom", None)
        rep.capacity = cap
        rep.headroom_fit = {p.name: eng.fit_upper_bound(p) for p in headroom_profiles()}
        if self._prev_headroom:
            rep.headroom_recovered = {
                k: v - self._prev_headroom.get(k, 0) for k, v in rep.headroom_fit.items()
            }
        if self._prev_sample:
            prev_frag = self._prev_sample.get("fragmentation") or {}
            rep.fragmentation_delta = {
                k: v - prev_frag.get(k, 0.0)
                for k, v in (cap.get("fragmentation") or {}).items()
            }
        for b in self.pdb_budgets():
            rep.pdb_allowed[b["key"]] = b["allowed"]
        self._prev_sample = cap
        self._prev_headroom = dict(rep.headroom_fit)
        rep.fingerprint = self.fingerprint()

    def fingerprint(self) -> str:
        """Bit-stable digest of the campaign state: placements by stable
        pod id onto stable node ids, plus node liveness. Sorted, so warm
        splices and cold appends hash identically."""
        lines = []
        for i in range(len(self.pods)):
            if not self.alive[i]:
                continue
            a = int(self.assigned[i])
            where = self._node_stable_id(a) if a >= 0 else "<pending>"
            lines.append(f"p|{self.stable_ids[i]}|{where}")
        for si in range(len(self.nodes)):
            lines.append(
                f"n|{self.node_ids[si]}|{int(self.node_alive[si])}{int(self.node_sched[si])}"
            )
        h = hashlib.blake2b(digest_size=16)
        for line in sorted(lines):
            h.update(line.encode())
            h.update(b"\n")
        return h.hexdigest()

    # -- what-if: is node si removable from the current state? --------------

    def check_node_removable(self, si: int) -> dict:
        """Scale-down safety check (autoscaler what-if): evict node ``si``'s
        non-DaemonSet pods against a copy of the current carry and see
        whether every one reschedules — without committing anything."""
        bound = self.bound_on(si)
        budgets = self.pdb_budgets()
        pdb_blocked = 0
        for i in bound:
            holds = [b for b in budgets if b["matching"][i]]
            if any(b["allowed"] <= 0 for b in holds):
                pdb_blocked += 1
            else:
                for b in holds:
                    b["allowed"] -= 1
        unschedulable = 0
        if bound:
            saved = (
                self.assigned.copy(), self.forced.copy(), self.gpu_take.copy(),
                self.node_sched.copy(), self.node_alive.copy(),
            )
            try:
                for i in bound:
                    self.displace(i)
                self.node_sched[si] = False
                self.node_alive[si] = False
                probe = StepReport(index=-1, name="check", type="check")
                self.run_scan(bound, probe)
                unschedulable = sum(1 for i in bound if self.assigned[i] < 0)
            finally:
                (self.assigned, self.forced, self.gpu_take,
                 self.node_sched, self.node_alive) = saved
        node = self.nodes[si]
        return {
            "node": self._node_stable_id(si),
            "pods": len(bound),
            "fits": unschedulable == 0,
            "pdbBlocked": pdb_blocked,
            "unschedulable": unschedulable,
            "removable": unschedulable == 0 and pdb_blocked == 0,
            "freedCpu": float(node.allocatable.get("cpu", 0.0)),
            "freedMemory": float(node.allocatable.get("memory", 0.0)),
        }

    # -- drain machinery (shared by drain-wave and defrag) ------------------

    def drain(
        self,
        targets: List[int],
        wave_size: int,
        rep: StepReport,
        respect_pdbs: bool = True,
    ) -> None:
        """Rolling drain: cordon a wave, evict within budgets, reschedule
        the displaced pods, carry blocked evictions into the next wave.
        After the last wave, blocked evictions retry in extra passes until
        they drain or stop making progress (bounded by
        ``OPENSIM_CAMPAIGN_MAX_WAVES``); any remainder is reported loudly
        and its nodes stay cordoned — never silently dropped."""
        waves = [targets[k : k + wave_size] for k in range(0, len(targets), wave_size)]
        if len(waves) > max_waves():
            # refuse up front rather than silently abandoning the tail of
            # the target list mid-step: the bound is a spec-size guard
            raise CampaignError(
                f"{len(waves)} waves exceed OPENSIM_CAMPAIGN_MAX_WAVES="
                f"{max_waves()} (raise the knob or widen the wave size)",
                step=_where(rep.index, rep.name),
                field="wave",
            )
        blocked_carry: List[int] = []
        cordoned: set = set()
        passes = 0
        wave_iter = list(waves)
        while wave_iter or blocked_carry:
            passes += 1
            if passes > max_waves():
                break  # blocked-retry backstop; the carry is reported below
            wave = wave_iter.pop(0) if wave_iter else []
            for si in wave:
                self.node_sched[si] = False
                cordoned.add(si)
                rep.nodes_cordoned.append(self._node_stable_id(si))
            to_evict = list(blocked_carry)
            for si in wave:
                to_evict.extend(self.bound_on(si))
            if not to_evict and not wave:
                break
            before_blocked = len(blocked_carry)
            evicted, blocked_carry = self.try_evict(to_evict, rep, respect_pdbs=respect_pdbs)
            rep.waves += 1
            self.run_scan(evicted + self.pending_idxs(), rep)
            if not wave_iter and blocked_carry and not evicted and len(blocked_carry) >= before_blocked:
                break  # no progress: stop retrying, report below
        # finalize: empty cordoned targets are drained and leave the
        # cluster; nodes still holding blocked pods stay cordoned
        budgets = self.pdb_budgets()
        for i in blocked_carry:
            holds = [b["key"] for b in budgets if b["matching"][i] and b["allowed"] <= 0]
            a = int(self.assigned[i])
            rep.blocked.append(
                {
                    "pod": self.stable_ids[i],
                    "pdb": ",".join(sorted(holds)) or "?",
                    "node": self._node_stable_id(a) if a >= 0 else "<pending>",
                }
            )
        for si in targets:
            if si not in cordoned:
                continue  # never reached (retry backstop): stays untouched
            if not self.bound_on(si):
                # DaemonSet pods die with the node (kube drain ignores
                # them; the upgrade takes the node away underneath)
                for i in np.nonzero(self.alive & self.is_ds & (self.assigned == si))[0].tolist():
                    self.delete_pod(i)
                    rep.deleted += 1
                self.node_alive[si] = False
                rep.nodes_drained.append(self._node_stable_id(si))


# ---------------------------------------------------------------------------
# step implementations
# ---------------------------------------------------------------------------


@register_step("drain-wave")
class DrainWaveStep(Step):
    """Rolling node drain/upgrade: cordon + PDB-respecting eviction +
    reschedule of the displaced pods, ``wave`` nodes at a time."""

    def __init__(self, index, name, selection, wave, wave_percent, respect_pdbs):
        super().__init__(index, name)
        self.selection = selection
        self.wave = wave
        self.wave_percent = wave_percent
        self.respect_pdbs = respect_pdbs

    @classmethod
    def parse(cls, index, name, f):
        where = f.where
        selection = NodeSelection.parse(f)
        wave = f.take("wave")
        wave_percent = f.take("wavePercent")
        if wave is not None:
            try:
                wave = int(wave)
            except (TypeError, ValueError):
                raise CampaignError("must be an integer", step=where, field="wave") from None
            if wave < 1:
                raise CampaignError("must be >= 1", step=where, field="wave")
        if wave_percent is not None:
            try:
                wave_percent = float(wave_percent)
            except (TypeError, ValueError):
                raise CampaignError("must be a number", step=where, field="wavePercent") from None
            if not 0.0 < wave_percent <= 100.0:
                raise CampaignError("must be in (0, 100]", step=where, field="wavePercent")
        respect = f.take("respectPdbs", True)
        if not isinstance(respect, bool):
            raise CampaignError("must be true or false", step=where, field="respectPdbs")
        return cls(index, name, selection, wave, wave_percent, respect)

    def run(self, ex, rep):
        targets = self.selection.resolve(ex, self.where)
        if not targets:
            return
        size = self.wave or 0
        if self.wave_percent is not None:
            size = max(size, int(math.ceil(self.wave_percent / 100.0 * len(targets))))
        ex.drain(targets, size or len(targets), rep, respect_pdbs=self.respect_pdbs)


@register_step("reclaim-storm")
class ReclaimStormStep(Step):
    """Spot/preemptible reclaim: the selected nodes vanish AT ONCE (the
    ``pkg/simulator`` delete-path inverse) — no cordon, no PDB protection
    (budgets don't guard against node failure), displaced pods reschedule
    in one pass."""

    def __init__(self, index, name, selection):
        super().__init__(index, name)
        self.selection = selection

    @classmethod
    def parse(cls, index, name, f):
        return cls(index, name, NodeSelection.parse(f))

    def run(self, ex, rep):
        targets = self.selection.resolve(ex, self.where, sched_only=False)
        displaced: List[int] = []
        for si in targets:
            for i in ex.bound_on(si, include_ds=True):
                if ex.is_ds[i]:
                    ex.delete_pod(i)  # DaemonSet pods die with their node
                    rep.deleted += 1
                else:
                    ex.displace(i)
                    displaced.append(i)
                    rep.evicted += 1
            ex.node_sched[si] = False
            ex.node_alive[si] = False
            rep.nodes_removed.append(ex._node_stable_id(si))
        ex.run_scan(displaced + ex.pending_idxs(), rep)


@register_step("deploy")
class DeployStep(Step):
    """Deploy an app (yaml dir / chart / inline manifests) onto the current
    state — the ``simon apply`` admission pipeline as one campaign step."""

    def __init__(self, index, name, app_name, path, chart, resources):
        super().__init__(index, name)
        self.app_name = app_name
        self.path = path
        self.chart = chart
        self.resources = resources

    @classmethod
    def parse(cls, index, name, f):
        where = f.where
        app = f.take("app")
        resources = f.take("resources")
        if app is not None and not isinstance(app, dict):
            raise CampaignError("must be a mapping {name, path[, chart]}", step=where, field="app")
        if app is None and resources is None:
            raise CampaignError("needs 'app' (name+path) or inline 'resources'", step=where, field="app")
        if resources is not None and not isinstance(resources, list):
            raise CampaignError("must be a list of manifests", step=where, field="resources")
        app = app or {}
        app_name = str(app.get("name") or name or f"deploy-{index}")
        path = app.get("path", "")
        if app and not path and resources is None:
            raise CampaignError("app needs a 'path'", step=where, field="app.path")
        return cls(index, name, app_name, path, bool(app.get("chart")), resources)

    def _load(self) -> ResourceTypes:
        if self.resources is not None:
            rt, _ = expand.resources_from_dicts(list(self.resources))
            return rt
        path = _resolve_path(self.path)
        if self.chart:
            from ..chart.render import process_chart

            docs = expand.decode_yaml_strings(process_chart(self.app_name, path))
        else:
            docs = expand.load_yaml_objects(path)
        rt, _ = expand.resources_from_dicts(docs)
        return rt

    def run(self, ex, rep):
        rt = self._load()
        for pdb in list(rt.pdbs):
            p = ex._as_pdb(pdb)
            if p is not None and p.selects():
                ex.pdbs.append(p)
        new = ex.admit_app(self.app_name, rt, self.where)
        rep.pods_added += len(new)
        ex.run_scan(new + ex.pending_idxs(), rep)


@register_step("scale")
class ScaleStep(Step):
    """Scale an existing workload to N replicas: scale-down deletes the
    trailing expansion pods (a voluntary delete, not an eviction — PDBs
    gate evictions, not ``kubectl scale``); scale-up expands new replicas
    from the workload's template and schedules them."""

    def __init__(self, index, name, kind, namespace, wl_name, replicas):
        super().__init__(index, name)
        self.kind = kind
        self.namespace = namespace
        self.wl_name = wl_name
        self.replicas = replicas

    @classmethod
    def parse(cls, index, name, f):
        where = f.where
        wl = f.take("workload")
        if not isinstance(wl, dict) or not wl.get("name"):
            raise CampaignError(
                "needs workload: {kind, name[, namespace]}", step=where, field="workload"
            )
        replicas = f.take("replicas")
        try:
            replicas = int(replicas)
        except (TypeError, ValueError):
            raise CampaignError("must be an integer", step=where, field="replicas") from None
        if replicas < 0:
            raise CampaignError("must be >= 0", step=where, field="replicas")
        return cls(
            index, name,
            str(wl.get("kind") or "Deployment"),
            str(wl.get("namespace") or "default"),
            str(wl["name"]),
            replicas,
        )

    #: expansion inserts intermediate owners (Deployment → generated
    #: ReplicaSet, CronJob → Job); a scale target owns those pods too
    _OWNED_KINDS = {
        "Deployment": ("Deployment", "ReplicaSet"),
        "CronJob": ("CronJob", "Job"),
    }

    def _owned(self, ex) -> List[int]:
        kinds = self._OWNED_KINDS.get(self.kind, (self.kind,))
        out = []
        for i in range(len(ex.pods)):
            if not ex.alive[i]:
                continue
            p = ex.pods[i]
            if (
                p.metadata.annotations.get(ANNO_WORKLOAD_KIND) in kinds
                and ex._canon_workload(p.metadata.annotations.get(ANNO_WORKLOAD_NAME, ""))
                == self.wl_name
                and (p.metadata.annotations.get(ANNO_WORKLOAD_NAMESPACE) or p.metadata.namespace)
                == self.namespace
            ):
                out.append(i)
        return out

    def run(self, ex, rep):
        owned = self._owned(ex)
        cur = len(owned)
        if self.replicas < cur:
            for i in owned[self.replicas :]:
                ex.delete_pod(i)
                rep.deleted += 1
            ex.run_scan(ex.pending_idxs(), rep)
            return
        if self.replicas == cur:
            return
        wl = ex.workloads.get((self.kind, self.namespace, self.wl_name))
        if wl is None:
            raise CampaignError(
                f"no {self.kind} {self.namespace}/{self.wl_name} in the cluster or "
                "deployed earlier in this campaign",
                step=self.where,
                field="workload",
            )
        clone = copy.copy(wl)
        clone.replicas = self.replicas - cur
        rt = ResourceTypes()
        rt.add(clone)
        new = ex.admit_app(self.wl_name, rt, self.where)
        rep.pods_added += len(new)
        ex.run_scan(new + ex.pending_idxs(), rep)


@register_step("add-nodes")
class AddNodesStep(Step):
    """Autoscaler add: clone ``count`` nodes from a template (a yaml dir
    like ``spec.newNode``, or an existing node by name) into the cluster;
    their DaemonSet pods land immediately and pending pods retry."""

    def __init__(self, index, name, count, path, clone_of):
        super().__init__(index, name)
        self.count = count
        self.path = path
        self.clone_of = clone_of

    @classmethod
    def parse(cls, index, name, f):
        where = f.where
        count = f.take("count", 1)
        try:
            count = int(count)
        except (TypeError, ValueError):
            raise CampaignError("must be an integer", step=where, field="count") from None
        if count < 1:
            raise CampaignError("must be >= 1", step=where, field="count")
        template = f.take("template")
        if not isinstance(template, dict) or not (template.get("path") or template.get("node")):
            raise CampaignError(
                "needs template: {path: <newNode yaml dir>} or {node: <existing node name>}",
                step=where,
                field="template",
            )
        return cls(index, name, count, template.get("path", ""), template.get("node", ""))

    def run(self, ex, rep):
        if self.path:
            rt = expand.load_cluster_from_dir(_resolve_path(self.path))
            if not rt.nodes:
                raise CampaignError(
                    f"no Node manifest under {self.path!r}", step=self.where, field="template.path"
                )
            template = rt.nodes[0]
        else:
            si = ex.node_by_name.get(self.clone_of)
            if si is None:
                raise CampaignError(
                    f"unknown template node {self.clone_of!r}", step=self.where, field="template.node"
                )
            template = ex.nodes[si]
        new_nodes = expand.new_fake_nodes(template, self.count)
        ex.add_nodes(new_nodes, rep, self.where)
        ex.run_scan(ex.pending_idxs(), rep)


@register_step("scale-down-check")
class ScaleDownCheckStep(Step):
    """Autoscaler what-if: for each candidate node, is it removable without
    creating unschedulable pods or breaking a disruption budget? Pure
    analysis — the state is untouched."""

    def __init__(self, index, name, selection):
        super().__init__(index, name)
        self.selection = selection

    @classmethod
    def parse(cls, index, name, f):
        return cls(index, name, NodeSelection.parse(f, require=False))

    def run(self, ex, rep):
        targets = self.selection.resolve(ex, self.where)
        for si in targets:
            rep.checks.append(ex.check_node_removable(si))


@register_step("defrag")
class DefragStep(Step):
    """``planner/defrag.plan_drains`` generalized from a single-step
    what-if to a scheduled plan: evaluate the candidates from the CURRENT
    state, pick up to ``maxNodes`` removable ones (emptiest first), and
    execute the drains wave by wave under the PDB ledger."""

    def __init__(self, index, name, selection, max_nodes, wave):
        super().__init__(index, name)
        self.selection = selection
        self.max_nodes = max_nodes
        self.wave = wave

    @classmethod
    def parse(cls, index, name, f):
        where = f.where
        selection = NodeSelection.parse(f, require=False)
        max_nodes = f.take("maxNodes", 1)
        try:
            max_nodes = int(max_nodes)
        except (TypeError, ValueError):
            raise CampaignError("must be an integer", step=where, field="maxNodes") from None
        if max_nodes < 1:
            raise CampaignError("must be >= 1", step=where, field="maxNodes")
        wave = f.take("wave", 1)
        try:
            wave = int(wave)
        except (TypeError, ValueError):
            raise CampaignError("must be an integer", step=where, field="wave") from None
        if wave < 1:
            raise CampaignError("must be >= 1", step=where, field="wave")
        return cls(index, name, selection, max_nodes, wave)

    def run(self, ex, rep):
        verdicts = [
            (si, ex.check_node_removable(si))
            for si in self.selection.resolve(ex, self.where)
        ]
        rep.checks.extend(v for _, v in verdicts)
        removable = [
            (v["pods"], v["node"], si) for si, v in verdicts if v["removable"]
        ]
        removable.sort()  # emptiest first, stable-id tie-break
        chosen = [si for _, _, si in removable[: self.max_nodes]]
        if chosen:
            ex.drain(chosen, self.wave, rep)


@register_step("from-journal")
class FromJournalStep(Step):
    """Replay a recorded generation range (``simon server --journal``)
    through the campaign's apply path: node ADDED/DELETED become node
    mutations, pod ADDED/MODIFIED/DELETED become admissions/deletions, and
    unbound arrivals schedule through the same scan as a deploy step."""

    def __init__(self, index, name, journal, gen_from, gen_to):
        super().__init__(index, name)
        self.journal = journal
        self.gen_from = gen_from
        self.gen_to = gen_to

    @classmethod
    def parse(cls, index, name, f):
        where = f.where
        journal = f.take("journal")
        if not journal:
            raise CampaignError("needs the journal directory path", step=where, field="journal")
        gen_from = f.take("fromGeneration", 0)
        gen_to = f.take("toGeneration")
        try:
            gen_from = int(gen_from)
            gen_to = None if gen_to is None else int(gen_to)
        except (TypeError, ValueError):
            raise CampaignError(
                "generations must be integers", step=where, field="fromGeneration"
            ) from None
        return cls(index, name, str(journal), gen_from, gen_to)

    def run(self, ex, rep):
        from ..server.journal import iter_records

        path = _resolve_path(self.journal)
        if not os.path.isdir(path):
            raise CampaignError(
                f"{path!r} is not a journal directory", step=self.where, field="journal"
            )
        # NET effect of the range, per object key in record order: the last
        # event wins (an add later deleted inside the window never
        # materializes) — the replayed state at toGeneration, applied
        # through the campaign's own admission/scan path.
        node_final: Dict[str, Optional[Node]] = {}
        pod_final: Dict[Tuple[str, str], Optional[dict]] = {}
        n_events = 0
        for rec in iter_records(path):
            if rec.get("t") != "ev":
                continue
            gen = int(rec.get("gen") or 0)
            if gen <= self.gen_from or (self.gen_to is not None and gen > self.gen_to):
                continue
            f_res, kind, obj = rec.get("f"), rec.get("k"), rec.get("o") or {}
            meta = obj.get("metadata") or {}
            if f_res == "nodes":
                n_events += 1
                name = str(meta.get("name") or "")
                if kind == "DELETED":
                    node_final[name] = None
                elif kind in ("ADDED", "MODIFIED"):
                    node_final[name] = Node.from_dict(obj)
            elif f_res == "pods":
                n_events += 1
                key = (str(meta.get("namespace") or ""), str(meta.get("name") or ""))
                if kind == "DELETED":
                    pod_final[key] = None
                elif kind in ("ADDED", "MODIFIED"):
                    phase = (obj.get("status") or {}).get("phase", "")
                    pod_final[key] = None if phase in ("Succeeded", "Failed") else obj
        rep.journal_events = n_events
        if not n_events:
            return

        fresh_adds = []
        for name, node in node_final.items():
            if node is None:
                continue
            si = ex.node_by_name.get(name)
            if si is None:
                fresh_adds.append(node)
            elif ex.node_alive[si]:
                # MODIFIED of a node the campaign already tracks: capacity
                # changes need a rebase, not a delta — reported loudly as a
                # skipped event, never silently replayed with stale alloc
                rep.unschedulable.append(
                    {
                        "pod": f"<node {ex._node_stable_id(si)}>",
                        "reason": "journal node MODIFIED skipped: in-place node "
                        "capacity changes are outside the campaign delta envelope "
                        "(replay from a checkpoint at this generation instead)",
                    }
                )
        if fresh_adds:
            ex.add_nodes(fresh_adds, rep, self.where)
        displaced: List[int] = []
        for name, node in node_final.items():
            if node is not None:
                continue
            si = ex.node_by_name.get(name)
            if si is None or not ex.node_alive[si]:
                continue
            for i in ex.bound_on(si, include_ds=True):
                if ex.is_ds[i]:
                    ex.delete_pod(i)
                    rep.deleted += 1
                else:
                    ex.displace(i)
                    displaced.append(i)
            ex.node_sched[si] = False
            ex.node_alive[si] = False
            rep.nodes_removed.append(ex._node_stable_id(si))
        key_to_idx = {
            (p.metadata.namespace, p.metadata.name): i
            for i, p in enumerate(ex.pods)
            if ex.alive[i]
        }
        pod_adds: List[Pod] = []
        for key, obj in pod_final.items():
            i = key_to_idx.pop(key, None)
            if i is not None:
                # replace-or-delete of a pod the campaign already tracks
                ex.delete_pod(i)
                rep.deleted += 1
            if obj is not None:
                pod_adds.append(Pod.from_dict(obj))
        new: List[int] = []
        if pod_adds:
            rt = ResourceTypes()
            rt.pods = pod_adds
            new = ex.admit_app(f"journal-{self.index}", rt, self.where)
            rep.pods_added += len(new)
        ex.run_scan(displaced + new + ex.pending_idxs(), rep)


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def run_campaign(
    cluster: ResourceTypes,
    spec_or_steps,
    mode: Optional[str] = None,
    name: str = "",
    device: DeviceLike = None,
) -> CampaignResult:
    """Execute a campaign against a cluster on `device` (the card unless
    the caller names another). ``spec_or_steps`` is a parsed
    :class:`CampaignSpec`, a typed step list, or a raw ``spec.steps`` list
    (the REST body shape). The baseline (step -1 semantics folded into
    step reports as index 0 of execution: the initial placement of the
    cluster's own pods) always runs first so every later step starts from
    a fully-placed state."""
    if isinstance(spec_or_steps, CampaignSpec):
        steps = spec_or_steps.steps
        name = name or spec_or_steps.name
        base = spec_or_steps.base_dir
    elif spec_or_steps and isinstance(spec_or_steps[0], Step):
        steps = list(spec_or_steps)
        base = ""
    else:
        steps = parse_steps(spec_or_steps)
        base = ""
    mode = mode or exec_mode()
    prev = _BASE_DIR[0]
    if base:
        _BASE_DIR[0] = base
    try:
        ex = _Executor(cluster, mode, device)
        reports: List[StepReport] = []

        baseline = StepReport(index=0, name="baseline", type="baseline")
        ex.run_scan(list(range(len(ex.pods))), baseline, count_as="rescheduled")
        baseline.rescheduled = 0  # the initial placement is not a reschedule
        ex.score(baseline)
        reports.append(baseline)

        for step in steps:
            rep = StepReport(index=len(reports), name=step.name, type=step.type_name)
            step.run(ex, rep)
            ex.score(rep)
            reports.append(rep)

        h = hashlib.blake2b(digest_size=16)
        for rep in reports:
            h.update(rep.fingerprint.encode())
        return CampaignResult(
            name=name or "campaign",
            mode=mode,
            steps=reports,
            fingerprint=h.hexdigest(),
            full_prepares=ex.full_prepares,
        )
    finally:
        _BASE_DIR[0] = prev


def _cluster_path(base: str, p: str, field: str) -> str:
    try:
        return validate.child_path(base, p, label=field)
    except ValueError as e:
        raise CampaignError(str(e), field="cluster") from e


def load_campaign_cluster(spec: CampaignSpec) -> ResourceTypes:
    """The cluster a file-based campaign runs against (``spec.cluster``:
    ``customConfig`` yaml dir or ``kubeConfig``)."""
    custom = spec.cluster.get("customConfig", "")
    kube = spec.cluster.get("kubeConfig", "")
    if custom:
        path = _cluster_path(spec.base_dir, custom, "spec.cluster.customConfig")
        return expand.load_cluster_from_dir(path)
    if kube:
        from ..server.snapshot import cluster_from_kubeconfig

        path = _cluster_path(spec.base_dir, kube, "spec.cluster.kubeConfig")
        return cluster_from_kubeconfig(path)
    raise CampaignError(
        "spec.cluster needs customConfig or kubeConfig (or run the campaign "
        "against a live server: simon campaign --url)",
        field="cluster",
    )
