"""Scheduler configuration — KubeSchedulerConfiguration support; the
port's copy of ``opensim_tpu/engine/schedconfig.py``.

The reference loads an optional scheduler-config file through the kube
scheduler's own options machinery (``GetAndSetSchedulerConfig`` +
``InitKubeSchedulerConfiguration``, ``pkg/simulator/utils.go:277-381``),
which accepts the full v1beta1 surface: multiple profiles (pods select one
via ``spec.schedulerName``), per-plugin ``pluginConfig`` args, and plugin
enable/disable sets per extension point. Here the same file parses into one
``SchedulerConfig`` per profile; ``resolve_profiles`` routes the pod stream
(all pods referencing one effective config — the reference's own usage, as
``MakeValidPod`` defaults every pod to ``default-scheduler``) and
``resolve_profile_segments`` splits it into contiguous same-profile runs.
A resolved config goes to the bind-scan kernels as launch arguments
(``ops/kernels.kernel_config``).

What maps is implemented; what would silently change semantics fails
loudly naming the field:

- score/filter ``enabled``/``disabled`` (incl. ``"*"``) with weights — full
  kube merge semantics per profile;
- ``NodeResourcesFitArgs.ignoredResources`` / ``ignoredResourceGroups`` —
  the fit filter skips those resource columns;
- ``InterPodAffinityArgs.hardPodAffinityWeight`` — accepted at the default
  (1), rejected otherwise (the weight is encoded at template-build time);
- args that cannot change a simulation's outcome in either implementation
  (``DefaultPreemption``, volume plugins) are accepted;
- everything else — unknown plugins, unknown extension points,
  ``percentageOfNodesToScore`` ≠ 100 (the reference forces 100,
  utils.go:370), outcome-changing args like
  ``PodTopologySpreadArgs.defaultConstraints`` — raises ``ValueError``
  naming the offender.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

# kube plugin names → kernel slots
SCORE_PLUGINS = {
    "NodeResourcesBalancedAllocation": "balanced",
    "NodeResourcesLeastAllocated": "least",
    "NodeAffinity": "node_affinity",
    "TaintToleration": "taint_toleration",
    "InterPodAffinity": "interpod",
    "PodTopologySpread": "spread",
    "Simon": "simon",
    "Open-Gpu-Share": "gpu_share",
    "Open-Local": "local",
    "NodePreferAvoidPods": "prefer_avoid",
    # present in the default profile but structurally zero in a simulation
    # (nodes carry no images)
    "ImageLocality": None,
    "SelectorSpread": None,  # disabled by default in 1.21 (PodTopologySpread)
}

FILTER_PLUGINS = {
    "NodeUnschedulable": "unschedulable",
    "NodeName": "node_name",
    "TaintToleration": "taints",
    "NodeAffinity": "node_affinity",
    "NodePorts": "ports",
    "NodeResourcesFit": "fit",
    "PodTopologySpread": "spread",
    "InterPodAffinity": "interpod",
    "Open-Gpu-Share": "gpu",
    "Open-Local": "local",
}

# volume filters are structurally vacuous in BOTH implementations
# (MakeValidPod rewrites every PVC to a hostPath — PARITY.md #7), and the
# remaining names are kube 1.21 defaults whose behavior the simulation
# either folds elsewhere (DefaultBinder → the bind step, PrioritySort →
# stream order, DefaultPreemption → never fires, simulator.go:333-342)
_VACUOUS_PLUGINS = {
    "VolumeRestrictions", "VolumeBinding", "VolumeZone", "NodeVolumeLimits",
    "EBSLimits", "GCEPDLimits", "AzureDiskLimits", "CinderLimits",
    "DefaultBinder", "PrioritySort", "DefaultPreemption",
}
_KNOWN_PLUGINS = set(SCORE_PLUGINS) | set(FILTER_PLUGINS) | _VACUOUS_PLUGINS

_EXTENSION_POINTS = {
    "queueSort", "preFilter", "filter", "postFilter", "preScore", "score",
    "reserve", "permit", "preBind", "bind", "postBind",
}

from ..models.objects import DEFAULT_SCHEDULER_NAME  # noqa: E402 (single source)


class SchedulerConfig(NamedTuple):
    """Score weights (0 disables a score plugin), filter disables, and the
    NodeResourcesFit ignored columns. Defaults mirror
    algorithmprovider/registry.go:119-132 plus the three simulator plugins
    at weight 1. Hashable; ops/kernels.kernel_config packs it for a launch."""

    w_balanced: float = 1.0
    w_least: float = 1.0
    w_node_affinity: float = 1.0
    w_taint_toleration: float = 1.0
    w_interpod: float = 1.0
    w_spread: float = 2.0
    w_prefer_avoid: float = 10000.0
    w_simon: float = 1.0
    w_gpu_share: float = 1.0
    w_local: float = 1.0
    f_taints: bool = True
    f_node_affinity: bool = True
    f_ports: bool = True
    f_fit: bool = True
    f_spread: bool = True
    f_interpod: bool = True
    f_gpu: bool = True
    f_local: bool = True
    f_unschedulable: bool = True
    # resource-axis columns the fit filter skips (NodeResourcesFitArgs
    # ignoredResources/ignoredResourceGroups, resolved against the vocab by
    # resolve_profiles)
    fit_ignored_cols: tuple = ()


DEFAULT_CONFIG = SchedulerConfig()


class Profile(NamedTuple):
    scheduler_name: str
    config: SchedulerConfig
    fit_ignored_names: Tuple[str, ...] = ()
    fit_ignored_groups: Tuple[str, ...] = ()


class SchedulerProfiles(NamedTuple):
    """All profiles of one KubeSchedulerConfiguration, in file order."""

    profiles: Tuple[Profile, ...]

    def lookup(self, scheduler_name: str) -> Optional[Profile]:
        for p in self.profiles:
            if p.scheduler_name == scheduler_name:
                return p
        return None


def _err(path: str, msg: str):
    raise ValueError(f"{path}: {msg}")


def _parse_plugin_args(path: str, profile_name: str, entries) -> tuple:
    """pluginConfig → (fit_ignored_names, fit_ignored_groups); everything
    that would change outcomes and does not map fails loudly."""
    names: list = []
    groups: list = []
    for pc in entries or []:
        pname = str(pc.get("name", ""))
        args = pc.get("args") or {}
        if pname == "NodeResourcesFit":
            for field, val in args.items():
                if field == "ignoredResources":
                    names.extend(str(v) for v in val or [])
                elif field == "ignoredResourceGroups":
                    groups.extend(str(v) for v in val or [])
                elif field in ("apiVersion", "kind"):
                    continue
                else:
                    _err(path, f"profile {profile_name!r}: NodeResourcesFitArgs."
                               f"{field} is not supported (only ignoredResources/"
                               "ignoredResourceGroups map onto the fit kernel)")
        elif pname == "InterPodAffinity":
            w = args.get("hardPodAffinityWeight", 1)
            if int(w) != 1:
                _err(path, f"profile {profile_name!r}: InterPodAffinityArgs."
                           f"hardPodAffinityWeight={w} is not supported (the "
                           "symmetric hard-affinity weight is fixed at the "
                           "default 1, encoded at template build)")
            for field in args:
                if field not in ("hardPodAffinityWeight", "apiVersion", "kind"):
                    _err(path, f"profile {profile_name!r}: InterPodAffinityArgs."
                               f"{field} is not supported")
        elif pname in _VACUOUS_PLUGINS:
            # cannot change a simulation's outcome in either implementation
            continue
        elif pname in _KNOWN_PLUGINS:
            if args:
                fields = ", ".join(k for k in args if k not in ("apiVersion", "kind"))
                _err(path, f"profile {profile_name!r}: pluginConfig args for "
                           f"{pname} ({fields}) are not supported — they would "
                           "change scoring/filtering semantics silently")
        else:
            _err(path, f"profile {profile_name!r}: pluginConfig names unknown "
                       f"plugin {pname!r}")
    return tuple(names), tuple(groups)


def _parse_profile(path: str, profile: dict, index: int) -> Profile:
    name = str(profile.get("schedulerName") or DEFAULT_SCHEDULER_NAME)
    plugins = profile.get("plugins") or {}
    cfg = DEFAULT_CONFIG._asdict()

    for point in plugins:
        if point not in _EXTENSION_POINTS:
            _err(path, f"profile {name!r}: unknown plugins extension point "
                       f"{point!r}")

    def check_known(entries, where):
        for entry in entries or []:
            ename = str(entry.get("name", ""))
            if ename != "*" and ename not in _KNOWN_PLUGINS:
                _err(path, f"profile {name!r}: {where} names unknown plugin "
                           f"{ename!r}")

    # kube merge semantics (vendored mergePluginSets): disabled entries
    # filter the defaults FIRST, then user-enabled entries are appended —
    # so `disabled: "*"` + `enabled: [X]` leaves only X.
    score = plugins.get("score") or {}
    check_known(score.get("disabled"), "plugins.score.disabled")
    check_known(score.get("enabled"), "plugins.score.enabled")
    for entry in score.get("disabled") or []:
        ename = str(entry.get("name", ""))
        if ename == "*":
            for k in list(cfg):
                if k.startswith("w_"):
                    cfg[k] = 0.0
            continue
        slot = SCORE_PLUGINS.get(ename)
        if slot:
            cfg[f"w_{slot}"] = 0.0
    for entry in score.get("enabled") or []:
        slot = SCORE_PLUGINS.get(str(entry.get("name", "")))
        if slot:
            cfg[f"w_{slot}"] = float(entry.get("weight", 1) or 1)

    filt = plugins.get("filter") or {}
    check_known(filt.get("disabled"), "plugins.filter.disabled")
    check_known(filt.get("enabled"), "plugins.filter.enabled")
    for entry in filt.get("disabled") or []:
        ename = str(entry.get("name", ""))
        if ename == "*":
            for k in list(cfg):
                if k.startswith("f_"):
                    cfg[k] = False
            continue
        slot = FILTER_PLUGINS.get(ename)
        if slot and slot != "node_name":
            cfg[f"f_{slot}"] = False

    # other extension points: validate names only — their semantics are
    # fused into the scan (reserve/bind) or structural (queueSort)
    for point in ("preFilter", "preScore", "reserve", "permit", "preBind",
                  "bind", "postBind", "postFilter", "queueSort"):
        ps = plugins.get(point) or {}
        check_known(ps.get("disabled"), f"plugins.{point}.disabled")
        check_known(ps.get("enabled"), f"plugins.{point}.enabled")

    names, groups = _parse_plugin_args(path, name, profile.get("pluginConfig"))
    return Profile(
        scheduler_name=name,
        config=SchedulerConfig(**cfg),
        fit_ignored_names=names,
        fit_ignored_groups=groups,
    )


def load_scheduler_config(path: str):
    """Parse a KubeSchedulerConfiguration yaml. Returns a SchedulerConfig
    for the common single-default-profile case (hashable, usable
    as a simulate() or sweep config directly) or a SchedulerProfiles when
    the file defines named/multiple profiles or per-plugin args that must
    resolve against the cluster's resource vocabulary."""
    import yaml

    with open(path) as f:
        doc = yaml.safe_load(f) or {}
    if doc.get("kind") not in ("KubeSchedulerConfiguration", None):
        raise ValueError(f"{path}: not a KubeSchedulerConfiguration")
    pct = doc.get("percentageOfNodesToScore")
    if pct not in (None, 0, 100):
        _err(path, f"percentageOfNodesToScore={pct} is not supported: the "
                   "reference forces 100 (pkg/simulator/utils.go:370) and "
                   "every kernel scores the full node axis")
    profiles_doc = doc.get("profiles") or []
    if not profiles_doc:
        return DEFAULT_CONFIG
    profiles = tuple(
        _parse_profile(path, p or {}, i) for i, p in enumerate(profiles_doc)
    )
    seen = set()
    for p in profiles:
        if p.scheduler_name in seen:
            _err(path, f"duplicate profile schedulerName {p.scheduler_name!r}")
        seen.add(p.scheduler_name)
    if (
        len(profiles) == 1
        and profiles[0].scheduler_name == DEFAULT_SCHEDULER_NAME
        and not profiles[0].fit_ignored_names
        and not profiles[0].fit_ignored_groups
    ):
        return profiles[0].config
    return SchedulerProfiles(profiles=profiles)


# pathological profile alternation would mean one scan per pod; above this
# many contiguous segments the stream is treated as non-segmentable
MAX_PROFILE_SEGMENTS = 64


def _route_stream(sched_config, ordered, resource_names, forced=None):
    """Shared profile routing: returns (segments, invalid, used) where
    ``segments`` is ``[(config_or_None, lo, hi)]`` contiguous same-profile
    runs covering the stream in order, ``invalid`` maps pod index →
    unknown-profile reason, and ``used`` maps profile name → resolved
    config (None for unknown names). Both public resolvers wrap this so
    the per-profile column resolution and reason wording cannot drift."""
    def resolve_cols(profile: Profile) -> SchedulerConfig:
        cols = []
        for i, rname in enumerate(resource_names):
            if rname in profile.fit_ignored_names or any(
                rname.startswith(g + "/") for g in profile.fit_ignored_groups
            ):
                cols.append(i)
        return profile.config._replace(fit_ignored_cols=tuple(cols))

    invalid = {}
    used = {}
    segments = []
    cur_cfg = None
    have_cur = False
    lo = 0
    for i, pod in enumerate(ordered):
        if forced is not None and forced[i]:
            continue  # bypasses every scheduler (simulator.go:329-331)
        name = pod.spec.scheduler_name or DEFAULT_SCHEDULER_NAME
        if name not in used:
            profile = sched_config.lookup(name)
            used[name] = None if profile is None else resolve_cols(profile)
        cfg = used[name]
        if cfg is None:
            from .reasons import unknown_profile

            invalid[i] = unknown_profile(name)
            continue  # never scheduled; extends the active segment
        if not have_cur:
            cur_cfg, have_cur = cfg, True
        elif cfg != cur_cfg:
            segments.append((cur_cfg, lo, i))
            cur_cfg, lo = cfg, i
    segments.append((cur_cfg if have_cur else None, lo, len(ordered)))
    return segments, invalid, used


def resolve_profiles(sched_config, ordered, resource_names, forced=None):
    """Route the pod stream onto ONE effective SchedulerConfig.

    Returns (config_or_None, invalid) where `invalid` maps pod index →
    unschedulable reason for pods whose spec.schedulerName matches no
    profile (kube's event handlers never admit them to the queue, so they
    stay Pending forever; the simulation reports that explicitly).

    Unforced pods referencing two or more profiles whose resolved configs
    DIFFER raise ValueError — the callers of this resolver (batched
    scenario sweeps) run one compiled pipeline for the whole stream.
    ``simulate`` routes through :func:`resolve_profile_segments` instead,
    which supports differing profiles as consecutive scans."""
    if sched_config is None or isinstance(sched_config, SchedulerConfig):
        return sched_config, {}
    if not isinstance(sched_config, SchedulerProfiles):
        raise ValueError(f"unsupported scheduler config object: {sched_config!r}")
    segments, invalid, used = _route_stream(sched_config, ordered, resource_names, forced)
    distinct = {cfg for cfg, _, _ in segments if cfg is not None}
    if len(distinct) > 1:
        names = sorted(n for n, c in used.items() if c is not None)
        raise ValueError(
            "pods reference scheduler profiles with differing plugin "
            f"configurations ({', '.join(names)}); per-pod profile routing "
            "inside one simulation is not supported"
        )
    return (distinct.pop() if distinct else None), invalid


def resolve_profile_segments(sched_config, ordered, resource_names, forced=None):
    """Split the pod stream into contiguous same-profile segments.

    Returns (segments, invalid): ``segments`` is a list of
    ``(config_or_None, lo, hi)`` half-open index ranges covering the whole
    stream in order; ``invalid`` maps pod index → unschedulable reason
    (unknown profile — kube's event handlers never admit such pods).

    Where :func:`resolve_profiles` raises on DIFFERING referenced profiles,
    this resolver supports them (``utils.go:304-381`` accepts the full
    multi-profile surface): consecutive scans share the scheduling carry,
    so placements equal the reference's serial loop routing each pod to
    its profile's framework. Forced pods bypass every scheduler and simply
    extend the current segment (binds stay in stream order). Only a
    pathological interleaving (> MAX_PROFILE_SEGMENTS contiguous runs)
    raises."""
    if sched_config is None or isinstance(sched_config, SchedulerConfig):
        return [(sched_config, 0, len(ordered))], {}
    if not isinstance(sched_config, SchedulerProfiles):
        raise ValueError(f"unsupported scheduler config object: {sched_config!r}")
    segments, invalid, _used = _route_stream(sched_config, ordered, resource_names, forced)
    if len(segments) > MAX_PROFILE_SEGMENTS:
        raise ValueError(
            f"pod stream alternates scheduler profiles into {len(segments)} "
            f"segments (> {MAX_PROFILE_SEGMENTS}): non-segmentable "
            "interleaving; order pods by profile"
        )
    return segments, invalid
