"""Dictionary encoding: the string world → int world bridge.

Every string that matters to scheduling (label keys, label values, taint
keys/values, namespaces, host ports, resource names) is interned into a
dense id space so the kernels in ``ops/`` operate on int32
tensors. This replaces the reference's string-keyed map lookups inside the
vendored scheduler's hot loop (e.g. label matching in
``vendor/k8s.io/kubernetes/pkg/scheduler/framework/plugins``).
"""

from __future__ import annotations

from typing import Dict, Hashable, List

# Operator codes shared by node-selector requirement encodings.
OP_IN = 0
OP_NOT_IN = 1
OP_EXISTS = 2
OP_DOES_NOT_EXIST = 3
OP_GT = 4
OP_LT = 5
OP_PAD = -1  # absent requirement slot (vacuously true)

NODE_OP_CODES = {
    "In": OP_IN,
    "NotIn": OP_NOT_IN,
    "Exists": OP_EXISTS,
    "DoesNotExist": OP_DOES_NOT_EXIST,
    "Gt": OP_GT,
    "Lt": OP_LT,
}

# Taint effects.
EFFECT_NO_SCHEDULE = 0
EFFECT_PREFER_NO_SCHEDULE = 1
EFFECT_NO_EXECUTE = 2
EFFECT_CODES = {
    "NoSchedule": EFFECT_NO_SCHEDULE,
    "PreferNoSchedule": EFFECT_PREFER_NO_SCHEDULE,
    "NoExecute": EFFECT_NO_EXECUTE,
}
EFFECT_ALL = -1  # toleration with empty effect matches all effects

# Toleration operators.
TOL_EQUAL = 0
TOL_EXISTS = 1

# Canonical resource axis prefix; extended resources get appended by Vocab.
# cpu is stored in millicores, all others in base units.
RES_CPU = 0
RES_MEMORY = 1
RES_EPHEMERAL = 2
RES_PODS = 3
BASE_RESOURCES = ["cpu", "memory", "ephemeral-storage", "pods"]

# Resources ignored for fit (hugepages-* would be checked by k8s, keep them
# as extended resources instead of ignoring).
_SKIP_RESOURCES = set()


class Interner:
    """Monotonic string→id table."""

    def __init__(self) -> None:
        self._ids: Dict[Hashable, int] = {}
        self._items: List[Hashable] = []

    def clone(self) -> "Interner":
        new = Interner()
        new._ids = dict(self._ids)
        new._items = list(self._items)
        return new

    def intern(self, item: Hashable) -> int:
        idx = self._ids.get(item)
        if idx is None:
            idx = len(self._items)
            self._ids[item] = idx
            self._items.append(item)
        return idx

    def get(self, item: Hashable, default: int = -1) -> int:
        return self._ids.get(item, default)

    def __len__(self) -> int:
        return len(self._items)

    def __contains__(self, item: Hashable) -> bool:
        return item in self._ids

    def items(self) -> List[Hashable]:
        return list(self._items)

    def lookup(self, idx: int) -> Hashable:
        return self._items[idx]


class Vocab:
    """All interners for one simulation."""

    def __init__(self) -> None:
        self.label_keys = Interner()  # label keys + the metadata.name pseudo-key
        self.label_vals = Interner()  # global value space (shared across keys)
        self.ports = Interner()  # (protocol, port, hostIP) triples
        self.resources = Interner()  # resource-name axis
        self.topo_keys = Interner()  # label keys used as topology keys (subset)
        for r in BASE_RESOURCES:
            self.resources.intern(r)

    def clone(self) -> "Vocab":
        """Fork for delta re-encoding: ids are append-only, so a forked
        vocab can intern new strings without invalidating the base's
        already-encoded tensors."""
        new = object.__new__(Vocab)
        new.label_keys = self.label_keys.clone()
        new.label_vals = self.label_vals.clone()
        new.ports = self.ports.clone()
        new.resources = self.resources.clone()
        new.topo_keys = self.topo_keys.clone()
        return new

    # -- resources ----------------------------------------------------------

    def resource_id(self, name: str) -> int:
        if name in _SKIP_RESOURCES:
            return -1
        return self.resources.intern(name)

    def encode_resources(self, requests: Dict[str, float]) -> Dict[int, float]:
        """Resource dict → {axis index: value}, cpu scaled to millicores."""
        out: Dict[int, float] = {}
        for name, val in requests.items():
            rid = self.resource_id(name)
            if rid < 0:
                continue
            out[rid] = val * 1000.0 if name == "cpu" else val
        return out

    # -- labels -------------------------------------------------------------

    def key_id(self, key: str) -> int:
        return self.label_keys.intern(key)

    def val_id(self, val: str) -> int:
        return self.label_vals.intern(str(val))

    def topo_key_id(self, key: str) -> int:
        self.key_id(key)
        return self.topo_keys.intern(key)

    def port_id(self, protocol: str, port: int, host_ip: str = "") -> int:
        # 0.0.0.0 and "" are the same wildcard address for conflict purposes.
        ip = "" if host_ip in ("", "0.0.0.0") else host_ip
        return self.ports.intern((protocol or "TCP", int(port), ip))

    def port_conflict_matrix(self):
        """[Hports, Hports] bool: interned triples i and j conflict when
        protocol+port match and either hostIP is the wildcard or they are
        equal (nodeports.go ckConflict semantics — 0.0.0.0 overlaps every
        specific address on the same port)."""
        import numpy as np

        triples = self.ports.items()
        n = max(len(triples), 1)
        m = np.zeros((n, n), dtype=bool)
        for i, (proto_i, port_i, ip_i) in enumerate(triples):
            for j, (proto_j, port_j, ip_j) in enumerate(triples):
                if proto_i == proto_j and port_i == port_j:
                    m[i, j] = ip_i == ip_j or ip_i == "" or ip_j == ""
        return m

    @property
    def n_resources(self) -> int:
        return len(self.resources)

    @property
    def n_label_keys(self) -> int:
        return len(self.label_keys)

    @property
    def n_topo_keys(self) -> int:
        return len(self.topo_keys)

    @property
    def n_ports(self) -> int:
        return len(self.ports)
