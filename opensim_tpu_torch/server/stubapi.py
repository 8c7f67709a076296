"""Canned stub apiserver speaking list + watch — the port's copy of
``opensim_tpu/server/stubapi.py``: the fake cluster the tests and the smoke
run list snapshots from and watch, with no kubernetes package and no real
cluster.

- ``GET <path>?resourceVersion=0`` answers ``kind: List`` JSON with a
  list-level ``metadata.resourceVersion`` (a counter every mutation bumps,
  like etcd's revision);
- ``GET <path>?watch=1&resourceVersion=<rv>`` answers a line-delimited
  JSON event stream (``{"type": "ADDED"|"MODIFIED"|"DELETED"|"BOOKMARK",
  "object": …}``): the retained events past ``rv``, then live mutations,
  with BOOKMARK keepalives every ``bookmark_interval_s`` while idle;
- **410 Gone**: :meth:`StubApiServer.compact` discards the retained event
  log (etcd compaction); a watch asking for an rv behind the compaction
  floor gets the ``ERROR`` event with ``code: 410``;
- **server-side drops**: :meth:`StubApiServer.force_disconnect` severs
  every open watch connection (an LB idle reset, an apiserver restart);
- :attr:`StubApiServer.forbidden_paths` answers 403 for chosen endpoints
  (minimal-RBAC clusters), and a path never seeded answers 404.

Mutations (:meth:`upsert` / :meth:`delete`) assign object resourceVersions
and wake the watchers; :meth:`seed` installs objects without events.
:meth:`StubApiServer.kubeconfig` writes a bearer-token kubeconfig pointing
at the server, so the stdlib REST lister of ``server/snapshot.py`` and the
watch source of ``server/watch.py`` run end to end against it.
"""

from __future__ import annotations

import json
import os
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple


def _key(obj: dict) -> Tuple[str, str]:
    meta = obj.get("metadata") or {}
    return (str(meta.get("namespace") or ""), str(meta.get("name") or ""))


class StubApiServer:
    def __init__(self, bookmark_interval_s: float = 0.2) -> None:
        self.bookmark_interval_s = bookmark_interval_s
        self._lock = threading.Condition()
        self._rv = 1000
        self._stores: Dict[str, Dict[Tuple[str, str], dict]] = {}  # guarded-by: _lock
        self._events: List[Tuple[int, str, str, dict]] = []  # (rv, path, type, obj)  # guarded-by: _lock
        self._compacted_rv = 0  # guarded-by: _lock
        self._disconnect_epoch = 0  # guarded-by: _lock
        self.forbidden_paths: set = set()
        #: every GET as (path, {param: [values]}) — tests assert on the
        #: query contract (resourceVersion=0 lists, watch resumption rvs)
        self.requests_seen: List[Tuple[str, dict]] = []
        self._httpd: Optional[ThreadingHTTPServer] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "StubApiServer":
        stub = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # noqa: N802 (stdlib name)
                pass

            def do_GET(self):  # noqa: N802
                stub._handle(self)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self._httpd.serve_forever, daemon=True).start()
        return self

    def stop(self) -> None:
        self.force_disconnect()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()

    @property
    def url(self) -> str:
        if self._httpd is None:
            raise RuntimeError("call start() first")
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def kubeconfig(self, dirpath: str) -> str:
        """Write a bearer-token kubeconfig pointing at this stub; returns
        its path."""
        path = os.path.join(str(dirpath), "stub-kubeconfig")
        with open(path, "w") as f:
            f.write(
                "apiVersion: v1\nkind: Config\ncurrent-context: stub\n"
                "contexts:\n  - name: stub\n    context: {cluster: stub, user: stub}\n"
                f"clusters:\n  - name: stub\n    cluster: {{server: '{self.url}'}}\n"
                "users:\n  - name: stub\n    user: {token: stub-token}\n"
            )
        return path

    # -- objects -------------------------------------------------------------

    def seed(self, path: str, objs: List[dict]) -> None:
        """Install objects under a list path, each with its own
        resourceVersion (private copies: later edits of `objs` do not
        reach the store)."""
        with self._lock:
            store = self._stores.setdefault(path, {})
            for obj in objs:
                self._rv += 1
                obj = json.loads(json.dumps(obj))
                obj.setdefault("metadata", {})["resourceVersion"] = str(self._rv)
                store[_key(obj)] = obj

    def rv(self) -> int:
        with self._lock:
            return self._rv

    def upsert(self, path: str, obj: dict, ev_type: Optional[str] = None) -> int:
        """Create or replace an object; emits ADDED or MODIFIED (or a forced
        ``ev_type``: duplicates and other malformed sequences). Returns the
        assigned resourceVersion."""
        obj = json.loads(json.dumps(obj))  # a private copy, outside the lock
        with self._lock:
            store = self._stores.setdefault(path, {})
            k = _key(obj)
            self._rv += 1
            obj.setdefault("metadata", {})["resourceVersion"] = str(self._rv)
            kind = ev_type or ("MODIFIED" if k in store else "ADDED")
            store[k] = obj
            self._events.append((self._rv, path, kind, obj))
            self._lock.notify_all()
            return self._rv

    def delete(self, path: str, name: str, namespace: str = "default") -> Optional[int]:
        """Remove an object; emits DELETED carrying its final rv. None when
        there is no such object."""
        with self._lock:
            store = self._stores.setdefault(path, {})
            obj = store.pop((namespace, name), None)
            if obj is None:
                return None
            self._rv += 1
            obj = dict(obj, metadata=dict(obj.get("metadata") or {}, resourceVersion=str(self._rv)))
            self._events.append((self._rv, path, "DELETED", obj))
            self._lock.notify_all()
            return self._rv

    def compact(self) -> None:
        """Discard the retained event log (etcd compaction): a watch
        resuming from an rv behind the floor now gets 410 Gone."""
        with self._lock:
            self._compacted_rv = self._rv
            self._events.clear()
            self._lock.notify_all()

    def force_disconnect(self) -> None:
        """Sever every open watch connection server-side."""
        with self._lock:
            self._disconnect_epoch += 1
            self._lock.notify_all()

    # -- HTTP ----------------------------------------------------------------

    def _handle(self, h: BaseHTTPRequestHandler) -> None:
        path, _, query = h.path.partition("?")
        params = urllib.parse.parse_qs(query)
        with self._lock:
            self.requests_seen.append((path, params))
        if path in self.forbidden_paths:
            self._send_json(h, 403, {"kind": "Status", "code": 403, "reason": "Forbidden"})
            return
        if params.get("watch") == ["1"]:
            with self._lock:
                known = path in self._stores
            if not known:
                self._send_json(h, 404, {"kind": "Status", "code": 404, "reason": "NotFound"})
                return
            try:
                rv = int((params.get("resourceVersion") or ["0"])[0] or 0)
            except ValueError:
                rv = 0
            self._serve_watch(h, path, rv)
            return
        with self._lock:
            store = self._stores.get(path)
            body = None if store is None else {
                "kind": "List", "metadata": {"resourceVersion": str(self._rv)}, "items": list(store.values()),
            }
            data = None if body is None else json.dumps(body).encode()
        if data is None:
            self._send_json(h, 404, {"kind": "Status", "code": 404, "reason": "NotFound"})
            return
        self._send(h, 200, data)

    def _send_json(self, h: BaseHTTPRequestHandler, code: int, body: dict) -> None:
        self._send(h, code, json.dumps(body).encode())

    @staticmethod
    def _send(h: BaseHTTPRequestHandler, code: int, data: bytes) -> None:
        h.send_response(code)
        h.send_header("Content-Type", "application/json")
        h.send_header("Content-Length", str(len(data)))
        h.end_headers()
        h.wfile.write(data)

    def _pending(self, path: str, cursor: int) -> List[Tuple[int, str, dict]]:
        # the log is in rv order: scan back from its end to the cursor
        out = []
        for erv, epath, etype, obj in reversed(self._events):
            if erv <= cursor:
                break
            if epath == path:
                out.append((erv, etype, obj))
        out.reverse()
        return out

    def _serve_watch(self, h: BaseHTTPRequestHandler, path: str, rv: int) -> None:
        h.send_response(200)
        h.send_header("Content-Type", "application/json")
        h.end_headers()

        def emit(lines: List[bytes]) -> bool:
            try:
                h.wfile.write(b"".join(lines))
                h.wfile.flush()
                return True
            except (BrokenPipeError, ConnectionResetError, OSError):
                return False

        with self._lock:
            epoch = self._disconnect_epoch
            floor = self._compacted_rv
        if rv and rv < floor:
            emit([json.dumps({"type": "ERROR", "object": {
                "kind": "Status", "code": 410, "reason": "Expired",
                "message": f"too old resource version: {rv} ({floor})",
            }}).encode() + b"\n"])
            return
        cursor = rv
        while True:
            with self._lock:
                if self._disconnect_epoch != epoch:
                    return  # server-side drop: close the connection
                batch = self._pending(path, cursor)
                if not batch:
                    self._lock.wait(self.bookmark_interval_s)
                    if self._disconnect_epoch != epoch:
                        return
                    batch = self._pending(path, cursor)
                    if not batch:
                        # idle: a BOOKMARK keepalive carrying the current rv
                        batch = [(cursor, "BOOKMARK", {"kind": "Bookmark",
                                                       "metadata": {"resourceVersion": str(self._rv)}})]
                lines = [json.dumps({"type": etype, "object": obj}).encode() + b"\n" for _erv, etype, obj in batch]
            if not emit(lines):
                return
            cursor = max(cursor, max(erv for erv, _t, _o in batch))
