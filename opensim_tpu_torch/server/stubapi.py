"""Canned stub apiserver — the port's copy of the list half of
``opensim_tpu/server/stubapi.py``: the fake cluster the tests and the smoke
run list snapshots from, with no kubernetes package and no real cluster.

- ``GET <path>?resourceVersion=0`` answers ``kind: List`` JSON with a
  list-level ``metadata.resourceVersion`` (a counter every object bumps,
  like etcd's revision);
- :attr:`StubApiServer.forbidden_paths` answers 403 for chosen endpoints
  (minimal-RBAC clusters), and a path never seeded answers 404;
- :meth:`StubApiServer.kubeconfig` writes a bearer-token kubeconfig
  pointing at the server, so the stdlib REST lister of ``server/snapshot.py``
  runs end to end against it.

The watch streams the reference's stub also serves feed the live twin,
ROADMAP Queue 1 item 10.
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
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._rv = 1000
        self._stores: Dict[str, Dict[Tuple[str, str], dict]] = {}  # guarded-by: _lock
        self.forbidden_paths: set = set()
        #: every GET as (path, {param: [values]}) — tests assert on the
        #: query contract (resourceVersion=0 lists)
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

    # -- HTTP ----------------------------------------------------------------

    def _handle(self, h: BaseHTTPRequestHandler) -> None:
        path, _, query = h.path.partition("?")
        params = urllib.parse.parse_qs(query)
        with self._lock:
            self.requests_seen.append((path, params))
        if path in self.forbidden_paths:
            self._send_json(h, 403, {"kind": "Status", "code": 403, "reason": "Forbidden"})
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
