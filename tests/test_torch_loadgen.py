"""``simon loadgen`` of the port (``opensim_tpu_torch/server/loadgen.py``)
against the JAX package's, at the stub's size (8 nodes, 16 bound pods):

- placements: a ``--device cpu`` port server and the JAX package's
  server on the same stub apiserver place the loadgen's probe payloads
  alike, by the port's ``placement_parity`` and by the reference's;
- the closed and the open loop against the port server: zero errors, and
  the report has exactly the keys of the reference's ``run_loadgen``
  against the JAX server;
- sheds: against a server that answers 503 with ``Retry-After``, the
  port's client and the reference's record the same outcomes and back-offs,
  and both loops report the same sheds by reason;
- the fleet boot path (``_boot_server(workers=2)``): each worker inherits
  the one-thread cap, answers as the single-process server, and is gone
  after ``_stop_server``, even when its owner was SIGKILLed first.
"""

import json
import os
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from opensim_tpu.server import loadgen as ref_loadgen
from opensim_tpu.server import rest as ref_rest
from opensim_tpu_torch.server import loadgen, rest
from opensim_tpu_torch.utils.procgroup import pid_gone
from test_torch_ha import _free_port


@pytest.fixture(scope="module")
def stub(tmp_path_factory):
    """The loadgen's stub apiserver (8 nodes, 16 bound pods) and its
    kubeconfig."""
    s = loadgen._seed_stub(8, 16)
    yield s, s.kubeconfig(str(tmp_path_factory.mktemp("kube")))
    s.stop()


def _listen(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def port_url(stub):
    """The port's server on the CPU, the admission queue on (its default)."""
    server, httpd = rest.start_server(kubeconfig=stub[1], port=0, host="127.0.0.1", device="cpu", watch="off",
                                      snapshot_ttl_s=3600.0)
    yield _listen(httpd)
    httpd.shutdown()
    httpd.server_close()
    server.close()


@pytest.fixture(scope="module")
def jax_url(stub):
    """The JAX package's server on the same stub (single-flight)."""
    server = ref_rest.SimonServer(kubeconfig=stub[1], snapshot_ttl_s=3600.0, admission=False, capacity=False)
    httpd = ref_rest.SimonHTTPServer(("127.0.0.1", 0), ref_rest.make_handler(server))
    yield _listen(httpd)
    httpd.shutdown()
    httpd.server_close()


def test_placement_parity_with_jax_server(port_url, jax_url):
    assert loadgen.placement_parity(port_url, jax_url, n_probes=4)
    assert ref_loadgen.placement_parity(port_url, jax_url, n_probes=4)


@pytest.mark.parametrize("mode", ["closed", "open"])
def test_loop_report_has_the_reference_keys(mode, port_url, jax_url):
    kw = dict(mode=mode, concurrency=2, qps=4.0 if mode == "open" else 0.0, timeout_s=30.0)
    got = loadgen.run_loadgen(port_url, duration_s=2.0, **kw)
    want = ref_loadgen.run_loadgen(jax_url, duration_s=1.0, **kw)
    assert set(got) == set(want)
    assert got["errors"] == 0 and got["ok"] > 0 and got["mode"] == mode
    assert got["requests"] == got["ok"] + got["shed"] + got["errors"]
    assert got["server_p50_s"] is not None and got["server_p99_s"] >= got["server_p50_s"]
    if mode == "open":
        assert got["target_qps"] == 4.0
    else:
        assert got["target_qps"] is None and got["dropped"] == 0


class _Shedder(BaseHTTPRequestHandler):
    """Answers each POST by the next of ``script`` (status, Retry-After),
    the last repeated; counts its sheds in ``simon_shed_total``."""

    script = [(503, "0.2")]
    sheds = 0

    def do_POST(self):
        self.rfile.read(int(self.headers.get("Content-Length") or 0))
        cls = type(self)
        status, retry = cls.script[0] if len(cls.script) == 1 else cls.script.pop(0)
        body = b"{}"
        self.send_response(status)
        if status == 503:
            cls.sheds += 1
            if retry is not None:
                self.send_header("Retry-After", retry)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        body = f'simon_shed_total{{reason="queue-full"}} {type(self).sheds}\n'.encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


@pytest.fixture
def shedder():
    handler = type("Shedder", (_Shedder,), {"script": [(503, "0.2")], "sheds": 0})
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    yield handler, _listen(httpd)
    httpd.shutdown()
    httpd.server_close()


def test_client_sheds_and_backoffs_equal_reference(shedder):
    handler, url = shedder
    script = [(503, "0.25"), (503, "soon"), (503, None), (200, None), (500, None), (503, "7")]
    seen = {}
    for name, mod in (("port", loadgen), ("reference", ref_loadgen)):
        handler.script = list(script)
        cli = mod._Client(url, 5.0)
        try:
            seen[name] = [cli.request(b"{}") for _ in script]
        finally:
            cli.close()
    outcomes = [(o, r) for o, _lat, r in seen["port"]]
    assert outcomes == [(o, r) for o, _lat, r in seen["reference"]]
    assert outcomes == [("shed", 0.25), ("shed", 1.0), ("shed", 1.0), ("ok", 0.0), ("error", 0.0), ("shed", 7.0)]


def test_loop_sheds_equal_reference(shedder):
    """A server that sheds everything with ``Retry-After: 0.2``: each of
    two closed-loop workers backs off 0.2 s a shed, so both loops count
    sheds, no errors and no answers, and report the server's shed counter
    by reason."""
    handler, url = shedder
    got = loadgen.run_loadgen(url, concurrency=2, duration_s=1.0, warmup_requests=0)
    want = ref_loadgen.run_loadgen(url, concurrency=2, duration_s=1.0, warmup_requests=0)
    for rep in (got, want):
        assert rep["ok"] == 0 and rep["errors"] == 0 and 4 <= rep["shed"] <= 16
        assert rep["shed_total"] == {"queue-full": rep["shed"]}
    assert set(got) == set(want)


def test_fleet_boot_and_stop_reap_workers(stub, port_url, monkeypatch):
    """``_boot_server(workers=2, device="cpu")``: a fleet owner and two
    workers, each with the one-thread cap it inherited; a worker answers
    the loadgen's probes as the single-process port server does; then the
    owner is SIGKILLed (its workers outlive it) and ``_stop_server`` still
    leaves no server and no worker running."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    base = _free_port(4)
    proc, url = loadgen._boot_server(stub[1], base, admission=True, batch_max=8, workers=2, device="cpu")
    pids = []
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{base + 1}/api/fleet/status", timeout=10) as r:
            status = json.load(r)
        pids = [w["pid"] for w in status["workers"]]
        assert len(pids) == 2 and all(w["alive"] for w in status["workers"])
        for pid in pids:
            with open(f"/proc/{pid}/environ", "rb") as f:
                assert b"OMP_NUM_THREADS=1" in f.read().split(b"\0")
        assert loadgen.placement_parity(url, port_url, n_probes=2)
        proc.kill()
        proc.wait(timeout=30)
        assert not all(pid_gone(pid) for pid in pids), "the workers should outlive a SIGKILLed owner"
    finally:
        loadgen._stop_server(proc, drain_s=30.0)
    left = [pid for pid in [proc.pid, *pids] if not pid_gone(pid)]
    assert not left, f"still running after _stop_server: {left}"
    assert os.path.exists(os.path.join(os.path.dirname(stub[1]), f"server-{base}.log"))
