"""An HTTP scheduler extender on the loopback interface, for tests and
the chip smoke: a ``http.server`` on 127.0.0.1 at an ephemeral port, on a
thread of its own, answering the extender verbs' JSON POSTs
(``/filter``, ``/prioritize``, ``/bind``, ``/preempt``).

    ext = LoopbackExtender().start()
    cfg = {"extenders": [ext.config(filterVerb="filter",
                                    prioritizeVerb="prioritize",
                                    managedResources=[{"name": "ex.com/r"}])]}
    sched = Scheduler.create(store, config=cfg)
    ...
    ext.stop()

The filter keeps the ``crc_keeps(name)`` nodes and fails the rest with
``REASON``; a node's priority is ``crc_score(pod, node)``; ``/bind``
answers success and ``/preempt`` keeps every candidate node. ``calls``
counts the requests by verb; with ``record`` each (verb, payload) is
kept in ``payloads``. ``fail`` names verbs that answer HTTP 500.
"""

from __future__ import annotations

import json
import threading
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

REASON = "node(s) refused by the extender"


def crc_keeps(name: str) -> bool:
    """The default filter: three nodes in four pass, by name."""
    return zlib.crc32(name.encode()) % 4 != 0


def crc_score(pod_name: str, node_name: str) -> int:
    """The default priority: 0-9, a hash of the pod and node names."""
    return zlib.crc32(f"{pod_name}/{node_name}".encode()) % 10


class LoopbackExtender:
    def __init__(self, record: bool = False, fail=()):
        self.record = record
        self.fail = set(fail)
        self.calls: Dict[str, int] = {}
        self.payloads: List[Tuple[str, dict]] = []
        self._lock = threading.Lock()
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    def config(self, **fields) -> dict:
        """The v1beta1 extender entry for this server (``urlPrefix`` set;
        the verbs, weight and the rest as given)."""
        return {"urlPrefix": self.url, **fields}

    def start(self) -> "LoopbackExtender":
        ext = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):   # noqa: N802 - the handler's name
                verb = self.path.strip("/")
                body = json.loads(self.rfile.read(
                    int(self.headers.get("Content-Length", 0))) or b"{}")
                code, reply = ext._answer(verb, body)
                data = json.dumps(reply).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):   # quiet
                pass

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="extender")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._thread.join(timeout=5.0)
            self._server = None

    def _answer(self, verb: str, body: dict):
        with self._lock:
            self.calls[verb] = self.calls.get(verb, 0) + 1
            if self.record:
                self.payloads.append((verb, body))
        if verb in self.fail:
            return 500, {"error": f"{verb} failed"}
        if verb == "filter":
            names = body["nodenames"]
            return 200, {"nodenames": [n for n in names if crc_keeps(n)],
                         "failedNodes": {n: REASON for n in names
                                         if not crc_keeps(n)}}
        if verb == "prioritize":
            pod = body["pod"]["metadata"]["name"]
            return 200, [{"host": n, "score": crc_score(pod, n)}
                         for n in body["nodenames"]]
        if verb == "bind":
            return 200, {}
        if verb == "preempt":
            return 200, {"nodeNames": sorted(body["nodeNameToVictims"])}
        return 404, {"error": f"unknown verb {verb!r}"}
