"""Hermetic stdlib dev server speaking the minimal object protocol.

``DevObjectServer`` binds a ``ThreadingHTTPServer`` on localhost (port 0
by default — the OS picks a free port), backed by any
:class:`~repro_torch.core.store.StorageBackend` (in-memory by default).  Tests
and benches get a real network hop with zero external dependencies, and
``fail_next(n)`` turns the next ``n`` requests into 503s to exercise the
client's retry path end to end.

Also usable standalone via ``scripts/dev_object_server.py``.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, unquote, urlsplit

from ...core.store import MemoryBackend, NotFoundError, StorageBackend

__all__ = ["DevObjectServer"]

_LIST_PATH = "/__list__"


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "repro-dev-object-server"

    # The server object carries .backend / .take_fault() / .quiet.

    def log_message(self, fmt: str, *args) -> None:  # noqa: A003
        if not getattr(self.server, "quiet", True):  # pragma: no cover
            super().log_message(fmt, *args)

    def _reply(self, status: int, body: bytes = b"") -> None:
        self.send_response(status)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if self.command != "HEAD":
            self.wfile.write(body)

    def _key(self) -> str:
        return unquote(urlsplit(self.path).path.lstrip("/"))

    def _faulted(self) -> bool:
        if self.server.take_fault():
            self._reply(503, b"injected failure\n")
            return True
        return False

    def do_PUT(self) -> None:  # noqa: N802
        if self._faulted():
            return
        length = int(self.headers.get("Content-Length", 0))
        data = self.rfile.read(length)
        self.server.backend.put(self._key(), data)
        self._reply(204)

    def do_GET(self) -> None:  # noqa: N802
        if self._faulted():
            return
        parts = urlsplit(self.path)
        if parts.path == _LIST_PATH:
            prefix = parse_qs(parts.query).get("prefix", [""])[0]
            keys = sorted(self.server.backend.list_keys(prefix))
            self._reply(200, ("\n".join(keys) + "\n").encode("utf-8")
                        if keys else b"")
            return
        try:
            data = self.server.backend.get(self._key())
        except NotFoundError:
            self._reply(404)
            return
        self._reply(200, data)

    def do_HEAD(self) -> None:  # noqa: N802
        if self._faulted():
            return
        self._reply(200 if self.server.backend.exists(self._key()) else 404)

    def do_DELETE(self) -> None:  # noqa: N802
        if self._faulted():
            return
        try:
            self.server.backend.delete(self._key())
        except NotFoundError:
            pass
        self._reply(204)


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, addr, backend: StorageBackend, quiet: bool) -> None:
        super().__init__(addr, _Handler)
        self.backend = backend
        self.quiet = quiet
        self._fault_lock = threading.Lock()
        self._faults_left = 0

    def take_fault(self) -> bool:
        with self._fault_lock:
            if self._faults_left > 0:
                self._faults_left -= 1
                return True
            return False

    def arm_faults(self, n: int) -> None:
        with self._fault_lock:
            self._faults_left = n


class DevObjectServer:
    """Localhost object server for tests, benches and local dev."""

    def __init__(self, backend: Optional[StorageBackend] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 quiet: bool = True) -> None:
        self.backend = backend if backend is not None else MemoryBackend()
        self._server = _Server((host, port), self.backend, quiet)
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    def fail_next(self, n: int) -> None:
        """Make the next ``n`` requests answer 503 (transient)."""
        self._server.arm_faults(n)

    def start(self) -> "DevObjectServer":
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="repro-dev-object-server",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "DevObjectServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
