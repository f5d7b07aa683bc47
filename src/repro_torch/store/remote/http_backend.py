"""HttpBackend: the KV contract over a minimal HTTP object protocol.

Protocol (what :mod:`repro_torch.store.remote.dev_server` serves, and what a
thin shim in front of any real object store can speak):

- ``PUT /<key>``      store body under key (200/201/204)
- ``GET /<key>``      fetch value (200) or 404
- ``HEAD /<key>``     existence probe (200 / 404)
- ``DELETE /<key>``   remove; 404 is success (idempotent delete)
- ``GET /__list__?prefix=P``  newline-separated keys

Connections are per-thread (``threading.local``) so the scheduler's
concurrent window maps onto parallel sockets; any connection-level
failure or 5xx response surfaces as :class:`TransientError` and the
thread's connection is dropped so the retry reconnects cleanly.
"""

from __future__ import annotations

import http.client
import socket
import threading
from typing import List, Optional
from urllib.parse import quote, unquote, urlsplit

from .base import RemoteBackend
from .scheduler import TransientError

__all__ = ["HttpBackend"]

_LIST_PATH = "/__list__"


class HttpBackend(RemoteBackend):
    """Speak the minimal object protocol against ``base_url``."""

    def __init__(self, base_url: str, timeout: float = 10.0, **kwargs) -> None:
        super().__init__(**kwargs)
        parts = urlsplit(base_url)
        if parts.scheme not in ("http", "https"):
            raise ValueError(f"HttpBackend needs an http(s) URL, got {base_url!r}")
        if not parts.netloc:
            raise ValueError(f"URL has no host: {base_url!r}")
        self.base_url = base_url.rstrip("/")
        self._scheme = parts.scheme
        self._netloc = parts.netloc
        self._root = parts.path.rstrip("/")
        self.timeout = timeout
        self._local = threading.local()

    # -- connection management ---------------------------------------------

    def _conn(self) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            cls = (http.client.HTTPSConnection if self._scheme == "https"
                   else http.client.HTTPConnection)
            conn = cls(self._netloc, timeout=self.timeout)
            self._local.conn = conn
        return conn

    def _drop_conn(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            try:
                conn.close()
            except Exception:
                pass
            self._local.conn = None

    def _path(self, key: str) -> str:
        return f"{self._root}/{quote(key, safe='')}"

    def _request(self, method: str, path: str,
                 body: Optional[bytes] = None) -> "http.client.HTTPResponse":
        """One request/response; transport failures and 5xx become
        :class:`TransientError` (retryable), with a clean reconnect."""
        try:
            conn = self._conn()
            conn.request(method, path, body=body)
            resp = conn.getresponse()
        except (http.client.HTTPException, ConnectionError, socket.timeout,
                OSError) as exc:
            self._drop_conn()
            raise TransientError(f"{method} {path}: {exc}") from exc
        if resp.status >= 500:
            resp.read()  # drain so the connection stays usable
            raise TransientError(f"{method} {path}: HTTP {resp.status}")
        return resp

    # -- raw primitives -----------------------------------------------------

    def _raw_put(self, key: str, data: bytes) -> None:
        resp = self._request("PUT", self._path(key), body=data)
        resp.read()
        if resp.status not in (200, 201, 204):
            raise RuntimeError(f"PUT {key}: HTTP {resp.status}")

    def _raw_get(self, key: str) -> Optional[bytes]:
        resp = self._request("GET", self._path(key))
        body = resp.read()
        if resp.status == 404:
            return None
        if resp.status != 200:
            raise RuntimeError(f"GET {key}: HTTP {resp.status}")
        return body

    def _raw_exists(self, key: str) -> bool:
        resp = self._request("HEAD", self._path(key))
        resp.read()
        if resp.status == 200:
            return True
        if resp.status == 404:
            return False
        raise RuntimeError(f"HEAD {key}: HTTP {resp.status}")

    def _raw_delete(self, key: str) -> None:
        resp = self._request("DELETE", self._path(key))
        resp.read()
        # 404 is success: delete is idempotent so retry replay never raises.
        if resp.status not in (200, 204, 404):
            raise RuntimeError(f"DELETE {key}: HTTP {resp.status}")

    def _raw_list_keys(self, prefix: str = "") -> List[str]:
        path = f"{self._root}{_LIST_PATH}?prefix={quote(prefix, safe='')}"
        resp = self._request("GET", path)
        body = resp.read()
        if resp.status != 200:
            raise RuntimeError(f"LIST {prefix!r}: HTTP {resp.status}")
        text = body.decode("utf-8")
        return [unquote(line) for line in text.splitlines() if line]
