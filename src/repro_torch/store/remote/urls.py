"""URL -> backend resolution for ``Platform.open`` and the CLI.

- ``memory://``            fresh in-memory backend
- ``file:///abs/path``     directory-backed backend
- ``http://host:port[/p]`` remote object server (:class:`HttpBackend`)

``memory://`` and ``file://`` URLs accept simulation query parameters —
``?rtt=0.05&jitter=0.01&tail_every=10&tail=0.2&...`` — which wrap the
backend in a :class:`SimulatedRemoteBackend`, so a checkout against a
"50 ms object store" is one URL away:

    repro-cli --repo 'memory://?rtt=0.05' ...
"""

from __future__ import annotations

from urllib.parse import parse_qs, urlsplit

from ...core.store import FileBackend, MemoryBackend, StorageBackend
from .http_backend import HttpBackend
from .simulated import SimulatedRemoteBackend

__all__ = ["backend_from_url", "is_backend_url"]

_FLOAT_PARAMS = ("rtt", "bandwidth", "jitter", "tail", "fault_rate")
_INT_PARAMS = ("tail_every", "fault_every", "seed")
_SIM_PARAMS = set(_FLOAT_PARAMS) | set(_INT_PARAMS) | {"fault_mode", "grouped"}


def is_backend_url(spec: str) -> bool:
    """True when ``spec`` looks like a backend URL rather than a path."""
    return "://" in spec


def _sim_kwargs(query: str) -> dict:
    kwargs: dict = {}
    for name, values in parse_qs(query).items():
        if name not in _SIM_PARAMS:
            raise ValueError(f"unknown backend URL parameter {name!r}")
        value = values[-1]
        if name in _FLOAT_PARAMS:
            kwargs[name] = float(value)
        elif name in _INT_PARAMS:
            kwargs[name] = int(value)
        elif name == "grouped":
            kwargs[name] = value.lower() not in ("0", "false", "no")
        else:
            kwargs[name] = value
    return kwargs


def backend_from_url(url: str) -> StorageBackend:
    """Open a storage backend from a ``scheme://`` URL."""
    parts = urlsplit(url)
    scheme = parts.scheme
    if scheme in ("http", "https"):
        return HttpBackend(url)
    if scheme == "memory":
        inner: StorageBackend = MemoryBackend()
    elif scheme == "file":
        path = (parts.netloc + parts.path) if parts.netloc else parts.path
        if not path:
            raise ValueError(f"file:// URL has no path: {url!r}")
        inner = FileBackend(path)
    else:
        raise ValueError(
            f"unsupported backend URL scheme {scheme!r} "
            f"(expected memory://, file:// or http(s)://): {url!r}")
    sim = _sim_kwargs(parts.query)
    if sim:
        return SimulatedRemoteBackend(inner, **sim)
    return inner
