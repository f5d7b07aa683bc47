"""Remote object-storage subsystem: latency-aware backends, a pipelined
+ hedged grouped-I/O scheduler, and URL-based backend resolution.

See :mod:`repro_torch.store.remote.scheduler` for the I/O model and
:mod:`repro_torch.store.remote.simulated` for the hermetic testbed.
"""

from .base import RemoteBackend
from .dev_server import DevObjectServer
from .http_backend import HttpBackend
from .scheduler import GroupedScheduler, TransientError
from .simulated import SimulatedRemoteBackend
from .urls import backend_from_url, is_backend_url

__all__ = [
    "RemoteBackend",
    "DevObjectServer",
    "HttpBackend",
    "GroupedScheduler",
    "TransientError",
    "SimulatedRemoteBackend",
    "backend_from_url",
    "is_backend_url",
]
