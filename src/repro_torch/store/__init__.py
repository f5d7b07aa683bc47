"""Storage backends beyond the in-process core (see ``repro_torch.core.store``
for the engine itself).  Currently: :mod:`repro_torch.store.remote`."""

from .remote import (
    DevObjectServer,
    GroupedScheduler,
    HttpBackend,
    RemoteBackend,
    SimulatedRemoteBackend,
    TransientError,
    backend_from_url,
    is_backend_url,
)

__all__ = [
    "DevObjectServer",
    "GroupedScheduler",
    "HttpBackend",
    "RemoteBackend",
    "SimulatedRemoteBackend",
    "TransientError",
    "backend_from_url",
    "is_backend_url",
]
