"""Drivers of the port (ported so far: ``serve`` and ``train``)."""
