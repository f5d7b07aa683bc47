"""Drivers and launch policies of the port: ``serve``, ``train``, ``mesh``,
``specs`` and ``presets``."""
