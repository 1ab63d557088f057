"""Readers of the per-layer metrics, found by name: ``<metric>.py``, else
``<the metric's name before its first dot>.py``."""
