"""One reader per per-layer metric, ``<metric name>.py``, loaded by path."""
