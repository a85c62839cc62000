"""Serving steps of the port (``repro/serve`` is the reference)."""
