"""Command-line entry points of the port (``repro/launch`` is the
reference)."""
