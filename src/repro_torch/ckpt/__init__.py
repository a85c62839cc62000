"""Integrity-checked checkpoints of parameter trees (``checkpoint``)."""
