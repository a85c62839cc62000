"""Banded min-plus (tropical) DP sweep: plain version, CUDA kernel and
the device dispatch between them."""
