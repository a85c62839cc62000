"""Mamba2 SSD chunk scan: the CUDA kernel (``kernel.py``), its
sequential oracle (``ref.py``) and that oracle in the model's layout
(``ops.py``)."""
