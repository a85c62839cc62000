"""Flash attention (forward): the CUDA kernel (``kernel.py``), its naive
oracle (``ref.py``) and the entry the model calls (``ops.py``)."""
