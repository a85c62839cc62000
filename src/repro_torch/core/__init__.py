"""OASiS core on PyTorch: types, dual prices, the Alg. 2 decision core
and the Alg. 1 admission loop."""
