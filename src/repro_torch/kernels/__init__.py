"""Hand-written Hopper kernels of the port, one package each; `build.py`
compiles their CUDA sources at first use."""
