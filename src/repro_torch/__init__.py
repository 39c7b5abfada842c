"""PyTorch/CUDA port of the iFDK reconstruction package (`repro`).

The layout mirrors `src/repro/` file for file; each ported module names its
reference. This package imports `torch` and numpy only — never JAX and
nothing of `repro`. Entry points run on the CUDA card unless the caller
passes ``device="cpu"``.
"""
