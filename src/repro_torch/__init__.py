"""PyTorch/CUDA port of the nonlinear time-history analysis (``repro``).

Same layout and public shapes as the JAX package it is held against; the
hot spots are hand-written CUDA kernels for Hopper (``csrc/``) bound with
ctypes, each beside its plain PyTorch version.  This package imports
neither JAX nor the JAX package.
"""
