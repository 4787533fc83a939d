"""PyTorch/CUDA port of the QuIP serving path (the JAX package ``repro``
is the reference).  Imports torch and numpy, never JAX or ``repro``."""
