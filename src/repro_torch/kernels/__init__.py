"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

Each kernel package follows the JAX package's three-file convention:
``kernel.py`` (launch wrapper of the CUDA source in ``csrc/``, with its
launch count), ``ops.py`` (the public wrapper: dispatch by device, padding
and epilogues) and ``ref.py`` (the plain PyTorch version).  A CUDA tensor
always goes to the kernel; only a CPU tensor takes the plain version.
"""
