"""Hand-written CUDA kernels of the port and their wrappers.

Each wrapper dispatches on the device of the tensors it is given: a CPU
tensor takes the kernel's plain PyTorch version, a CUDA tensor launches
the kernel (built from ``csrc/`` by :mod:`._build`) or raises.  Each
wrapper counts its kernel launches in a plain integer attribute,
``launches``.
"""
