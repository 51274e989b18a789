"""PyTorch/CUDA port of the replicated RMW-register KV store.

Mirrors the layout of the JAX package ``repro`` module for module (so
``repro_torch/core/vector.py`` is the counterpart of
``repro/core/vector.py``) and keeps every plane's field order and count,
so planes compare by index across the two packages.  The port imports
``torch``, ``numpy`` and the standard library only; its two hand-written
CUDA kernels (``csrc/paxos_apply.cu``, ``csrc/paxos_propose.cu``) replace
the Pallas kernels of the reference and build with ``nvcc`` at first use
(:mod:`repro_torch.kernels._build`).

Entry points take ``device=None``, meaning ``"cuda"``; without a card they
raise unless the caller asks for ``"cpu"`` explicitly
(:func:`repro_torch.device.resolve_device`).
"""
