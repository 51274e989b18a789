"""Checkpoints: numpy ``.npz`` trees committed through the replicated
register (copy of ``repro.checkpoint``, without JAX)."""
