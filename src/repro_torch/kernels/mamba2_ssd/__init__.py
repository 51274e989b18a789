"""Mamba2 SSD: the CUDA kernel's wrapper and its plain versions
(:mod:`.ops`)."""
