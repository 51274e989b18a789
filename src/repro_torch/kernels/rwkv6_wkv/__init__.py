"""RWKV6 WKV: the CUDA kernel's wrapper and its plain versions
(:mod:`.ops`)."""
