"""Issuer select network: the ``paxos_propose`` CUDA kernel and its issuer
step (:mod:`.ops`)."""
