"""Receiver select network: the ``paxos_apply`` CUDA kernel and its
replica step (:mod:`.ops`)."""
