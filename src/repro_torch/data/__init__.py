"""Synthetic data with Paxos-leased shards (port of ``repro.data``)."""
