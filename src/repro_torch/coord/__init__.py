"""Coordination service over the replicated register (copy of
``repro.coord``)."""
