"""The fault-tolerant training loop (port of ``repro.train``)."""
