"""Logical-axis sharding over a mesh (port of ``repro.parallel``)."""
