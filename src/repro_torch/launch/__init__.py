"""Step builders (port of ``repro.launch.steps``; the mesh, dry-run and
roofline modules are not ported yet)."""
