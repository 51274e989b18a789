"""Step builders and their shardings, meshes, the roofline and the dry
run (port of ``repro.launch``)."""
