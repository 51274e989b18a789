"""Model configurations of the port (JAX-free copies of ``repro.configs``)."""
