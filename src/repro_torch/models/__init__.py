"""The model zoo of the port: configuration, blocks, the decoder-only LM,
its registry, and the weight converter from the JAX reference."""
