"""Protocol core of the port: scalar handlers and machines (copied from
``repro.core``) plus the PyTorch SIMD engines (``vector``,
``proposer_vector``)."""
