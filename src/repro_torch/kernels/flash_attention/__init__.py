"""Flash attention: the oracle (ref), the plain version and the K4 CUDA kernel."""
