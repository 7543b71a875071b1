"""SSD (Mamba2) chunked scan: the plain version (ref) and the K5 CUDA kernel."""
