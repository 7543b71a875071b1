"""HOTSPOT stencil: plain paths (ref, ops) and the K1/K2 CUDA kernels."""
