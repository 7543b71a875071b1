"""Depthwise causal conv, bias and SiLU: the plain chain and its CUDA kernel."""
