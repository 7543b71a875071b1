"""Hand-written Hopper kernels and the plain PyTorch paths around them."""
