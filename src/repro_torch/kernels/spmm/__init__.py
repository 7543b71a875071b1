"""SPMM: host formats and CC path (ref, ops) and the K3 CUDA kernel."""
