"""CUDA sweep kernels, their plain PyTorch versions and the host plans."""
