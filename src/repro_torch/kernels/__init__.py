"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``), each beside
its plain PyTorch version and a launch counter."""
