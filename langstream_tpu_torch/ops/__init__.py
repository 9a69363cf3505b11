"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``) and their plain
PyTorch versions. Each wrapper launches its kernel for CUDA tensors (or
raises) and takes its plain version only for CPU tensors."""
