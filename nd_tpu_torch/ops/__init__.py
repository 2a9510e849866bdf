"""Array operations on torch tensors; ``*_cuda`` modules hold the CUDA
kernels' wrappers and their plain PyTorch versions."""
