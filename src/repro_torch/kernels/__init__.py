"""The port's kernels: hand-written CUDA C++ for Hopper (``csrc/``), each
behind a PyTorch wrapper that launches it on CUDA tensors and takes its
plain PyTorch version (``ref``) on CPU tensors."""
