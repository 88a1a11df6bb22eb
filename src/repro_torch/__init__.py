"""PyTorch/CUDA port of the k²-means clustering library.

Mirrors ``src/repro`` (the JAX reference) module for module. The
single-device f32 fit path is ported: frontier-batched divisive init
(``core.gdi``), the resident k²-means iteration (``core.engine``,
``core.k2means``) and the public ``core.api.fit``. Its three kernels
(``kernels.center_knn``, ``kernels.candidate_assign``,
``kernels.segmented_scan``) are hand-written CUDA C++ for Hopper
(``kernels/csrc``), each with a plain PyTorch version that the wrappers
take for CPU tensors.

The package imports torch, numpy and the standard library only.
"""
