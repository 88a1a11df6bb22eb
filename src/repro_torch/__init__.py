"""PyTorch/CUDA port of the k²-means clustering library.

Mirrors ``src/repro`` (the JAX reference) module for module. Ported so
far: the single-device f32 fit (``core.api.fit`` with the divisive init
``core.gdi`` and the resident k²-means iteration ``core.engine`` /
``core.k2means``; Lloyd, Elkan and k-means++), the served model's
``predict`` in f32 and int8 and its streaming ``partial_fit`` with
model checkpoints (``core.model``, ``checkpoint``, ``ft.invariants``),
and LM serving with k²-attention over a cluster-major KV cache for the
dense GQA family (``configs``, ``models``, ``launch.serve``). Its seven kernels are
hand-written CUDA C++ for Hopper (``kernels/csrc``), each behind a
wrapper that takes a plain PyTorch version for CPU tensors.

The package imports torch, numpy and the standard library only.
"""
