"""PyTorch/CUDA port of the k²-means clustering library.

Mirrors ``src/repro`` (the JAX reference) module for module. Ported so
far: the single-device fit (``core.api.fit`` with the divisive init
``core.gdi`` and the resident k²-means iteration ``core.engine`` /
``core.k2means`` on an f32 or an int8 arena; Lloyd, Elkan and
k-means++) with fault injection, guards, self-healing and mid-fit
checkpoints (``ft``), the served model's ``predict`` in f32 and int8 and
its streaming ``partial_fit`` with model checkpoints (``core.model``,
``checkpoint``), the serving executor (``serve``), and LM serving with
k²-attention over a cluster-major KV cache for the dense GQA family
(``configs``, ``models``, ``launch.serve``). Its seven kernels are
hand-written CUDA C++ for Hopper (``kernels/csrc``), each behind a
wrapper that takes a plain PyTorch version for CPU tensors.

The package imports torch, numpy and the standard library only.
"""
