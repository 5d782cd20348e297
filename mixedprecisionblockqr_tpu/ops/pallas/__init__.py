"""GPU kernels (Pallas on Triton) — the hand-written analog of the
reference's CUDA kernel layer (``Cuda/mmult.cu``/``mmult.cuh``).

One kernel: the r x r triangular Newton-Schulz chain (``ns.ns_chain``),
the one piece of a panel factorization XLA cannot fuse.  Everything else
(GEMMs, Grams, Householder panels, pivot selection) is plain JAX that XLA
compiles.  Tests run the kernel with ``interpret=True`` on a CPU.
"""

from mixedprecisionblockqr_tpu.ops.pallas.ns import ns_chain

__all__ = ["ns_chain"]
