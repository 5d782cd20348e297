"""Parallel/distributed execution: device meshes, TSQR/CAQR, sharded QR.

The reference is single-GPU (no NCCL/MPI anywhere; host<->device ``cudaMemcpy``
only).  Its TSQR NumPy prototype (``python/ca_qr.py``) is the mathematical
seed for everything here: row-sharded tall-skinny QR with a binary reduction
tree, executed across a ``jax.sharding.Mesh`` via XLA collectives inside
``shard_map``.
"""

from mixedprecisionblockqr_tpu.parallel import batched, caqr, dist_qr, dist_qr2d, mesh, tsqr

__all__ = ["batched", "caqr", "dist_qr", "dist_qr2d", "mesh", "tsqr"]
