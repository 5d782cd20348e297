"""mixedprecisionblockqr_tpu — mixed-precision Block Householder QR in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
jaidonlybbert/MixedPrecisionBlockQR (CUDA/C++/NumPy), running on an NVIDIA
GPU:

* the whole block-QR panel loop runs on-device inside one ``jit`` (the
  reference crosses host<->device 4+ times per panel, ``Cuda/qr.cu:1049-1226``),
* trailing-matrix and Q-accumulation updates are tensor-core GEMMs with a
  configurable dtype policy (bf16 inputs / fp32 accumulation in place of the
  reference's FP16 ``wmma`` path, ``Cuda/mmult.cuh:252-300``),
* the panel factorization is a tall Gram and ``Q = P X`` around an r x r
  triangular Newton-Schulz chain (replacing the reference's host-side
  ``h_householder_qr``, ``Cuda/qr.cu:198``),
* tall-skinny problems use TSQR with a binary reduction tree
  (completes the reference's prototype ``python/ca_qr.py``), extended across a
  ``jax.sharding.Mesh`` via collectives inside ``shard_map``.

Public API (stable):
    qr, block_qr, householder_qr, tsqr, caqr
    lstsq, lstsq_pivoted (QR least-squares; rank-revealing min-norm path)
    rls_init, rls_update, rls_solve (recursive least squares, streaming rows)
    qr_rank1_update, qr_append_row, qr_insert_col, qr_delete_col,
    qr_delete_row (Givens incremental factor updates)
    pivoted_qr (column-pivoted rank-revealing QR)
    DTypePolicy, POLICY_FP32, POLICY_MIXED, POLICY_BF16
    metrics: backward_error, orthogonality_error, lower_trapezoid_error
"""

from mixedprecisionblockqr_tpu.ops.policy import (
    DTypePolicy,
    POLICY_FP32,
    POLICY_MIXED,
    POLICY_MIXED_FAST,
    POLICY_BF16,
    POLICY_FP64,
)
from mixedprecisionblockqr_tpu.ops.householder import (
    householder_reflector,
    householder_qr,
    q_backward_accumulation,
)
from mixedprecisionblockqr_tpu.ops.wy import (
    build_t_matrix,
    wy_representation,
    apply_block_reflector_left_t,
    apply_block_reflector_right,
)
from mixedprecisionblockqr_tpu.ops.blockqr import (
    block_qr,
    block_qr_batched,
    block_qr_qtb,
    block_recursive_qr,
    qr,
)
from mixedprecisionblockqr_tpu.ops.cholqr import cholesky_qr2
from mixedprecisionblockqr_tpu.ops.autodiff import qr_autodiff, make_differentiable_qr
from mixedprecisionblockqr_tpu.ops import metrics
from mixedprecisionblockqr_tpu.ops.givens import (
    givens_qr,
    qr_append_row,
    qr_delete_col,
    qr_delete_row,
    qr_insert_col,
    qr_rank1_update,
)
from mixedprecisionblockqr_tpu.ops.pivoted import (
    numerical_rank,
    pivoted_qr,
    pivoted_qr_qtb,
)
from mixedprecisionblockqr_tpu.utils.checks import checked_qr, NonFiniteError
from mixedprecisionblockqr_tpu.parallel.tsqr import tsqr, tsqr_batched, tsqr_sharded
from mixedprecisionblockqr_tpu.parallel.dist_qr import dist_block_qr
from mixedprecisionblockqr_tpu.parallel.caqr import caqr
from mixedprecisionblockqr_tpu.models.lstsq import (
    lstsq_autodiff,
    back_substitution,
    lstsq,
    lstsq_pivoted,
    rls_init,
    rls_solve,
    rls_update,
    RLSState,
)
from mixedprecisionblockqr_tpu.models.resumable import (
    block_qr_resumable,
    clear_checkpoints,
)

__version__ = "0.1.0"

__all__ = [
    "DTypePolicy",
    "POLICY_FP32",
    "POLICY_MIXED",
    "POLICY_MIXED_FAST",
    "POLICY_BF16",
    "POLICY_FP64",
    "householder_reflector",
    "householder_qr",
    "q_backward_accumulation",
    "build_t_matrix",
    "wy_representation",
    "apply_block_reflector_left_t",
    "apply_block_reflector_right",
    "block_qr",
    "givens_qr",
    "qr_rank1_update",
    "qr_append_row",
    "qr_insert_col",
    "qr_delete_col",
    "qr_delete_row",
    "pivoted_qr",
    "pivoted_qr_qtb",
    "numerical_rank",
    "lstsq_pivoted",
    "block_qr_batched",
    "block_qr_qtb",
    "block_recursive_qr",
    "cholesky_qr2",
    "qr_autodiff",
    "lstsq_autodiff",
    "make_differentiable_qr",
    "dist_block_qr",
    "qr",
    "checked_qr",
    "NonFiniteError",
    "tsqr_batched",
    "metrics",
    "tsqr",
    "tsqr_sharded",
    "caqr",
    "lstsq",
    "back_substitution",
    "rls_init",
    "rls_update",
    "rls_solve",
    "RLSState",
    "block_qr_resumable",
    "clear_checkpoints",
    "__version__",
]
