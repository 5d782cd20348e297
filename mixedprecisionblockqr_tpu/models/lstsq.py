"""QR-based linear least squares.

Completes the reference's solver layer: the CUDA solver is a skeleton
(``dev_linear_solve`` is an empty kernel, ``Cuda/QR/Solver/solver.cu:34-37``;
``dev_QR_Solver`` allocates but computes nothing, ``solver.cu:39-87``); the
Python version is complete (``linear_least_sqare.py:5-22``): QR factor, apply
Q^T (the reference uses ``pinv(Q)`` — mathematically Q^T for orthonormal Q),
then back-substitution (GVL Alg 5.3.2, cited at ``solver.cu:43-45``).

On device: the QR driver threads b through the panel updates so Q is never
materialized (``block_qr_qtb``); back-substitution is a blocked,
static-shaped triangular solve that keeps the heavy lifting in (r x r)
GEMMs instead of the reference's scalar Python loop.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from mixedprecisionblockqr_tpu.ops.blockqr import block_qr_qtb, DEFAULT_BLOCK_SIZE
from mixedprecisionblockqr_tpu.ops.policy import DTypePolicy, POLICY_FP32
from mixedprecisionblockqr_tpu.parallel.tsqr import tsqr

_HI = jax.lax.Precision.HIGHEST


def back_substitution(
    R: jax.Array, b: jax.Array, lower: bool = False, block_size: int = 64
) -> jax.Array:
    """Public wrapper: gathers mesh-sharded inputs (the solve is tiny and
    replicated) then runs the jitted blocked sweep.

    ``lower`` flips to the upper case HERE, outside the jitted program:
    fusing the double-rev into the same XLA:CPU program as the sweep hits
    an XLA crash ("Invalid binary instruction opcode map",
    hlo_instruction.cc:1585 — jax 0.9.0 CPU backend); as two separate
    programs both compile fine on CPU and GPU alike."""
    from mixedprecisionblockqr_tpu.ops.metrics import _replicate

    R = _replicate(jnp.asarray(R))
    b = _replicate(jnp.asarray(b))
    if lower:
        x = _back_substitution(
            R[::-1, ::-1], b[::-1], lower=False, block_size=block_size
        )
        return x[::-1]
    return _back_substitution(R, b, lower=False, block_size=block_size)


@partial(jax.jit, static_argnames=("lower", "block_size"))
def _back_substitution(
    R: jax.Array, b: jax.Array, lower: bool = False, block_size: int = 64
) -> jax.Array:
    """Blocked triangular solve R x = b (upper by default).

    Behavior of the reference's scalar loop (``linear_least_sqare.py:17-21``):
      x_i = (b_i - sum_{k>i} R_ik x_k) / R_ii
    re-blocked so each diagonal block is solved by a small unrolled masked
    sweep and off-diagonal eliminations are GEMMs.
    """
    n = R.shape[0]
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    R = R.astype(jnp.float32)
    b = b.astype(jnp.float32)
    # lower=True is handled by the PUBLIC wrapper's outside-jit flip —
    # an in-jit recursive flip here is exactly the fused double-rev that
    # crashes XLA:CPU ('Invalid binary instruction opcode map',
    # hlo_instruction.cc:1585; see back_substitution's docstring), so
    # reject it instead of keeping a dead landmine branch.
    assert not lower, "use back_substitution(lower=True) — see docstring"

    r = min(block_size, n)
    nb = -(-n // r)
    x = jnp.zeros_like(b)
    for bi in reversed(range(nb)):
        lo = bi * r
        hi = min(lo + r, n)
        w = hi - lo
        Rbb = R[lo:hi, lo:hi]
        rhs = b[lo:hi, :]
        if hi < n:
            rhs = rhs - jnp.matmul(R[lo:hi, hi:], x[hi:, :], precision=_HI)
        # In-block backward sweep as ONE fori_loop (a Python-unrolled sweep
        # produced O(n) HLO ops and minutes-long compiles at n >= 4096).
        rows_w = jax.lax.broadcasted_iota(jnp.int32, (w, 1), 0)[:, 0]

        def sweep(t, xb):
            i = w - 1 - t
            mask = (rows_w > i).astype(rhs.dtype)          # cols already solved
            ri = jnp.sum(
                jnp.where(rows_w[:, None] == i, Rbb, 0.0), axis=0
            )                                              # row i of Rbb
            acc = jnp.matmul((ri * mask)[None, :], xb, precision=_HI)[0]
            bi = jnp.sum(jnp.where(rows_w[:, None] == i, rhs, 0.0), axis=0)
            dii = jnp.sum(jnp.where(rows_w == i, ri, 0.0))
            xi = (bi - acc) / dii
            return jnp.where(rows_w[:, None] == i, xi[None, :], xb)

        xb = jax.lax.fori_loop(0, w, sweep, jnp.zeros_like(rhs))
        x = x.at[lo:hi, :].set(xb)
    return x[:, 0] if squeeze else x


def lstsq_batched(
    A_batch,
    b_batch,
    block_size: int = DEFAULT_BLOCK_SIZE,
    policy: DTypePolicy = POLICY_FP32,
):
    """Batched least squares over a leading batch axis (vmap; shard the
    batch over a mesh for DP serving — see parallel/batched.py)."""
    from mixedprecisionblockqr_tpu.ops.blockqr import _jitted_driver

    A_batch = jnp.asarray(A_batch, dtype=jnp.float32)
    b_batch = jnp.asarray(b_batch, dtype=jnp.float32)
    squeeze = b_batch.ndim == 2  # (batch, m) -> one RHS per problem
    if squeeze:
        b_batch = b_batch[:, :, None]
    n = A_batch.shape[2]
    fn = _jitted_driver(block_size, policy, False, True)

    @jax.jit
    def run(As, bs):
        R_full, _, qtb = jax.vmap(fn)(As, bs)
        return jax.vmap(
            lambda R, q: _back_substitution(R[:n, :], q[:n, :])
        )(R_full, qtb.astype(jnp.float32))

    x = run(A_batch, b_batch)
    # Only squeeze the RHS axis we added; a (batch, m, k) input keeps all k
    # solution columns.
    return x[:, :, 0] if squeeze else x


def lstsq_pivoted(A, b, rcond: float | None = None):
    """Rank-deficient least squares via column-pivoted QR: the MIN-NORM
    solution (``np.linalg.lstsq`` semantics) through a complete orthogonal
    decomposition.

    ``A P = Q R`` with rank-revealing diagonal decay; rank-k system
    ``R[:k, :] y = (Q^T b)[:k]`` is solved min-norm by factoring
    ``R[:k, :]^T = Z T`` (tall unpivoted QR): ``y = Z T^{-T} c``, then
    ``x[perm] = y``.  The reference's oracle for this path is Eigen's
    ``colPivHouseholderQr().solve`` (``Cuda/QR/Solver/solver.cu:21-32``) —
    which returns the BASIC solution; we return min-norm (strictly
    stronger: same residual, smallest ||x||), matching NumPy/LAPACK gelsd
    semantics that ``python/linear_least_sqare.py`` validates against.
    """
    from mixedprecisionblockqr_tpu.ops.blockqr import qr as _qr
    from mixedprecisionblockqr_tpu.ops.pivoted import (
        numerical_rank,
        pivoted_qr_qtb,
    )

    A = jnp.asarray(A, dtype=jnp.float32)
    b = jnp.asarray(b, dtype=jnp.float32)
    squeeze = b.ndim == 1
    bc = b[:, None] if squeeze else b
    m, n = A.shape
    R, qtb, perm = pivoted_qr_qtb(A, bc)
    k = numerical_rank(R, rcond=rcond, m=m)
    if k == 0:
        x = jnp.zeros((n,) + (() if squeeze else (bc.shape[1],)), jnp.float32)
        return x
    Rk = R[:k, :]                                   # (k, n), full row rank
    c = qtb[:k, :]
    # Complete orthogonal decomposition: Rk^T = Z T (Z (n, k) orthonormal,
    # T (k, k) upper) => Rk = T^T Z^T.  Min-norm y solves T^T w = c
    # (lower-triangular sweep), y = Z w.
    Z, T = _qr(Rk.T, mode="reduced", panel_method="householder")
    w = back_substitution(T.T, c, lower=True)
    y = jnp.matmul(Z, w, precision=_HI)             # (n, nrhs)
    x = jnp.zeros_like(y).at[perm, :].set(y)        # undo the pivoting
    return x[:, 0] if squeeze else x


def lstsq(
    A,
    b,
    block_size: int = DEFAULT_BLOCK_SIZE,
    policy: DTypePolicy = POLICY_FP32,
    method: str = "blocked",
    refine_steps: int = 0,
    panel_method: str = "householder",
    rcond: float | None = None,
    quality: str | None = None,
):
    """Minimize ||A x - b||_2 via QR (the reference's
    ``linear_least_square``, ``python/linear_least_sqare.py:5-22``).

    method='blocked': block QR with b threaded through (no explicit Q).
    method='tsqr': TSQR path for very tall A (m >> n).
    method='pivoted': rank-revealing path (``lstsq_pivoted``) directly.
    panel_method: forwarded to the blocked driver — 'bgs1'/'bgs'/'polar'
        select the Newton-Schulz throughput tiers (solves keep the
        'householder' robust default: x accuracy is kappa-limited and
        solver workloads skew ill-conditioned).
    quality: the speed/quality ladder knob, forwarded to the blocked
        driver (requires panel_method='auto'; see ``qr``) — for solves
        it trades R / Q^T b accuracy, since no Q is materialized.
    refine_steps: iterative-refinement sweeps (solve A dx = r on the SAME
        factorization, x += dx) — recovers solution accuracy on
        ill-conditioned systems where a single fp32/mixed solve is
        kappa-limited; costs one Q^T-apply + triangular solve per sweep.
    rcond: rank-detection cutoff.  When R's diagonal decays below
        ``rcond * max|diag|`` (default eps_f32 * max(m, n)) the plain-QR
        solve is ill-posed (1/R_ii blows up): the solver transparently
        re-routes through the column-pivoted path and returns the MIN-NORM
        solution.  Pass ``rcond=0`` to disable the check.  The reroute
        takes the RQRCP tier (``pivoted_qr_qtb(method='auto')``) at
        n >= 512 and the exact QP3 tier on small/ineligible shapes and as
        the fallback on exactly-singular inputs — paid only on
        rank-deficient inputs.
    """
    A = jnp.asarray(A, dtype=jnp.float32)
    b = jnp.asarray(b, dtype=jnp.float32)
    m, n = A.shape
    if method == "pivoted" or m < n:
        # Underdetermined systems need the min-norm solution (a square R
        # does not exist for plain-QR back-substitution) — np.linalg.lstsq
        # semantics; previously this crashed with an opaque matmul shape
        # error (review finding).
        return lstsq_pivoted(A, b, rcond=rcond)
    if method == "tsqr":
        Q, R = tsqr(A)
        qtb = jnp.matmul(Q.T, b, precision=_HI)
        x = back_substitution(R, qtb)
        for _ in range(refine_steps):
            r = b - jnp.matmul(A, x, precision=_HI)
            dx = back_substitution(R, jnp.matmul(Q.T, r, precision=_HI))
            x = x + dx
        return x
    if refine_steps > 0:
        # Refinement needs a REUSABLE implicit Q: factor once with the
        # stored-factor CAQR path (apply_qt replays the factors per sweep).
        # quality/panel_method select blocked-driver tiers and do not
        # apply here — reject rather than silently ignore (review
        # finding: the quality knob and its validation were bypassed).
        if quality is not None:
            raise ValueError(
                "refine_steps uses the stored-factor CAQR path; the "
                "quality ladder applies to the blocked driver only — "
                "drop quality= or refine_steps="
            )
        from mixedprecisionblockqr_tpu.parallel.caqr import apply_qt, caqr_factor

        factors, Rc = caqr_factor(A, block_size=min(block_size, max(n // 2, 1)))
        if rcond is None or rcond > 0:
            # Same rank-deficiency tripwire as the blocked path below —
            # refinement iterates through 1/R_ii and diverges on tiny
            # pivots just as badly as a single solve (review finding:
            # this path used to bypass the pivoted reroute).
            d = jnp.abs(jnp.diag(Rc[:n, :]))
            tol = (
                float(jnp.finfo(jnp.float32).eps) * max(m, n)
                if rcond is None else rcond
            )
            if float(jnp.min(d)) <= tol * float(jnp.max(d)):
                return lstsq_pivoted(A, b, rcond=rcond)
        squeeze = b.ndim == 1
        bc = b[:, None] if squeeze else b
        x = back_substitution(Rc, apply_qt(factors, bc)[:n, :])
        for _ in range(refine_steps):
            r = bc - jnp.matmul(A, x, precision=_HI)
            x = x + back_substitution(Rc, apply_qt(factors, r)[:n, :])
        return x[:, 0] if squeeze else x
    # check='sync': the solver is host-synchronous anyway (the rank
    # tripwire below fetches diag(R)), so take the transparent
    # robust-retry path on NS-tier breakdowns instead of NaN propagation.
    R, qtb = block_qr_qtb(A, b, block_size=block_size, policy=policy,
                          panel_method=panel_method, quality=quality,
                          check="sync")
    Rn = R[:n, :] if R.shape[0] >= n else R
    if rcond is None or rcond > 0:
        # Rank-deficiency tripwire on the (unpivoted) diagonal: plain QR
        # puts at least one tiny pivot on the diagonal of a rank-deficient
        # R (no guarantee of WHERE, which is why the solve itself must
        # re-route through the pivoted factorization).
        d = jnp.abs(jnp.diag(Rn))
        tol = (
            float(jnp.finfo(jnp.float32).eps) * max(m, n)
            if rcond is None else rcond
        )
        if float(jnp.min(d)) <= tol * float(jnp.max(d)):
            return lstsq_pivoted(A, b, rcond=rcond)
    return back_substitution(Rn, qtb[:n] if qtb.ndim == 1 else qtb[:n, :])


# --------------------------------------------------------------------------
# Recursive least squares (incremental solve for streaming observations).
# --------------------------------------------------------------------------

class RLSState(NamedTuple):
    """Recursive-least-squares state: the (n, n) triangular factor and the
    rotated right-hand side of everything observed so far.  A pure pytree
    — jit/scan/device-resident friendly."""

    R: jax.Array    # (n, n) upper triangular
    qtb: jax.Array  # (n,) or (n, k)


def rls_init(
    A,
    b,
    block_size: int = DEFAULT_BLOCK_SIZE,
    policy: DTypePolicy = POLICY_FP32,
    panel_method: str = "householder",
) -> RLSState:
    """Factor the initial system once (blocked QR, b threaded — no Q
    materialized) and return the streaming state.

    The reference's SLAM workload (``README.md:11-12``) re-factors the
    whole Jacobian per Gauss-Newton iterate; with RLS each new
    measurement row costs O(n²) Givens work instead of the O(mn²)
    refactorization — the standard square-root-information-filter
    formulation of incremental least squares."""
    A = jnp.asarray(A, jnp.float32)
    n = A.shape[1]
    if A.shape[0] < n:
        raise ValueError(
            f"rls_init needs an overdetermined initial system (m >= n), "
            f"got {A.shape}: a square information factor R does not exist "
            "yet — accumulate at least n rows first (or pad with a prior)"
        )
    R, qtb = block_qr_qtb(A, jnp.asarray(b, jnp.float32),
                          block_size=block_size, policy=policy,
                          panel_method=panel_method, check="sync")
    return RLSState(jnp.triu(R[:n, :n]),
                    qtb[:n] if qtb.ndim == 1 else qtb[:n, :])


def rls_update(state: RLSState, rows, betas) -> RLSState:
    """Fold new observation rows into the state: ``rows`` is (n,) or
    (k, n); ``betas`` the matching rhs entries (scalar / (k,) for a
    vector rhs; (k, nb) for a multi-rhs state).  One ``lax.scan`` step
    per row, n pivot rotations each — O(k·n²), no Q anywhere."""
    from mixedprecisionblockqr_tpu.ops.givens import _fold_rows_run

    R = jnp.asarray(state.R, jnp.float32)
    n = R.shape[0]
    rows = jnp.asarray(rows, jnp.float32)
    if rows.ndim == 1:
        rows = rows[None, :]
    k = rows.shape[0]
    qtb = jnp.asarray(state.qtb, jnp.float32)
    squeeze = qtb.ndim == 1
    qtb2 = qtb[:, None] if squeeze else qtb
    betas = jnp.asarray(betas, jnp.float32).reshape(k, -1)
    betas = jnp.broadcast_to(betas, (k, qtb2.shape[1]))
    Raug = jnp.concatenate([R, qtb2], axis=1)
    rows_aug = jnp.concatenate([rows, betas], axis=1)
    Raug = _fold_rows_run(n, Raug.shape[1])(Raug, rows_aug)
    Rp = jnp.triu(Raug[:, :n])
    qtb_p = Raug[:, n:]
    return RLSState(Rp, qtb_p[:, 0] if squeeze else qtb_p)


def rls_solve(state: RLSState, block_size: int = 64) -> jax.Array:
    """Current least-squares solution of everything folded in so far."""
    return back_substitution(state.R, state.qtb, block_size=block_size)


def lstsq_autodiff(
    A: jax.Array,
    b: jax.Array,
    block_size: int = DEFAULT_BLOCK_SIZE,
    policy: DTypePolicy = POLICY_FP32,
):
    """Differentiable least squares: ``x = argmin ||Ax - b||`` with
    reverse-mode gradients in A and b.

    The forward pass runs ``qr_autodiff`` (any blocked driver under a
    custom VJP — ops/autodiff.py) followed by a triangular solve, so the
    whole map is a composition JAX can differentiate: the QR adjoint plus
    the solve's own VJP.  Use inside jitted training/calibration loops
    (e.g. differentiating a Gauss-Newton inner solve w.r.t. Jacobian
    parameters — the bilevel pattern the forward-only ``lstsq`` cannot
    trace).  Requires full column rank (the thin-QR differentiability
    domain); for rank-deficient systems use ``lstsq_pivoted`` (forward
    only).

    Unlike ``lstsq`` this materializes reduced Q (m x n) — gradients need
    it; solve cost is one extra GEMM over the Q-free path.
    """
    from mixedprecisionblockqr_tpu.ops.autodiff import qr_autodiff

    Q, R = qr_autodiff(A, block_size=block_size, policy=policy,
                       panel_method="auto")
    qtb = jnp.matmul(Q.T.astype(jnp.float32), b.astype(jnp.float32),
                     precision=_HI)
    return jax.scipy.linalg.solve_triangular(
        R[: A.shape[1], :].astype(jnp.float32), qtb, lower=False
    )
