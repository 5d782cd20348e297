"""Givens-rotation QR — the reference paper's alternative to Householder.

The reference derives Givens rotations alongside Householder reflections as
the two unitary eliminations for QR (``LaTeX/QR_Decomposition.tex``, Givens
section: c = x_i/r, s = -x_j/r pairs zeroing one entry at a time) but never
implements them.  This module supplies a vectorized implementation:

  * ``givens_rotation(a, b)`` — the (c, s) pair with the same convention as
    the paper (post-rotation second component = 0), guarded for b = 0.
  * ``givens_qr(A)`` — QR by column-wise elimination.  Instead of the
    paper's one-rotation-per-entry sequential sweep (O(mn) tiny dependent
    steps), each column is zeroed by a LOG-DEPTH pairwise
    elimination tree: rows are paired (stride 1, 2, 4, ...) and every pair
    is rotated SIMULTANEOUSLY as one vectorized row-pair update — the same
    communication-avoiding tree shape as TSQR (``parallel/tsqr.py``), so a
    column costs ceil(log2(m)) full-width vectorized steps rather than m-1
    dependent scalar steps.

Numerically Givens QR is unconditionally stable (each step is exactly
orthogonal), like the Householder path; it exists for parity and for
structured updates (e.g. rank-1 R updates) where rotations touch only two
rows.  For dense factorization the blocked drivers remain the fast path.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST


def givens_rotation(a: jax.Array, b: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """(c, s) with ``[[c, -s], [s, c]] [a; b] = [r; 0]`` (paper convention:
    c = a/r, s = -b/r with r = hypot(a, b)); (1, 0) when b == 0."""
    r = jnp.hypot(a, b)
    safe = r > 0
    rs = jnp.where(safe, r, 1.0)
    return jnp.where(safe, a / rs, 1.0), jnp.where(safe, -b / rs, 0.0)


def _eliminate_column(R: jax.Array, Q: jax.Array, k: int):
    """Zero R[k+1:, k] by a log-depth pairwise rotation tree.

    At stride s, row k+j (j in [1, s]) eliminates row k+j+s: disjoint row
    pairs, so all rotations at one stride apply as a single gather/rotate
    of full rows (vectorized over pairs AND columns).
    """
    import numpy as np  # static index construction (shapes fixed per step)

    m = R.shape[0]
    s = 1
    while k + s < m:
        # Binary-reduction pairing: surviving rows after level s are
        # k + multiples of 2s; each leader lo eliminates lo + s.  Pairs
        # are disjoint, so one vectorized two-row rotation per level.
        lo = np.arange(k, m, 2 * s)
        hi = lo + s
        keep = hi < m
        lo = jnp.asarray(lo[keep])
        hi = jnp.asarray(hi[keep])
        c, sn = givens_rotation(R[lo, k], R[hi, k])
        # Vectorized two-row rotation: rows_lo' = c*lo - s*hi; rows_hi' =
        # s*lo + c*hi  (G^T with G = [[c, s], [-s, c]] per pair).
        Rlo, Rhi = R[lo, :], R[hi, :]
        R = R.at[lo, :].set(c[:, None] * Rlo - sn[:, None] * Rhi)
        R = R.at[hi, :].set(sn[:, None] * Rlo + c[:, None] * Rhi)
        Qlo, Qhi = Q[lo, :], Q[hi, :]
        Q = Q.at[lo, :].set(c[:, None] * Qlo - sn[:, None] * Qhi)
        Q = Q.at[hi, :].set(sn[:, None] * Qlo + c[:, None] * Qhi)
        s *= 2
    return R, Q


from functools import lru_cache


def _eliminate_column_masked(R: jax.Array, Q: jax.Array, k: jax.Array):
    """Zero R[k+1:, k] for a RUNTIME column index ``k``: the same log-depth
    pairwise rotation tree as ``_eliminate_column``, but with dynamic
    (traced) gather indices and identity-masked out-of-range pairs, so ONE
    compiled program serves every column.  Levels are the static
    ceil(log2(m)) worst case; pairs past the live range gather from
    clamped indices (their rotation is masked to identity) and scatter
    back through the UNCLAMPED out-of-bounds index under ``mode='drop'``
    — a clamped scatter would collide with a valid pair's write to row
    m-1 and clobber it nondeterministically.
    """
    m = R.shape[0]
    s = 1
    while s < m:
        npairs = (m + 2 * s - 1) // (2 * s)  # static per level
        i = jnp.arange(npairs)
        lo = k + 2 * s * i
        hi = lo + s
        valid = hi < m  # hi > lo, so this bounds lo too
        lo_c = jnp.minimum(lo, m - 1)
        hi_c = jnp.minimum(hi, m - 1)
        colk = jax.lax.dynamic_slice(R, (jnp.zeros_like(k), k), (m, 1))[:, 0]
        c, sn = givens_rotation(colk[lo_c], colk[hi_c])
        c = jnp.where(valid, c, 1.0)
        sn = jnp.where(valid, sn, 0.0)
        Rlo, Rhi = R[lo_c, :], R[hi_c, :]
        R = R.at[lo, :].set(c[:, None] * Rlo - sn[:, None] * Rhi,
                            mode="drop")
        R = R.at[hi, :].set(sn[:, None] * Rlo + c[:, None] * Rhi,
                            mode="drop")
        Qlo, Qhi = Q[lo_c, :], Q[hi_c, :]
        Q = Q.at[lo, :].set(c[:, None] * Qlo - sn[:, None] * Qhi,
                            mode="drop")
        Q = Q.at[hi, :].set(sn[:, None] * Qlo + c[:, None] * Qhi,
                            mode="drop")
        s *= 2
    return R, Q


@lru_cache(maxsize=None)
def _givens_run_scan(m: int, k: int):
    """Scan-mode program: ``lax.fori_loop`` over columns with the masked
    dynamic-index tree — program size O(log m) independent of n, so it
    compiles at the flagship scales where the unrolled program (one traced
    tree per column, ~quadratic growth) cannot.  ~2x the unrolled path's
    gather work (full-height index ranges every column instead of the
    shrinking k: suffix), same unconditional stability."""

    @jax.jit
    def run(A):
        R = A
        Q = jnp.eye(m, dtype=jnp.float32)

        def body(kk, carry):
            R, Q = carry
            return _eliminate_column_masked(R, Q, kk)

        R, Q = jax.lax.fori_loop(0, k, body, (R, Q))
        return Q.T, jnp.triu(R)

    return run


@lru_cache(maxsize=None)
def _givens_run(m: int, k: int):
    """Shape-specialized jitted elimination program.  Module-level cache:
    defining-and-jitting inside ``givens_qr`` retraced on every call (the
    jit cache died with the closure), and the statically unrolled
    ~n*ceil(log2 m) rotation levels make each retrace expensive (round-2
    ADVICE item 4).  Practical ceiling: program size grows ~quadratically
    with (m, n) — past ~512^2 ``loop_mode='auto'`` switches to
    ``_givens_run_scan``; dense factorization belongs to the blocked
    drivers either way."""

    @jax.jit
    def run(A):
        R = A
        Q = jnp.eye(m, dtype=jnp.float32)
        for kk in range(k):
            R, Q = _eliminate_column(R, Q, kk)
        return Q.T, jnp.triu(R)

    return run


def givens_qr(A, mode: str = "reduced", loop_mode: str = "auto"):
    """QR by vectorized Givens elimination trees (one per column).

    Returns (Q, R) like ``householder_qr``: reduced -> (m x k, k x n),
    complete -> (m x m, m x n), k = min(m, n).

    ``loop_mode``: 'unroll' traces one static-index tree per column
    (fastest, but program size grows ~quadratically with (m, n) — the
    ~512^2-class ceiling); 'scan' runs ONE masked dynamic-index tree in a
    ``fori_loop`` (O(log m) program, compiles at any size); 'auto' picks
    'unroll' within the documented ceiling and 'scan' past it — mirroring
    ``block_qr``'s unroll/scan split.
    """
    A = jnp.asarray(A, dtype=jnp.float32)
    m, n = A.shape
    k = min(m, n)

    if loop_mode == "auto":
        loop_mode = "unroll" if m <= 512 and k <= 512 else "scan"
    if loop_mode not in ("unroll", "scan"):
        raise ValueError(f"unknown loop_mode {loop_mode!r}")
    runner = _givens_run if loop_mode == "unroll" else _givens_run_scan
    Q, R = runner(m, k if m > k else k - 1)(A)
    if mode == "reduced":
        return Q[:, :k], R[:k, :]
    if mode == "complete":
        return Q, R
    raise ValueError(f"unknown mode {mode!r}")


def _rot_rows(X: jax.Array, i, c, s):
    """Apply ``[[c, -s], [s, c]]`` to rows (i, i+1) of X (dynamic i)."""
    two = jax.lax.dynamic_slice(X, (i, jnp.zeros_like(i)), (2, X.shape[1]))
    lo, hi = two[0:1, :], two[1:2, :]
    new = jnp.concatenate([c * lo - s * hi, s * lo + c * hi], axis=0)
    return jax.lax.dynamic_update_slice(X, new, (i, jnp.zeros_like(i)))


def qr_rank1_update(Q, R, u, v):
    """Rank-1 QR update: given complete-mode ``A = Q R``, return (Q', R')
    with ``A + u vᵀ = Q' R'`` in O(mn) work — the Givens primitive the
    factorization-level drivers cannot match (a fresh blocked QR costs
    O(mn²)).  Downdate by passing ``-u`` (or ``-v``).

    Golub & Van Loan §12.5.1: with w = Qᵀu, a bottom-up chain of m−1
    adjacent-row rotations J maps w → ‖w‖e₁ while filling exactly one
    subdiagonal of R (upper Hessenberg); adding ``(Jᵀw)₀ · e₀vᵀ`` touches
    only row 0, and a top-down chain of min(m−1, n) rotations
    re-triangularizes.  Both chains run as ``lax.fori_loop`` over
    dynamic two-row slices (each rotation is a 2×n elementwise update; the
    sequential chain is inherent to the algorithm, not the
    implementation).  This is the incremental-solve primitive for the
    reference's SLAM least-squares workload (``README.md:11-12``): a new
    observation row / Jacobian perturbation re-solves in O(mn) instead of
    refactoring.

    Args:
        Q: (m, m) orthogonal (complete mode — a reduced m×k Q cannot
           represent the component of u outside range(Q)).
        R: (m, n) upper triangular (complete-mode R).
        u: (m,) or (m, 1); v: (n,) or (n, 1).

    Returns:
        (Q', R') with the same shapes, Q' orthogonal, R' upper triangular.
    """
    Q = jnp.asarray(Q, jnp.float32)
    R = jnp.asarray(R, jnp.float32)
    u = jnp.asarray(u, jnp.float32).reshape(-1)
    v = jnp.asarray(v, jnp.float32).reshape(-1)
    m, n = R.shape
    if Q.shape != (m, m):
        raise ValueError(
            f"qr_rank1_update needs the complete-mode factors: Q {Q.shape} "
            f"vs R {R.shape} (use mode='complete')"
        )
    return _rank1_run(m, n)(Q, R, u, v)


@lru_cache(maxsize=None)
def _rank1_run(m: int, n: int):
    """ONE compiled rank-1-update program per shape (the module-level
    cache pattern of ``_fold_rows_run``/``_givens_run``): a per-call inner
    ``@jax.jit`` retraced every invocation — measured ~4.5 s PER CALL on
    CPU at 48x32 — on the streaming primitive that exists precisely to be
    called once per observation."""

    @jax.jit
    def run(Q, R, u, v):
        w = jnp.matmul(Q.T, u[:, None], precision=_HI)[:, 0]

        def sweep_up(t, carry):
            # zero w[i+1] into w[i], bottom-up: i = m-2 .. 0
            w, R, Qt = carry
            i = m - 2 - t
            c, s = givens_rotation(w[i], w[i + 1])
            wi = c * w[i] - s * w[i + 1]
            w = w.at[i].set(wi).at[i + 1].set(0.0)
            return w, _rot_rows(R, i, c, s), _rot_rows(Qt, i, c, s)

        # Rotations apply LEFT of R, so Q absorbs their transposes on the
        # RIGHT: track Qᵀ and rotate its ROWS with the same coefficients.
        w, R, Qt = jax.lax.fori_loop(
            0, m - 1, sweep_up, (w, R, Q.T), unroll=4
        )
        # R is now upper Hessenberg; the update lands entirely in row 0.
        R = R.at[0, :].add(w[0] * v)

        def sweep_down(i, carry):
            # re-triangularize: zero H[i+1, i], top-down
            R, Qt = carry
            col = jax.lax.dynamic_slice(R, (i, i), (2, 1))
            c, s = givens_rotation(col[0, 0], col[1, 0])
            return _rot_rows(R, i, c, s), _rot_rows(Qt, i, c, s)

        R, Qt = jax.lax.fori_loop(
            0, min(m - 1, n), sweep_down, (R, Qt), unroll=4
        )
        # Exact triangularity: the zeroed subdiagonal carries roundoff.
        return Qt.T, jnp.triu(R)

    return run


@lru_cache(maxsize=None)
def _fold_rows_run(n_pivots: int, width: int):
    """Jitted core shared by ``qr_append_row`` and the recursive-least-
    squares driver (``models/lstsq.py``): fold a BATCH of new rows into an
    augmented triangular factor, one ``lax.scan`` step per row, n pivot
    rotations per step.  Triangularity is preserved exactly (each
    rotation only mixes row i with a row whose first i entries are
    already zero)."""

    @jax.jit
    def run(Raug, rows):  # Raug (n_pivots, width); rows (k, width)
        def fold(Raug, arow):
            def body(i, carry):
                Raug, arow = carry
                # Zero the new row's i-th entry against the pivot R[i, i].
                rii = jax.lax.dynamic_slice(Raug, (i, i), (1, 1))[0, 0]
                c, s = givens_rotation(rii, arow[i])
                Ri = jax.lax.dynamic_slice(
                    Raug, (i, jnp.zeros_like(i)), (1, width)
                )[0]
                new_Ri = c * Ri - s * arow
                arow = s * Ri + c * arow
                Raug = jax.lax.dynamic_update_slice(
                    Raug, new_Ri[None, :], (i, jnp.zeros_like(i))
                )
                return Raug, arow

            Raug, _ = jax.lax.fori_loop(
                0, n_pivots, body, (Raug, arow), unroll=4
            )
            return Raug, None

        Raug, _ = jax.lax.scan(fold, Raug, rows)
        return Raug

    return run


def qr_append_row(R, a, qtb=None, beta=None):
    """Append an observation row to a triangular factor: given the R of
    ``A = QR`` (n×n upper) return the R' of ``[A; aᵀ]`` in O(n²) — the
    incremental-least-squares primitive for the reference's SLAM workload
    (``README.md:11-12``: each new measurement adds Jacobian rows; a full
    refactorization costs O(mn²)).  No Q is needed: n Givens rotations
    fold the new row into R one pivot at a time, and the same rotations
    applied to the augmented column keep ``Qᵀb`` current.

    Args:
        R: (n, n) upper triangular.
        a: (n,) the new matrix row.
        qtb: optional (n,) or (n, k) current ``Qᵀb``; requires ``beta``.
        beta: optional scalar or (k,) new rhs entry (b's new element).

    Returns:
        R' alone, or (R', qtb') when ``qtb`` is given — both of the SAME
        shape (the appended row's residual component drops out of the
        square factor, exactly like LAPACK's sequential ``*qrupdate``
        usage in recursive least squares).
    """
    R = jnp.asarray(R, jnp.float32)
    a = jnp.asarray(a, jnp.float32).reshape(-1)
    n = R.shape[0]
    if R.shape != (n, n) or a.shape != (n,):
        raise ValueError(f"qr_append_row: R {R.shape} must be square and "
                         f"match a {a.shape}")
    with_b = qtb is not None
    if with_b:
        qtb = jnp.asarray(qtb, jnp.float32)
        squeeze = qtb.ndim == 1
        qtb2 = qtb[:, None] if squeeze else qtb
        brow = jnp.broadcast_to(
            jnp.asarray(beta, jnp.float32).reshape(-1), (qtb2.shape[1],)
        )
        Raug = jnp.concatenate([R, qtb2], axis=1)
        arow = jnp.concatenate([a, brow])
    else:
        Raug, arow = R, a

    Raug = _fold_rows_run(n, Raug.shape[1])(Raug, arow[None, :])
    if not with_b:
        return jnp.triu(Raug)
    Rp = jnp.triu(Raug[:, :n])
    qtb_p = Raug[:, n:]
    return Rp, (qtb_p[:, 0] if squeeze else qtb_p)


def qr_delete_col(Q, R, k):
    """Delete column ``k`` of the factored matrix: given complete-mode
    ``A = Q R``, return (Q', R') with ``A-minus-column-k = Q' R'`` in
    O((n-k) m) — the scipy ``qr_delete(..., which='col')`` counterpart.

    Removing R's column k leaves columns k.. with one subdiagonal entry
    each (upper Hessenberg); a top-down chain of n-k-1 adjacent-row
    rotations re-triangularizes (GVL §12.5.2).  ``k`` may be a traced
    value: the chain runs full-length with identity rotations below k
    (``givens_rotation(x, 0) = (1, 0)`` exactly, and rows < k already
    carry a zero subdiagonal).

    Args:
        Q: (m, m) orthogonal; R: (m, n) upper triangular; k: int in [0, n).

    Returns:
        (Q' (m, m), R' (m, n-1)).
    """
    Q = jnp.asarray(Q, jnp.float32)
    R = jnp.asarray(R, jnp.float32)
    m, n = R.shape
    if Q.shape != (m, m):
        raise ValueError(
            f"qr_delete_col needs complete-mode factors: Q {Q.shape} vs "
            f"R {R.shape}"
        )
    k = jnp.asarray(k, jnp.int32)
    return _delete_col_run(m, n)(Q, R, k)


@lru_cache(maxsize=None)
def _delete_col_run(m: int, n: int):
    @jax.jit
    def run(Q, R, k):
        idx = jnp.arange(n - 1, dtype=jnp.int32)
        Rd = jnp.take(R, jnp.where(idx < k, idx, idx + 1), axis=1)

        def sweep(i, carry):
            Rd, Qt = carry
            two = jax.lax.dynamic_slice(Rd, (i, i), (2, 1))
            c, s = givens_rotation(two[0, 0], two[1, 0])
            return _rot_rows(Rd, i, c, s), _rot_rows(Qt, i, c, s)

        Rd, Qt = jax.lax.fori_loop(
            0, min(m - 1, n - 1), sweep, (Rd, Q.T), unroll=4
        )
        return Qt.T, jnp.triu(Rd)

    return run


def qr_insert_col(Q, R, k, u):
    """Insert column ``u`` at position ``k``: given complete-mode
    ``A = Q R``, return (Q', R') factoring A with u spliced in before its
    old column k, in O(m (m - k)) — the scipy
    ``qr_insert(..., which='col')`` counterpart.

    ``w = Qᵀu`` becomes the new column; a bottom-up chain of rotations on
    rows (i, i+1), i = m-2..k, zeroes w below row k.  Rows above k are
    untouched (masked identity rotations keep ``k`` traceable), and each
    rotation can only fill entries on or above the shifted columns'
    diagonals, so R stays upper triangular.

    Args:
        Q: (m, m) orthogonal; R: (m, n) upper triangular with n < m
           (the inserted column needs a free row for its diagonal);
        k: int in [0, n]; u: (m,) or (m, 1).

    Returns:
        (Q' (m, m), R' (m, n+1)).
    """
    Q = jnp.asarray(Q, jnp.float32)
    R = jnp.asarray(R, jnp.float32)
    u = jnp.asarray(u, jnp.float32).reshape(-1)
    m, n = R.shape
    if Q.shape != (m, m) or u.shape != (m,):
        raise ValueError(
            f"qr_insert_col needs complete-mode factors and u (m,): "
            f"Q {Q.shape}, R {R.shape}, u {u.shape}"
        )
    if n >= m:
        raise ValueError(
            f"qr_insert_col: inserting into a full-rank-square factor "
            f"(m={m}, n={n}) has no free row for the new diagonal"
        )
    k = jnp.asarray(k, jnp.int32)
    return _insert_col_run(m, n)(Q, R, k, u)


@lru_cache(maxsize=None)
def _insert_col_run(m: int, n: int):
    @jax.jit
    def run(Q, R, k, u):
        w = jnp.matmul(Q.T, u[:, None], precision=_HI)
        idx = jnp.arange(n + 1, dtype=jnp.int32)
        src = jnp.clip(jnp.where(idx < k, idx, idx - 1), 0, n - 1)
        Rx = jnp.where((idx == k)[None, :], w, jnp.take(R, src, axis=1))

        def sweep(t, carry):
            Rx, Qt = carry
            i = m - 2 - t
            on = i >= k
            two = jax.lax.dynamic_slice(
                Rx, (i, jnp.zeros_like(i)), (2, n + 1)
            )
            wk = jnp.take(two, k, axis=1)  # entries (i, k), (i+1, k)
            c, s = givens_rotation(wk[0], wk[1])
            c = jnp.where(on, c, 1.0)
            s = jnp.where(on, s, 0.0)
            return _rot_rows(Rx, i, c, s), _rot_rows(Qt, i, c, s)

        Rx, Qt = jax.lax.fori_loop(0, m - 1, sweep, (Rx, Q.T), unroll=4)
        # the chain zeroes strictly-below-diagonal entries of column k;
        # other columns never receive sub-diagonal fill (see docstring)
        return Qt.T, jnp.triu(Rx)

    return run


def qr_delete_row(Q, R, k):
    """Delete row ``k`` of the factored matrix: given complete-mode
    ``A = Q R``, return (Q', R') with ``A-minus-row-k = Q' R'`` in
    O(m (m + n)) — the scipy ``qr_delete(..., which='row')``
    counterpart, and the observation-REMOVAL half of the recursive
    least-squares pair (``qr_append_row`` adds one).

    Let q = (row k of Q).  A bottom-up chain of rotations on coordinate
    pairs (i, i+1) maps q to ±e₀ — applied to R's rows it fills one
    subdiagonal (upper Hessenberg H), applied to Q's columns it makes
    column 0 equal ±e_k.  Dropping row k and column 0 of the rotated Q
    (orthogonal by construction: its row k is ±e₀) and row 0 of H gives
    the deleted-row factorization.  Numerically this is the STABLE
    downdate (no hyperbolic rotations): accuracy is governed by plane
    rotations only.

    Args:
        Q: (m, m) orthogonal; R: (m, n) upper triangular; k: int in [0, m).

    Returns:
        (Q' (m-1, m-1), R' (m-1, n)).
    """
    Q = jnp.asarray(Q, jnp.float32)
    R = jnp.asarray(R, jnp.float32)
    m, n = R.shape
    if Q.shape != (m, m):
        raise ValueError(
            f"qr_delete_row needs complete-mode factors: Q {Q.shape} vs "
            f"R {R.shape}"
        )
    if m < 2:
        raise ValueError("qr_delete_row: m must be >= 2")
    k = jnp.asarray(k, jnp.int32)
    return _delete_row_run(m, n)(Q, R, k)


@lru_cache(maxsize=None)
def _delete_row_run(m: int, n: int):
    @jax.jit
    def run(Q, R, k):
        q = jnp.take(Q, k, axis=0)  # (m,) coordinates in the R-row basis

        def sweep(t, carry):
            q, R, Qt = carry
            i = m - 2 - t
            c, s = givens_rotation(q[i], q[i + 1])
            qi = c * q[i] - s * q[i + 1]
            q = q.at[i].set(qi).at[i + 1].set(0.0)
            return q, _rot_rows(R, i, c, s), _rot_rows(Qt, i, c, s)

        q, H, Qt = jax.lax.fori_loop(0, m - 1, sweep, (q, R, Q.T),
                                     unroll=4)
        Qr = Qt.T  # rotated Q: row k is (q[0], 0, ..., 0), |q[0]| = 1
        ridx = jnp.arange(m - 1, dtype=jnp.int32)
        rows = jnp.where(ridx < k, ridx, ridx + 1)
        Qd = jnp.take(Qr, rows, axis=0)[:, 1:]
        return Qd, jnp.triu(H[1:, :])

    return run
