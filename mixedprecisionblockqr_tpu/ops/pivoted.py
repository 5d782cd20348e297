"""Column-pivoted (rank-revealing) Householder QR.

The reference's solver oracle is Eigen's ``colPivHouseholderQr``
(``Cuda/QR/Solver/solver.cu:21-32``) and its Python fixtures include
rank-deficient matrices (``python/test_data.py:38-57``: rank-1, zero-row,
diagonal) — but no pivoted factorization exists anywhere in the reference
itself.  This module supplies it, closing the rank-deficient least-squares
path (``models/lstsq.py`` routes here when R's diagonal decays).

Algorithm: Businger-Golub column pivoting (the LAPACK ``xGEQP3`` family) —
at step k, swap the remaining column of largest 2-norm into position k,
eliminate it with a Householder reflector, repeat.  The result is
``A P = Q R`` with ``|R[0,0]| >= |R[1,1]| >= ...`` — the diagonal decay
exposes numerical rank.

Shape: ONE ``lax.fori_loop`` whose step works on full-width
static-shaped buffers —
  * pivot selection is a masked argmax over maintained column norms (no
    data-dependent shapes),
  * the column swap is two ``dynamic_update_slice`` writes (columns are
    contiguous in the (m, n) layout's minor axis tiling),
  * the reflector is built from a row-masked column (rows < k zeroed) and
    applied FULL-WIDTH as a rank-1 update ``A -= beta v (v^T A)`` — rows
    above k carry v = 0 and are untouched, exactly the masked-static-shape
    pattern of ``ops/householder.py``,
  * column norms are RECOMPUTED from the updated rows each step (one
    masked reduction — same O(mn) order as the rank-1 update itself)
    instead of LAPACK's downdate-with-retolerancing: simpler, immune to
    the classic downdate cancellation failure, and cheap elementwise work.

Cost: 2mn(k) FLOPs of rank-1 updates over min(m, n) sequential steps —
the robustness tier's price; the unpivoted blocked drivers remain the
throughput path.  Compiles as one scan program (compile-light at any n).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST


@partial(jax.jit, static_argnames=("want_q", "with_b"))
def _pivoted_qr_impl(A: jax.Array, B, want_q: bool, with_b: bool):
    m, n = A.shape
    kmax = min(m, n)
    A = A.astype(jnp.float32)
    rows = jax.lax.broadcasted_iota(jnp.int32, (m, 1), 0)
    cols1 = jax.lax.broadcasted_iota(jnp.int32, (1, n), 1)
    Q = jnp.eye(m, dtype=jnp.float32) if want_q else jnp.zeros((1, 1))
    Bc = B.astype(jnp.float32) if with_b else jnp.zeros((1, 1))
    perm = jnp.arange(n, dtype=jnp.int32)
    tiny = jnp.finfo(jnp.float32).tiny

    def step(k, carry):
        A, Q, Bc, perm = carry
        k = jnp.asarray(k)
        zero = jnp.zeros((), k.dtype)  # index dtypes must match (x64 mode)
        # --- pivot: remaining column (>= k) of largest live-row norm ---
        live = (rows >= k).astype(jnp.float32)
        colnorms = jnp.sum((A * live) ** 2, axis=0)          # (n,)
        masked = jnp.where(cols1[0] >= k, colnorms, -jnp.inf)
        j = jnp.argmax(masked).astype(k.dtype)
        # --- swap columns k <-> j of A (and the bookkeeping vectors) ---
        ck = jax.lax.dynamic_slice(A, (zero, k), (m, 1))
        cj = jax.lax.dynamic_slice(A, (zero, j), (m, 1))
        A = jax.lax.dynamic_update_slice(A, ck, (zero, j))
        A = jax.lax.dynamic_update_slice(A, cj, (zero, k))
        pk = jax.lax.dynamic_slice(perm, (k,), (1,))
        pj = jax.lax.dynamic_slice(perm, (j,), (1,))
        perm = jax.lax.dynamic_update_slice(perm, pk, (j,))
        perm = jax.lax.dynamic_update_slice(perm, pj, (k,))
        # --- Householder reflector on column k, rows >= k (masked) ---
        x = jax.lax.dynamic_slice(A, (zero, k), (m, 1)) * live  # (m, 1)
        sigma = jnp.sqrt(jnp.sum(x * x))
        xk = jnp.sum(jnp.where(rows == k, x, 0.0))
        sign = jnp.where(xk >= 0, 1.0, -1.0)                 # GVL convention
        ek = (rows == k).astype(jnp.float32)
        v = x + sign * sigma * ek
        vtv = jnp.sum(v * v)
        beta = jnp.where(vtv > tiny, 2.0 / jnp.maximum(vtv, tiny), 0.0)
        # --- full-width rank-1 updates (rows < k untouched: v there = 0) ---
        vA = jnp.matmul(v.T, A, precision=_HI)               # (1, n)
        A = A - beta * v * vA
        if with_b:
            vB = jnp.matmul(v.T, Bc, precision=_HI)
            Bc = Bc - beta * v * vB
        if want_q:
            Qv = jnp.matmul(Q, v, precision=_HI)             # (m, 1)
            Q = Q - beta * Qv * v.T
        return A, Q, Bc, perm

    A, Q, Bc, perm = jax.lax.fori_loop(0, kmax, step, (A, Q, Bc, perm))
    R = jnp.triu(A)
    return R, Q, Bc, perm


def _rqrcp_eligible(m: int, n: int, mode: str, block_size: int) -> bool:
    # The RQRCP tier lives in the BGS column-peel frame: reduced-Q only
    # (complete-Q for m > n needs the reflector frame's orthogonal
    # complement), r | n, and enough panels to amortize the sketch stages.
    return (
        m >= n
        and n % block_size == 0
        and n >= 4 * block_size
        and mode in ("r", "reduced")
    )


_RQRCP_TOL = 1e-4  # the blocked drivers' shared NS-residual poison tol


def _poison_outputs(worst, *arrays):
    """check='defer'-style poison for in-jit rqrcp callers: NaN-multiply
    every output when the worst NS residual exceeds the shared tolerance
    (mirrors ``ops/blockqr.py::_poison_if_unconverged``)."""
    bad = jnp.where(worst < _RQRCP_TOL, 1.0, jnp.float32(jnp.nan))
    return tuple(a * bad for a in arrays)


def pivoted_qr(
    A,
    mode: str = "reduced",
    method: str = "auto",
    block_size: int = 128,
    oversample: int = 8,
    seed: int = 0,
):
    """Column-pivoted QR: ``A[:, perm] = Q @ R`` with non-increasing
    ``|diag(R)|``.

    Returns (Q, R, perm) — reduced: Q (m, k), R (k, n); complete: Q (m, m),
    R (m, n); mode 'r': (R (k, n), perm).  Parity target:
    ``scipy.linalg.qr(A, pivoting=True)`` / Eigen ``colPivHouseholderQr``
    (``solver.cu:21-32``) up to column-sign convention.

    ``method``:
      * 'exact' — Businger-Golub QP3 (``_pivoted_qr_impl``): exact greedy
        pivots, min(m, n) sequential full-trailing passes.
      * 'rqrcp' — randomized sketch pivoting (Duersch & Gu 2017) over the
        blocked NS/BGS machinery: per-step pivot work drops from O(m w)
        to O((r + oversample) w).  Pivots are sketch-greedy (same
        rank-revealing class, not bit-identical to QP3); |diag(R)| decay
        is non-increasing up to ~1/sqrt(d) sketch distortion.  Exactly
        rank-deficient inputs make its NS panels poison — detected here
        and retried via 'exact' transparently (one scalar fetch).
      * 'auto' — 'rqrcp' when the shape qualifies
        (``_rqrcp_eligible``: m >= n, r | n, n >= 4r = 512, reduced/'r'
        mode), else 'exact'.

    Under ``jax.jit`` tracing: 'auto' resolves to 'exact' (the fallback
    cannot fetch its canary scalar in-trace — jit(pivoted_qr) stays
    traceable and exact); an explicit 'rqrcp' runs with the blocked
    drivers' check='defer' semantics — a failed panel NaN-poisons the
    outputs at first materialization instead of retrying.
    """
    A = jnp.asarray(A)
    m, n = A.shape
    k = min(m, n)
    want_q = mode in ("reduced", "complete")
    traced = isinstance(A, jax.core.Tracer)
    if method == "auto":
        # Under tracing the rqrcp->exact fallback cannot fetch its canary
        # scalar: auto keeps the (traceable) exact tier, preserving the
        # pre-rqrcp behavior of jit(pivoted_qr).
        method = (
            "rqrcp"
            if not traced
            and n >= 512
            and _rqrcp_eligible(m, n, mode, block_size)
            else "exact"
        )
    if method == "rqrcp":
        if not _rqrcp_eligible(m, n, mode, block_size):
            raise ValueError(
                "method='rqrcp' needs m >= n, block_size | n, "
                f"n >= 4*block_size and mode in ('r', 'reduced'); got "
                f"{m}x{n} mode={mode!r} block_size={block_size}"
            )
        R, Q, _, perm, worst = _rqrcp_impl(
            A, None, want_q, False, block_size, oversample, seed
        )
        if traced:
            # Explicit method='rqrcp' inside jit: defer semantics (the
            # blocked drivers' check='defer' contract) — a poisoned
            # factorization surfaces as NaN at first materialization.
            R, Q = _poison_outputs(worst, R, Q)
        elif not bool(worst < _RQRCP_TOL):  # NaN-safe: poison retries
            return pivoted_qr(A, mode=mode, method="exact")
        if mode == "r":
            return R[:k, :], perm
        return Q[:, :k], R[:k, :], perm
    if method != "exact":
        raise ValueError(f"unknown method {method!r}")
    R, Q, _, perm = _pivoted_qr_impl(A, None, want_q, False)
    if mode == "r":
        return R[:k, :], perm
    if mode == "reduced":
        return Q[:, :k], R[:k, :], perm
    if mode == "complete":
        return Q, R, perm
    raise ValueError(f"unknown mode {mode!r}")


def pivoted_qr_qtb(
    A,
    B,
    method: str = "auto",
    block_size: int = 128,
    oversample: int = 8,
    seed: int = 0,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Factor with pivoting and return (R, Q^T B, perm) without
    materializing Q — the rank-deficient least-squares fast path.
    ``method`` as in ``pivoted_qr`` ('auto' takes the RQRCP tier at
    n >= 512 on qualifying shapes; its NS poison falls back to 'exact')."""
    A = jnp.asarray(A)
    B = jnp.asarray(B)
    squeeze = B.ndim == 1
    if squeeze:
        B = B[:, None]
    m, n = A.shape
    k = min(m, n)
    traced = isinstance(A, jax.core.Tracer) or isinstance(
        B, jax.core.Tracer
    )
    if method == "auto":
        method = (
            "rqrcp"
            if not traced
            and n >= 512
            and _rqrcp_eligible(m, n, "r", block_size)
            else "exact"
        )
    if method == "rqrcp":
        if not _rqrcp_eligible(m, n, "r", block_size):
            raise ValueError(
                "method='rqrcp' needs m >= n, block_size | n and "
                f"n >= 4*block_size; got {m}x{n} block_size={block_size}"
            )
        R, _, QtB, perm, worst = _rqrcp_impl(
            A, B, False, True, block_size, oversample, seed
        )
        if traced:
            R, QtB = _poison_outputs(worst, R, QtB)
        elif not bool(worst < _RQRCP_TOL):
            return pivoted_qr_qtb(A, B[:, 0] if squeeze else B,
                                  method="exact")
        QtB = QtB[:, 0] if squeeze else QtB
        return R[:k, :], QtB, perm
    if method != "exact":
        raise ValueError(f"unknown method {method!r}")
    R, _, QtB, perm = _pivoted_qr_impl(A, B, False, True)
    QtB = QtB[:, 0] if squeeze else QtB
    return R[:k, :], QtB, perm


@partial(jax.jit, static_argnames=("r",))
def _sketch_qrcp(Bsk: jax.Array, r: int):
    """Greedy QRCP pivot SELECTION on a small sketch, by classical
    Gram-Schmidt: at step s pick the unselected column of largest residual
    norm, orthogonalize the sketch against it, downdate the norms by the
    CGS coefficients.  Returns ``(sel, ds)`` — the r selected column
    indices in selection order and their residual norms at selection
    (``ds`` is the sketch's estimate of the pivoted R diagonal).

    Norm downdate by ``coef^2`` is the classic cancellation-prone shortcut
    (LAPACK retolerances it); here it only perturbs pivot ORDER on a
    RANDOM sketch whose norm estimates carry ~1/sqrt(d) distortion anyway
    — the factorization itself is exact regardless of which columns get
    picked (Duersch & Gu 2017, RQRCP: sample pivots, factor exactly).
    """
    d, w = Bsk.shape
    B = Bsk.astype(jnp.float32)
    norms = jnp.sum(B * B, axis=0)
    tiny = jnp.finfo(jnp.float32).tiny
    idx = jnp.arange(w, dtype=jnp.int32)

    def step(s, carry):
        B, norms, selected, sel, ds = carry
        j = jnp.argmax(jnp.where(selected, -jnp.inf, norms)).astype(
            jnp.int32
        )
        onehot = (idx == j).astype(jnp.float32)
        q = jnp.matmul(B, onehot[:, None], precision=_HI)[:, 0]
        q2 = jnp.sum(q * q)
        live = q2 > tiny
        qn = jnp.where(live, q / jnp.sqrt(jnp.maximum(q2, tiny)), 0.0)
        coef = jnp.matmul(qn[None, :], B, precision=_HI)[0]
        B = B - qn[:, None] * coef[None, :]
        norms = jnp.maximum(norms - coef * coef, 0.0)
        selected = selected | (idx == j)
        sel = sel.at[s].set(j)
        ds = ds.at[s].set(jnp.where(live, jnp.sqrt(q2), 0.0))
        return B, norms, selected, sel, ds

    _, _, _, sel, ds = jax.lax.fori_loop(
        0,
        r,
        step,
        (
            B,
            norms,
            jnp.zeros((w,), jnp.bool_),
            jnp.zeros((r,), jnp.int32),
            jnp.zeros((r,), jnp.float32),
        ),
    )
    return sel, ds


@partial(
    jax.jit,
    static_argnames=("want_q", "with_b", "r", "oversample", "seed"),
)
def _rqrcp_impl(
    A: jax.Array,
    B,
    want_q: bool,
    with_b: bool,
    r: int,
    oversample: int,
    seed: int,
):
    """Blocked randomized-pivoting QR (RQRCP, Duersch & Gu 2017) in the
    column-peel Block-Gram-Schmidt frame of ``ops/blockqr.py::
    _block_qr_bgs`` — the blocked redesign of the exact
    ``_pivoted_qr_impl``, whose per-step cost is O(m n) (one full trailing
    pass per column, min(m, n) sequential steps).

    Per r-wide panel: (1) sketch the CURRENT trailing carry with a fresh
    (r + oversample) x m Gaussian — re-sketching every panel makes the
    pivot norms exact-up-to-sketch-distortion with no downdate drift;
    (2) pick r pivots by greedy QRCP on the small sketch
    (``_sketch_qrcp`` — per-step cost O(d w), d ~ r, instead of O(m w));
    (3) gather the picked columns to the front; (4) BCGS2 re-projection
    against previous Q (fp32 HIGHEST — this is a robustness tier);
    (5) factor the panel with the shifted three-pass Newton-Schulz chain;
    (6) one wide eager projection of the rest.  The NS residual rides the same poison convention as the
    blocked drivers; the PUBLIC wrappers retry via the exact QP3 path
    when it trips (exact rank deficiency: orthogonalizing a numerically
    zero panel is meaningless in any frame).
    """
    from mixedprecisionblockqr_tpu.ops.polar import tri_cholqr_robust

    m, n = A.shape
    nb = n // r
    T = A.astype(jnp.float32)
    Bc = B.astype(jnp.float32) if with_b else None
    perm = jnp.arange(n, dtype=jnp.int32)
    R = jnp.zeros((n, n), jnp.float32)
    qcols = []
    qtb = [] if with_b else None
    worst = jnp.float32(0.0)
    key = jax.random.PRNGKey(seed)
    d = min(r + oversample, m)

    def _hi(a, b):
        return jnp.matmul(a, b, precision=_HI,
                          preferred_element_type=jnp.float32)

    for j in range(nb):
        k0 = j * r
        w = n - k0
        # (1) fresh sketch of the projected trailing carry: its column
        # norms ARE the QRCP residual norms, up to sketch distortion.
        # DEFAULT precision (one bf16 or TF32 pass): ~0.4% norm noise at
        # most, far below the ~1/sqrt(d) sketch distortion it rides on.
        Om = jax.random.normal(jax.random.fold_in(key, j), (d, m),
                               jnp.float32)
        # DELIBERATE exception to the fp32-matmuls-pass-HIGHEST rule
        # (explicit DEFAULT = one reduced-precision pass): this product only
        # feeds pivot-norm ESTIMATES whose sketch distortion (~1/sqrt(d),
        # ~9%) dwarfs the rounding; the factorization itself never consumes
        # Bsk.
        Bsk = jnp.matmul(Om, T, preferred_element_type=jnp.float32,
                         precision=jax.lax.Precision.DEFAULT)
        # (2) + (3): pick r pivots, gather them to the front (stable
        # argsort of the selection rank keeps the rest in order).
        sel, _ = _sketch_qrcp(Bsk, r)
        rank_of = jnp.full((w,), w, jnp.int32).at[sel].set(
            jnp.arange(r, dtype=jnp.int32)
        )
        order = jnp.argsort(rank_of)
        T = jnp.take(T, order, axis=1)
        perm = perm.at[k0:].set(jnp.take(perm[k0:], order))
        if j > 0:
            # Rows already written for these columns (previous panels'
            # projection coefficients) move WITH the columns — the exact
            # impl gets this for free from its in-place column swaps.
            # Only rows < k0 carry data at this point (the columns' own
            # diagonal blocks are unwritten), so permute just the top
            # slab instead of full (n, w) columns.
            R = R.at[:k0, k0:].set(jnp.take(R[:k0, k0:], order, axis=1))
        P = T[:, :r]
        C = T[:, r:]
        # (4) BCGS2 re-projection: P was projected once (as trailing
        # columns); one more pass bounds the CGS drift like the 'bgs'
        # quality rung (docs/ALGORITHMS.md D9 rationale).
        if qcols:
            Qprev = jnp.concatenate(qcols, axis=1)
            W2 = _hi(Qprev.T, P)
            P = P - _hi(Qprev, W2)
            R = R.at[:k0, k0 : k0 + r].add(W2)
        # (5) shifted three-pass NS panel (robust for cond(G) up to the
        # fp32 Gram floor; beyond that the residual poisons and the
        # public wrapper falls back to exact QP3).
        Qk, t, _, rres = tri_cholqr_robust(P, sign_fix=False,
                                           return_resid=True)
        worst = jnp.maximum(worst, 0.01 * rres)
        R = R.at[k0 : k0 + r, k0 : k0 + r].set(t)
        # (6) one wide projection of the remaining columns.
        if w > r:
            G1 = _hi(Qk.T, C)
            C = C - _hi(Qk, G1)
            R = R.at[k0 : k0 + r, k0 + r :].set(G1)
        if with_b:
            qtb.append(_hi(Qk.T, Bc))
        qcols.append(Qk)
        T = C

    R_full = (
        jnp.concatenate([R, jnp.zeros((m - n, n), R.dtype)], 0)
        if m > n
        else R
    )
    Q = jnp.concatenate(qcols, axis=1) if want_q else jnp.zeros((1, 1))
    QtB = jnp.concatenate(qtb, axis=0) if with_b else jnp.zeros((1, 1))
    return R_full, Q, QtB, perm, worst


def numerical_rank(
    R: jax.Array, rcond: float | None = None, m: int | None = None
) -> int:
    """Numerical rank from a PIVOTED R's diagonal decay: the count of
    ``|R[i,i]| > rcond * |R[0,0]|`` (diagonal is non-increasing by the
    pivoting invariant).  Default rcond = eps_f32 * max(m, n) — the
    ``np.linalg.lstsq``-style machine-precision cutoff.  ``R`` is usually
    the trimmed (k, n) factor, which no longer carries the original row
    count: callers that know it pass ``m`` so the default cutoff evaluates
    eps * max(m, n) for tall systems, not eps * n (round-3 ADVICE item 3).
    """
    d = jnp.abs(jnp.diag(jnp.asarray(R)))
    if rcond is None:
        rcond = float(jnp.finfo(jnp.float32).eps) * max(
            R.shape[1], m if m is not None else 0, R.shape[0]
        )
    # Key the cutoff to max|d|, not d[0]: exact QP3 makes them equal, but
    # the RQRCP tier's sketch-greedy order can put d[0] up to ~1.3x below
    # the true max — a d[0]-keyed threshold would then sit too low and
    # inflate the rank (measured: 439 vs oracle 437 on Bierlaire-1e6).
    return int(jnp.sum(
        d > rcond * (jnp.max(d) + jnp.finfo(jnp.float32).tiny)
    ))
