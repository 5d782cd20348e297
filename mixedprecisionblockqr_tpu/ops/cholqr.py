"""CholeskyQR panel factorization — the all-GEMM fast path.

The reference leaves its panel factorization sequential on the host
(``h_householder_qr``, ``Cuda/qr.cu:198``), so its GPU pipeline stalls every
panel.  On the device the panel can instead be factored with CholeskyQR2
[Yamamoto, Nakatsukasa, Yanagisawa, Fukaya 2015]:

    G = P^T P            (one m x r x r GEMM)
    R = chol(G)^T        (r x r, the only non-GEMM step)
    Q = P R^-1           (triangular solve as GEMM with R^-1)
    ... repeated once more (the "2" in CholeskyQR2) to restore
    orthogonality to machine precision: Q2 = Q S^-1, R_out = S R.

Everything heavy is a large matmul, so the panel rides the systolic array
instead of a 2048-step scalar-ish reflector loop.  Numerical domain: plain
CholeskyQR2 in fp32 needs cond(P) <~ sqrt(1/eps_f32) ~ 4e3 (G squares the
condition number); ``shifted=True`` applies the Fukaya et al. 2020 shift on
the first iteration, extending the domain to cond(P) ~ 1/eps at the cost of
one more pass.  The blocked driver exposes ``panel_method='cholqr2'`` as the
bench/fast path and keeps the Householder panel (exact GVL semantics) as the
robust default; both produce panels consumed identically downstream.

The trailing/Q updates reconstruct a single block reflector from the reduced
panel Q via the basis-kernel identity (see ``parallel/dist_qr.py``):
``H = I - Y S^-1 Y^T`` with ``Y = Q_red - E1``, ``S = I - Q1^T``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST


def _chol_and_inv(G: jax.Array, shift=None):
    """(R, R^-1) with R^T R = G (+ shift * I); shift may be traced.

    The fix for the chol latency chain is the Newton-Schulz panel path
    (``panel_method='polar'``/BGS in ops/blockqr.py), which needs no
    per-panel triangular ops at all.
    """
    r = G.shape[0]
    if shift is not None:
        G = G + shift * jnp.eye(r, dtype=G.dtype)
    L = jnp.linalg.cholesky(G)
    R = L.T
    Rinv = jax.scipy.linalg.solve_triangular(
        R, jnp.eye(r, dtype=R.dtype), lower=False
    )
    return R, Rinv


def cholesky_qr2(
    P: jax.Array, shifted: bool = False, passes: int = 2
) -> Tuple[jax.Array, jax.Array]:
    """Reduced QR of a tall panel P (m x r) by (shifted) CholeskyQR.

    ``passes=2`` (CholeskyQR2) reaches fp32-machine orthogonality;
    ``passes=1`` gives orthogonality ~ cond(P)^2 * eps_f32 — below bf16
    noise for well-conditioned panels, so the mixed-precision blocked
    driver can use it to halve the small-op count per panel.

    Returns (Q (m x r) with orthonormal columns, R (r x r) upper).
    """
    m, r = P.shape
    G = jnp.matmul(P.T, P, precision=_HI)
    shift = None
    if shifted:
        # First-pass shift capping the effective condition number at ~1e3
        # so the SECOND pass's unshifted Cholesky stays inside the fp32
        # domain (cond <~ 1/sqrt(eps_f32) ~ 3e3).  Fukaya et al. 2020's
        # 11(mr + r(r+1)) u ||G|| shift targets double precision — in fp32
        # that coefficient is ~0.2-0.3, a near-||G|| shift whose bias the
        # later passes cannot absorb (their Grams NaN'd the chol at
        # cond(P) ~ 1e5; regression-tested in test_tsqr.py).
        shift = 1e-3 * jnp.trace(G)
    R1, R1inv = _chol_and_inv(G, shift)
    Q = jnp.matmul(P, R1inv, precision=_HI)
    R = R1
    # Extra orthogonalization passes (the "2" of CholeskyQR2; +1 absorbs
    # the shifted variant's bias — CholeskyQR3).
    for _ in range((1 if shifted else 0) + max(passes - 1, 0)):
        G2 = jnp.matmul(Q.T, Q, precision=_HI)
        R2, R2inv = _chol_and_inv(G2)
        Q = jnp.matmul(Q, R2inv, precision=_HI)
        R = jnp.matmul(R2, R, precision=_HI)
    return Q, R


def newton_inv(S: jax.Array, iters: int = 6, check: bool = False) -> jax.Array:
    """Inverse of a well-conditioned matrix by Newton-Schulz — pure GEMMs
    instead of XLA's LU path.

    Domain: the iteration contracts when ||I - X0 S||_2 < 1.  The Yamamoto
    S = I - Q1^T with diag(Q1) <= 0 has spectrum in the right-half disk
    |z - 1| <= 1 (||Q1||_2 <= 1), so X0 = (2/3) I — the minimax scalar for
    sigma in [1, 2] — gives ||I - X0 S|| <= 1/3 + O(eps) and quadratic
    convergence: 4 iterations reach ~3^-16 ~ 2e-8, 5 reach fp32 roundoff.

    Breakdown domain (documented per the round-1 advisory): the diag(Q1) <= 0
    sign fix bounds sigma_max(S) <= 2 but NOT sigma_min away from 0 — if Q1
    has a unit singular value with aligned left/right vectors (e.g. a
    rotation by pi about (1,1,1)/sqrt(3): eigenvalue +1 with all-negative
    diagonal), S is singular and NO inverse exists — LU would fail too; the
    robust escape is the Householder panel (``panel_method='householder'``).
    For *near*-singular S the iteration converges slowly rather than not at
    all; ``check=True`` adds a residual test ``max|I - S X| < 1e-3`` with a
    ``lax.cond`` fallback to XLA's LU inverse (one extra GEMM per call —
    keep off in the per-panel hot loop, on in robustness-first paths).
    """
    r = S.shape[0]
    I = jnp.eye(r, dtype=S.dtype)
    X = (2.0 / 3.0) * I
    for _ in range(iters):
        X = jnp.matmul(
            X, 2.0 * I - jnp.matmul(S, X, precision=_HI), precision=_HI
        )
    if check:
        resid = jnp.max(jnp.abs(I - jnp.matmul(S, X, precision=_HI)))
        X = jax.lax.cond(
            resid < 1e-3, lambda s: X, lambda s: jnp.linalg.inv(s), S
        )
    return X


def newton_iters_for_aspect(aspect: float) -> int:
    """Newton iteration count for the Yamamoto S by panel aspect (m/r).

    sigma_min(S) = 1 - sigma_max(Q1) shrinks as the panel gets squarer
    (the top r x r block of an orthonormal basis captures more of the
    column space), and Newton under-converges silently: measured on a
    1024x896 fp32 factorization, the aspect-2 corner panel had
    sigma_min(S) = 0.236 and a 5-iteration residual of 8e-5 — blowing
    final Q orthogonality from 2.7e-6 to 2.2e-4.  Tall panels keep the
    short chain; squarer panels get iteration headroom (each extra
    iteration is 2 chained GEMMs)."""
    if aspect >= 8:
        return 5
    if aspect >= 4:
        return 8
    return 12


def yamamoto_reflector(
    Q_red: jax.Array,
    R: jax.Array,
    inv_method: str = "lu",
    newton_iters: Optional[int] = None,
    check: bool = False,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Build the block reflector (Y, Sinv) with ``H = I - Y Sinv Y^T``
    orthogonal and ``H[:, :r] = Q_red`` (basis-kernel / Yamamoto identity),
    plus the sign-fixed R.

    Columns are sign-flipped so diag(Q1) <= 0, keeping S = I - Q1^T
    well-conditioned (cond(S) ~ 2); R rows flip accordingly so Q R is
    invariant.  Then ``H^T A_panel = [R; 0]`` and trailing updates are
    ``C - Y (Sinv^T (Y^T C))`` — three GEMMs.
    """
    m, r = Q_red.shape
    Q1 = Q_red[:r, :]
    D = jnp.where(jnp.diag(Q1) > 0, -1.0, 1.0).astype(Q_red.dtype)
    Qs = Q_red * D[None, :]
    R = R * D[:, None]
    rows = jax.lax.broadcasted_iota(jnp.int32, (m, r), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (m, r), 1)
    Y = Qs - (rows == cols).astype(Qs.dtype)
    S = jnp.eye(r, dtype=Qs.dtype) - Qs[:r, :].T
    if inv_method == "newton":
        iters = (
            newton_iters
            if newton_iters is not None
            else newton_iters_for_aspect(m / r)
        )
        Sinv = newton_inv(S, iters=iters, check=check)
    else:
        Sinv = jnp.linalg.inv(S)
    return Y, Sinv, R
