"""Newton-Schulz panel orthonormalization — the custom-call-free panel path.

Why this exists: XLA's ``cholesky`` and ``solve_triangular`` lower to
library calls with a fixed latency per small block, and the blocked QR pays
that pair once per panel on its critical path.  The panel factor is instead
built from pure matmuls:

**Triangular Newton-Schulz inverse Cholesky** (``tri_inv_chol``): iterate
an UPPER-TRIANGULAR X toward ``X^T G X = I``:

    E = I - X^T G X;  C = triu(E, 1) + diag(E)/2;  X <- X (I + C)

C is the unique upper-triangular solution of ``C^T + C = E`` at M ~= I, so
the update cancels E to first order and converges quadratically; on the
diagonal the map reduces exactly to the Newton-Schulz scalar recurrence
``lam <- lam (3 - lam)^2 / 4``.  Seeding with the Jacobi scaling
``X0 = diag(G)^{-1/2}`` (plus a power-iteration spectral-norm guard) puts
the spectrum in (0, 1], so every eigenvalue climbs monotonically to 1:
measured iteration counts — 5 (panel aspect 16), 6-8 (aspect 2-4), 19 for
the final square 128-block of a random 2048^2 at cond(G) = 2.4e5.

Because X is triangular, the panel's R block is recovered WITHOUT any
solve:  ``X^T G X = I  =>  X^{-1} = X^T G`` — one matmul, upper-triangular
by construction.  So ``P = Q t`` with ``Q = P X`` orthonormal and
``t = X^T G``: a complete CholeskyQR-class panel factorization with zero
triangular library calls: chained GEMMs only (``tri_chain`` packages the
chain for the drivers; ``ops/pallas/ns.py`` runs it as one GPU kernel).

This is the on-device answer to the reference's per-panel host stall
(``dev_mixed_precision_block_qr``'s CPU panel factor + memcpys,
``Cuda/qr.cu:1049-1226``).

Numerical domain: like CholeskyQR, the Gram squares the condition number —
a fast path for panels with cond(P) well inside 1/sqrt(eps_f32) (the
blocked driver's tail panels get extra iterations + a second refinement
pass, CholeskyQR2-style).  The unconditionally robust panel remains
'householder'.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST


def _spectral_guard(M: jax.Array) -> jax.Array:
    """Upper estimate of ||M||_2 via two power-iteration matvecs, x1.05.

    Computed SCALE-NORMALIZED (divide by max|M| first, renormalize the
    intermediate vector): the estimate ||M v1|| / ||v1|| is scale-invariant,
    but the naive unnormalized form overflows fp32 for ||G|| >~ 1e13 — a
    Gram of panel columns with norm ~3e6, i.e. ANY physically-scaled input
    (round-7 find: uniform x 1e6 data NaN'd every NS tier through
    scale = rsqrt(inf/inf); the in-kernel mirror ``ops/pallas/ns.py::
    _norm2_est`` overflowed even earlier via an unscaled sum of squares).
    The normalized intermediates are bounded by r^1.5 regardless of
    scale, and tiny inputs no longer underflow to a 0/0 either."""
    a = jnp.maximum(jnp.max(jnp.abs(M)), jnp.finfo(jnp.float32).tiny)
    Ms = M / a
    v1 = jnp.matmul(Ms, jnp.sum(Ms, axis=1, keepdims=True), precision=_HI)
    n1 = jnp.linalg.norm(v1)
    v2 = jnp.matmul(Ms, v1 / (n1 + 1e-30), precision=_HI)
    return 1.05 * a * jnp.linalg.norm(v2)


def tri_iters_for_aspect(aspect: float) -> int:
    """Iteration count for ``tri_inv_chol`` by panel aspect (m/r).

    Measured: residual < 1e-6 in 5 iters at aspect 16 (cond(G) ~ 3), 6 at
    aspect 4-8, 8 at aspect 2.  One spare iteration on top; every
    iteration is ~3 dependent small products, so tall panels should not
    pay the worst case.

    Recalibration: aspect-8 PANELS of a blocked driver see the
    trailing corner's conditioning, not a fresh random panel's — at
    1024^2/r=128 (aspect 8) the 6-iteration chain under-converged and
    NaN-poisoned on centered-uniform data (canary working as designed).
    One step
    down the ladder per halved aspect fixes it with +3 small dots/panel
    on the affected sizes only; the 2048^2 headline (aspect 16) keeps 6."""
    if aspect >= 16:
        return 6
    if aspect >= 8:
        return 7
    if aspect >= 4:
        return 8
    return 9


def tri_head_iters(iters: int) -> int:
    """Chain budget for a driver's FIRST panel: ``iters + 6``.

    The head panel is the only block that factors RAW data — every later
    panel has been projected (BGS) or trailing-updated (reflector drivers)
    against the finished columns first, which removes the shared component
    of correlated data.  For positively-correlated inputs — the reference's
    own uniform [0,1) generator (``h_generate_random_matrix``,
    ``Cuda/mmult.cuh:38-68``), SLAM Jacobians, image patches — the head
    panel's Jacobi-scaled Gram has an OUTLIER spectrum: one eigenvalue
    ~ (1 + (r-1) rho) and a tight bulk at ~(1 - rho), i.e.
    cond(M0) ~ r rho/(1 - rho) ~ 1e3 that diagonal scaling cannot touch
    (measured 8.8e2 at 1024x128 uniform; the same panel PROJECTED drops to
    cond 5.9).  The spectral-guard init then lands the whole bulk at
    1/cond(M0), and the escape phase (x2.25/iter plain, x3.06 for the
    omega burst) needs ~10 iterations where the aspect budgets give 6-7 —
    the chain STALLS (measured one-behind 0.5) and the poison canary
    rightly trips on the reference's default test input class.

    +6 covers cond(M0) ~ 5e3-class at the aspect-16 base (needed: 10 at
    8.8e2, 12 at 4.7e3, 14 at 1.7e4; smaller aspects have higher bases
    and reach ~1e4) for the cost of 6 extra r x r iterations ONCE per
    factorization.  Beyond the boosted basin the canary still trips
    and ``check='sync'`` retries robustly — unchanged."""
    return iters + 6


def ns_omega_iters(iters: int) -> int:
    """How many EARLY iterations of a triangular-NS chain run over-relaxed
    (omega = 1.5): ``min(4, max(0, iters - 4))``.

    Calibration: the iteration's
    small-eigenvalue escape multiplier is ``(1 + omega/2)^2`` — 2.25x/iter
    plain, 3.06x at omega = 1.5 — so over-relaxed early steps widen the
    cond(G) basin substantially at IDENTICAL dot count (the fix for
    structured/conditioned panels whose Grams out-cond the aspect budgets
    calibrated on random data).  Omega is bounded by fixed-point
    stability: the scalar map ``mu (1 + omega (1 - mu)/2)^2`` has
    ``g'(1) = 1 - omega``, so omega = 2 is NEUTRALLY stable — converged
    eigenvalues oscillate 1 +/- eps without contracting (measured: a
    1.5e-5 -> 9.3e-4 orthogonality floor regression on the distributed
    fp32 bgs2 tier, and outright NaN divergence when 9 omega iterations
    ran inside the 14-iteration shifted robust pass via the non-normal
    triangular coupling).  omega = 1.5 contracts at 0.5/iter near the
    fixed point — floor-neutral everywhere tested — and the burst is
    capped at 4 since escape saturates there."""
    return min(4, max(0, iters - 4))


def tri_inv_chol(G: jax.Array, iters: int = 10, with_resid: bool = False,
                 omega: bool = True):
    """Upper-triangular X with ``X^T G X ~= I`` (X ~= chol(G)^{-1}), from
    chained matmuls only.  G must be SPD (fp32).

    ``with_resid`` also returns ``max|I - X^T G X|`` from the LAST
    iteration's correction (one step behind the final X — a conservative
    over-estimate, free to produce) so callers can arm a fallback: the
    fixed iteration count covers a cond(G) budget, and panels of
    CORRELATED data (e.g. the reference's positive-uniform test matrices
    or SLAM Jacobians) can exceed it at any aspect.

    ``omega`` (default on) over-relaxes the early iterations
    (``ns_omega_iters``): same cost, ~an order of magnitude wider cond(G)
    basin — the round-5b fix for structured (non-random) panels whose
    Grams out-cond the aspect-calibrated budgets at ZERO extra dots."""
    r = G.shape[0]
    G = G.astype(jnp.float32)
    I = jnp.eye(r, dtype=jnp.float32)
    d = jax.lax.rsqrt(jnp.maximum(jnp.diag(G), jnp.finfo(jnp.float32).tiny))
    # M0 = D G D (correlation matrix), scaled into (0, 1] by the guard.
    M0 = G * d[:, None] * d[None, :]
    scale = jax.lax.rsqrt(_spectral_guard(M0))
    X = jnp.diag(d * scale)
    E = I
    n_om = ns_omega_iters(iters) if omega else 0
    for it in range(iters):
        W = jnp.matmul(G, X, precision=_HI)
        M = jnp.matmul(X.T, W, precision=_HI)
        E = I - M
        C = jnp.triu(E, 1) + jnp.diag(jnp.diag(E)) * 0.5
        upd = jnp.matmul(X, C, precision=_HI)
        X = X + (1.5 * upd if it < n_om else upd)
    if with_resid:
        return X, jnp.max(jnp.abs(E))
    return X


def tri_chain(G: jax.Array, iters: int, shift: float = 0.0,
              refine: bool = False, omega: bool = True):
    """The Block Gram-Schmidt panel chain on an SPD Gram: returns
    ``(X, t, resid)`` with ``X^T G' X ~= I`` (G' = G + shift*||G|| I when
    ``shift`` > 0) and ``t = triu(X^T G')``, the inverse of X at
    convergence.  ``resid`` is ``max|I - X^T G' X|`` one iteration behind
    (free), or, with ``refine=True`` (identity-seeded chain for Grams
    already near I), the exact post-loop residual.

    The plain-XLA implementation; ``ops/pallas/ns.py::ns_chain`` runs the
    same chain as one GPU kernel."""
    r = G.shape[0]
    I = jnp.eye(r, dtype=jnp.float32)
    G = G.astype(jnp.float32)
    if shift:
        G = G + (shift * _spectral_guard(G)) * I
    if refine:
        X = _tri_refine(G, iters)
        M = jnp.matmul(X.T, jnp.matmul(G, X, precision=_HI), precision=_HI)
        resid = jnp.max(jnp.abs(I - M))
    else:
        X, resid = tri_inv_chol(G, iters=iters, with_resid=True, omega=omega)
    return X, jnp.triu(jnp.matmul(X.T, G, precision=_HI)), resid


def tri_robust_panel(P: jax.Array, chain=tri_chain, gram=None):
    """Shifted three-pass panel factorization ``P ~= Qk t`` for
    ill-conditioned panels, as chains on fresh Grams (the
    ``tri_cholqr_robust`` scheme without sign convention): pass 1 on the
    shifted Gram (condition capped, 14 iterations converge for any
    input), pass 2 on the Gram of ``Q1 = P X1``, an identity-seeded
    refinement pass 3.  ``chain`` has ``tri_chain``'s signature (the
    drivers pass the platform's implementation); ``gram(a, b)`` computes
    ``a^T b`` (default fp32 HIGHEST; the distributed drivers add a psum).
    Returns ``(Qk, t, resid)`` with ``resid`` the final pass's exact
    residual: small iff the whole composition converged."""
    if gram is None:
        gram = lambda a, b: jnp.matmul(a.T, b, precision=_HI)
    P = P.astype(jnp.float32)
    X1, t1, _ = chain(gram(P, P), 14, shift=1e-3, omega=False)
    Q1 = jnp.matmul(P, X1, precision=_HI)
    X2, t2, _ = chain(gram(Q1, Q1), 12, omega=False)
    Q2 = jnp.matmul(Q1, X2, precision=_HI)
    X3, t3, resid = chain(gram(Q2, Q2), 4, refine=True)
    Qk = jnp.matmul(Q2, X3, precision=_HI)
    t = jnp.triu(jnp.matmul(t3, jnp.matmul(t2, t1, precision=_HI),
                            precision=_HI))
    return Qk, t, resid


def tri_cholqr(
    P: jax.Array,
    iters: int = 10,
    refine_iters: int = 0,
    sign_fix: bool = True,
    gram_precision=_HI,
    check: bool = True,
    return_resid: bool = False,
    omega: bool = True,
) -> Tuple[jax.Array, ...]:
    """CholeskyQR-class panel factorization with no library calls on the
    convergent path.

    Returns (Qs, t, X) with ``P ~= Qs @ t``:
      * ``Qs`` (m x r): orthonormal columns; with ``sign_fix``,
        ``diag(Qs[:r]) <= 0`` (the Yamamoto convention keeping
        ``S = I - Qs[:r]^T`` in the Newton-invertible domain, sigma in
        [1, 2] — needed by the reflector drivers, skippable by the BGS
        driver which builds no reflectors),
      * ``t``  (r x r): upper-triangular (rows sign-flipped to match),
      * ``X``  (r x r): the inverse factor, ``Qs = P @ X``.

    ``refine_iters > 0`` adds a second CholeskyQR2-style pass on the
    computed Q's Gram (cheap: its spectrum is already near 1), pushing
    orthogonality to fp32 roundoff even at cond(G) ~ 1e5-class — used for
    the blocked drivers' ill-conditioned tail panels.  ``gram_precision``
    trades Gram accuracy for speed (``ops/blockqr.py::BF16_X3`` = 3-pass
    bf16, ~2^-16 class — enough for the mixed policy's 2^-8 noise floor).

    ``check`` (default ON — correctness first): if the iteration's residual
    exceeds 1e-4 — panels of CORRELATED columns can out-cond any fixed
    iteration budget; the reference's own positive-uniform generator
    (``h_generate_random_matrix``) produces exactly such panels, and the
    silent failure mode is a garbage factorization — a ``lax.cond`` falls
    back to the direct chol+solve_triangular inverse (the custom calls
    execute only when taken).  A per-panel ``lax.cond`` sits on the
    critical path, so the blocked drivers instead pass ``check=False, return_resid=True`` and arm
    ONE deferred whole-factorization fallback on the max residual
    (``ops/blockqr.py``); the per-panel cond remains the safe default for
    standalone callers.  ``return_resid`` appends the residual to the
    returned tuple.
    """
    m, r = P.shape
    G = jnp.matmul(P.T, P, precision=gram_precision)
    X, resid = tri_inv_chol(G, iters=iters, with_resid=True, omega=omega)
    if check:
        def _direct(g):
            L = jnp.linalg.cholesky(g)
            return jax.scipy.linalg.solve_triangular(
                L.T, jnp.eye(r, dtype=jnp.float32), lower=False
            )

        # The chain reports the free ONE-BEHIND correction, which lags the
        # final quadratic step by its square root — its SQUARE estimates
        # the true residual (the repo-wide convention: 1.3e-4 one-behind
        # measured on a converged panel whose true residual was 2e-7, see
        # _poison_if_unconverged).  The raw value here falsely tripped
        # the chol+solve fallback on healthy panels; a stalled chain (~6e-2) still squares to 3.6e-3 >>
        # tol and takes the fallback.
        X = jax.lax.cond(resid * resid < 1e-4, lambda g: X, _direct, G)
    t = jnp.triu(jnp.matmul(X.T, G, precision=_HI))  # X^{-1} = X^T G
    if refine_iters > 0:
        # CholeskyQR2-style second pass: the Gram of the EXPLICIT Q1 = P X
        # (not X^T G X — only the fresh product captures the fp32 rounding
        # committed in pass 1; the algebraic form plateaus at ~1e-4
        # orthogonality on cond(G) ~ 1e5 blocks, the fresh one reaches
        # fp32 roundoff like CholeskyQR2).
        Q1f = jnp.matmul(P, X, precision=_HI)
        M1 = jnp.matmul(Q1f.T, Q1f, precision=_HI)
        X2 = _tri_refine(M1, refine_iters)
        t = jnp.triu(
            jnp.matmul(jnp.matmul(X2.T, M1, precision=_HI), t, precision=_HI)
        )  # X2^{-1} (X^{-1}) — both upper-triangular
        X = jnp.matmul(X, X2, precision=_HI)
    if not sign_fix:
        out = (jnp.matmul(P, X, precision=gram_precision), t, X)
        return out + ((resid,) if return_resid else ())
    Q1 = jnp.matmul(P[:r, :], X, precision=_HI)
    D = jnp.where(jnp.diag(Q1) > 0, -1.0, 1.0).astype(jnp.float32)
    Xs = X * D[None, :]
    Qs = jnp.matmul(P, Xs, precision=_HI)
    out = (Qs, D[:, None] * t, Xs)
    return out + ((resid,) if return_resid else ())


def tri_cholqr_robust(
    P: jax.Array, sign_fix: bool = True, return_resid: bool = False
) -> Tuple[jax.Array, ...]:
    """Shifted three-pass triangular-NS panel factorization for
    ill-conditioned panels (the trailing-corner blocks of square
    factorizations, cond(G) ~ 1e5-1e8 class).

    Pass 1 factors the SHIFTED Gram ``G + s I`` with ``s = 1e-3 ||G||_2``
    (power-iteration estimate) — capping pass-1's effective condition
    number at ~1e3 so 14 iterations converge for ANY input.  (Fukaya et
    al. 2020's ``11(mr + r^2) u ||G||`` shift targets double precision; in
    fp32 that factor is ~0.18 — a near-||G|| shift that wrecks the scaling
    of the composed factors.)  At convergence ``t1 = X1^T (G + s I)`` is
    the inverse of X1 (X^T M X = I  =>  X^{-1} = X^T M), so
    ``P = (P X1) t1`` is reconstruction-accurate even though Q1 = P X1 is
    only approximately orthonormal (sigma(Q1)^2 = lam/(lam+s) >= ~1e-3/2 —
    cond(Q1) <= ~45).  Passes 2-3 re-factor Q1's fresh Gram
    (CholeskyQR3-style), absorbing the shift bias and reaching fp32
    roundoff orthogonality for cond(P) up to the fp32 Gram noise floor
    (~1e4-class; beyond that, use the Householder panel).

    Returns (Qs, t, X) like ``tri_cholqr``; ``return_resid`` appends the
    pass-2 chain residual (large iff the composition failed to converge —
    the observability hook ``_poison_if_unconverged`` keys on).
    """
    m, r = P.shape
    G = jnp.matmul(P.T, P, precision=_HI)
    s = 1e-3 * _spectral_guard(G)
    Gs = G + s * jnp.eye(r, dtype=jnp.float32)
    # Robust passes run pure Newton (omega=False): the shift caps the
    # condition, so escape is not the constraint, and omega=1.5 measurably
    # nudged the converged floor (~12% on a 256^2 fp32 tight-gate case).
    X1 = tri_inv_chol(Gs, iters=14, omega=False)
    t1 = jnp.matmul(X1.T, Gs, precision=_HI)  # exact X1^{-1}
    Q1 = jnp.matmul(P, X1, precision=_HI)
    # Pass 2 needs no fallback cond: cond(Q1) <= ~45 by the shift cap.
    Q2, t2, X2 = tri_cholqr(
        Q1, iters=12, refine_iters=4, sign_fix=sign_fix, check=False,
        omega=False,
    )
    t = jnp.triu(jnp.matmul(t2, t1, precision=_HI))
    out = (Q2, t, jnp.matmul(X1, X2, precision=_HI))
    if return_resid:
        # The TRUE final orthogonality residual max|I - Q2^T Q2| (one extra
        # Gram).  The in-chain one-behind correction over-reports by orders
        # of magnitude near convergence (NS is slow-then-quadratic) and
        # would falsely trip _poison_if_unconverged on healthy panels.
        M = jnp.matmul(Q2.T, Q2, precision=_HI)
        resid = jnp.max(jnp.abs(M - jnp.eye(r, dtype=jnp.float32)))
        out = out + (resid,)
    return out


def _tri_refine(M: jax.Array, iters: int) -> jax.Array:
    """Refinement pass: triangular NS on a Gram already near identity
    (no Jacobi scaling / spectral guard needed)."""
    r = M.shape[0]
    I = jnp.eye(r, dtype=jnp.float32)
    X = I
    for _ in range(iters):
        Mi = jnp.matmul(
            X.T, jnp.matmul(M, X, precision=_HI), precision=_HI
        )
        E = I - Mi
        C = jnp.triu(E, 1) + jnp.diag(jnp.diag(E)) * 0.5
        X = X + jnp.matmul(X, C, precision=_HI)
    return X


def ns_isqrt(G: jax.Array, iters: int = 10) -> jax.Array:
    """N ~= G^{-1/2} for SPD G (symmetric polar variant; ``tri_inv_chol``
    is the triangular one the blocked driver uses — this symmetric form is
    kept for polar-decomposition uses and as the cross-check oracle).

    Coupled Newton-Schulz: Y_0 = G/c, Z_0 = I;
    T = (3I - Z Y)/2; Y <- Y T; Z <- T Z;  Z -> (G/c)^{-1/2}.
    """
    r = G.shape[0]
    G = G.astype(jnp.float32)
    I = jnp.eye(r, dtype=jnp.float32)
    c = jnp.maximum(_spectral_guard(G), jnp.finfo(jnp.float32).tiny)
    Y = G / c
    Z = I
    for _ in range(iters):
        T = 1.5 * I - 0.5 * jnp.matmul(Z, Y, precision=_HI)
        Y = jnp.matmul(Y, T, precision=_HI)
        Z = jnp.matmul(T, Z, precision=_HI)
    return Z * jax.lax.rsqrt(c)
