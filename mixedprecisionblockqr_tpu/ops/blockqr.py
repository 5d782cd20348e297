"""Blocked WY Householder QR — the flagship factorization, one jitted program.

Capability parity (behavior, not code) with the reference's GPU drivers:
  * fp32 blocked QR            -> ``dev_block_qr_wy``   (``Cuda/qr.cu:958-1047``)
  * mixed-precision blocked QR -> ``dev_mixed_precision_block_qr``
                                  (``Cuda/qr.cu:1049-1226``)
  * host/CPU blocked QR        -> ``h_block_qr``        (``Cuda/qr.cu:1275``)
    and the NumPy spec ``block_qr`` (``python/qr.py:91-142``, GVL Alg 5.2.3)
  * recursive blocked QR       -> ``block_recursive_qr`` (``python/qr.py:145``,
    GVL Alg 5.2.4)

Design.  The reference's panel loop crosses host<->device four-plus
times per panel (CPU panel factor at ``Cuda/qr.cu:1080``, H2D/D2H memcpys at
``qr.cu:1082,1215``, per-kernel syncs inside ``dev_wy_transform``) — its own
acknowledged bottleneck (``README.md:27-28``).  Here the *entire* loop is
traced into one XLA program: the Python-level panel loop has static bounds,
so every slice is static-shaped and exact (no masking waste on the trailing
GEMMs), and XLA overlaps/fuses across panels.  Precision boundaries follow a
:class:`DTypePolicy` instead of cast kernels + pad-to-16 TensorCore plumbing
(``Cuda/qr.cu:1115-1191``).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from mixedprecisionblockqr_tpu.ops.cholqr import (
    cholesky_qr2,
    newton_inv,
    yamamoto_reflector,
)
from mixedprecisionblockqr_tpu.ops.householder import (
    householder_qr,
    panel_factor,
)
from mixedprecisionblockqr_tpu.ops.policy import (
    DTypePolicy,
    POLICY_FP32,
    matmul,
)
from mixedprecisionblockqr_tpu.ops.wy import (
    apply_block_reflector_left_t,
    apply_block_reflector_right,
)

_HI = jax.lax.Precision.HIGHEST
# Three bf16 passes with fp32 accumulation (~2^-16 relative): the
# mid-precision products of the 'balanced' rung.  Named explicitly because
# a GPU runs Precision.HIGH on float32 as one TF32 pass (~2^-11).
BF16_X3 = jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3

DEFAULT_BLOCK_SIZE = 128
DEFAULT_GROUP_PANELS = 4


def chain_for(platform: str):
    """The r x r triangular-NS chain for a platform, with
    ``ops/polar.py::tri_chain``'s signature: the one-program GPU kernel
    (``ops/pallas/ns.py``) at the widths it compiles, the plain-XLA chain
    everywhere else.  ``platform`` is ``jax.default_backend()``, resolved by
    the public drivers at dispatch and threaded down as a static jit key."""
    from mixedprecisionblockqr_tpu.ops.polar import tri_chain

    if platform != "gpu":
        return tri_chain
    from mixedprecisionblockqr_tpu.ops.pallas.ns import kernel_fits, ns_chain

    def chain(G, iters, shift=0.0, refine=False, omega=True):
        impl = ns_chain if kernel_fits(G.shape[0]) else tri_chain
        return impl(G, iters, shift=shift, refine=refine, omega=omega)

    return chain


_NS_TIERS = ("bgs", "bgs1", "bgs2", "polar")


def check_policy_method(policy: DTypePolicy, panel_method: str) -> None:
    """Refuse fp64 on the fp32-chain Newton-Schulz tiers — shared by every
    public driver (``block_qr``, ``block_qr_qtb`` and thus ``lstsq``), so
    no entry point can silently demote a POLICY_FP64 request to fp32."""
    if jnp.dtype(policy.panel) == jnp.float64 and panel_method in _NS_TIERS:
        raise ValueError(
            f"panel_method {panel_method!r} runs fp32 NS chains and cannot "
            "honor POLICY_FP64; use 'householder' (or 'cholqr2', whose "
            "Cholesky path preserves the input dtype)"
        )


#: The quality ladder (mixed policies; its on-card numbers are in PERF.md):
#:   'fast'     -> bgs1  single-pass projections, compact bf16 Q
#:   'balanced' -> bgs2  BCGS2 reorth scrub in 3-pass bf16, fp32 Q
#:   'high'     -> bgs   BCGS2 reorth scrub in fp32, fp32 Q
#:   'robust'   -> householder (unconditionally Householder-grade
#:                 FACTORIZATION: R and backward error survive any
#:                 spectrum.  NOTE: under compact-Q policies its returned
#:                 Q stays policy-resident (bf16 -> the ~4.4e-4 storage
#:                 floor) — the reflector driver accumulates Q in q_store
#:                 throughout, so no final upcast could recover it.  For
#:                 returned-Q ORTHOGONALITY under mixed policies use
#:                 'high'; for both, use 'robust' with a non-compact
#:                 policy, e.g. POLICY_MIXED.)
#: Scale note (fp32 policies): 'fast' single-pass inter-group CGS drift
#: GROWS with n/r and crosses the 2^-23*m orthogonality criterion around
#: 16384^2; 'balanced'+ scrub it back to fp32-roundoff class.  The fp32
#: DEFAULT is 'high', so only an explicit quality='fast' opts into the
#: drift; mixed/bf16 criteria (2^-8*m) are never binding there.
QUALITY_LEVELS = ("fast", "balanced", "high", "robust")
_QUALITY_BGS = {"fast": "bgs1", "balanced": "bgs2", "high": "bgs"}


def resolve_panel_config(
    m: int,
    n: int,
    block_size: int,
    policy: DTypePolicy,
    panel_method: str,
    loop_mode: str,
    group_panels: int,
    mode: str = "reduced",
    platform: Optional[str] = None,
    quality: Optional[str] = None,
) -> Tuple[str, str, int]:
    """The library's dispatch table: resolve ``panel_method='auto'`` and
    apply the shape-fallback chain, returning the effective
    ``(panel_method, loop_mode, group_panels)``.

    ``cmd_bench`` and ``block_qr`` share it so the timed program is
    exactly the dispatched one.

    Auto dispatch on a GPU (``platform='gpu'``; default
    ``jax.default_backend()``):
      * fp64 policy or hostile shapes (r does not divide n, n < 2r) ->
        'householder' (the unconditionally robust tier);
      * fp32-class policies -> 'bgs' (BCGS2 reorth, fp32-roundoff
        orthogonality), scan mode above 12288;
      * mixed/bf16 policies -> 'bgs1' g8 up to 12288, grouped scan-mode
        'bgs1' g4 above; quality='balanced'/'high' pick 'bgs2'/'bgs' with
        the same size map.
    On any other platform auto resolves to 'householder' (CPU runs are the
    oracle surface; reference semantics).
    """
    if platform is None:
        platform = jax.default_backend()
    if quality is not None:
        if quality not in QUALITY_LEVELS:
            raise ValueError(
                f"quality must be one of {QUALITY_LEVELS}, got {quality!r}"
            )
        if panel_method != "auto":
            raise ValueError(
                "quality= is the auto-dispatch ladder knob; it cannot be "
                f"combined with an explicit panel_method={panel_method!r}"
            )
    r = min(block_size, n)
    if panel_method == "auto":
        hostile = n % r != 0 or n < 2 * block_size or m < n
        if (
            platform != "gpu"
            or hostile
            or jnp.dtype(policy.panel) == jnp.float64
            or quality == "robust"
        ):
            panel_method = "householder"
        elif jnp.dtype(policy.trailing) == jnp.float32:
            # fp32 policies default to the 'high' rung (fp32-roundoff
            # orthogonality); quality= can trade down for throughput.
            panel_method = _QUALITY_BGS["high" if quality is None else quality]
            if max(m, n) > 12288:
                loop_mode = "scan"
        else:
            panel_method = _QUALITY_BGS.get(quality, "bgs1")
            if max(m, n) <= 12288:
                group_panels = 8
            elif quality in ("balanced", "high"):
                loop_mode, group_panels = "scan", 4
            else:
                loop_mode = "scan"
    else:
        check_policy_method(policy, panel_method)

    # Shape-fallback chain (identical to the historic in-driver rules).
    if panel_method in ("bgs", "bgs1", "bgs2") and (
        n % r != 0
        or n < 2 * block_size
        or (mode == "complete" and m != n)
    ):
        # BGS materializes Q by concatenation (m x n); complete-Q for
        # m > n needs the orthogonal complement -> reflector driver.
        panel_method = "polar"
    if panel_method == "polar" and (n % r != 0 or n < 2 * block_size):
        panel_method = "cholqr1"  # the grouped driver needs r | n
    if loop_mode == "scan" and (
        n % r != 0
        or not (
            panel_method.startswith("cholqr")
            or panel_method in ("bgs", "bgs1", "bgs2")
        )
        or n <= block_size
    ):
        loop_mode = "unroll"  # scan needs r | n + a cholqr/bgs panel method
    return panel_method, loop_mode, group_panels


def _block_qr_traced(
    A: jax.Array,
    block_size: int,
    policy: DTypePolicy,
    want_q: bool,
    B: Optional[jax.Array],
    panel_method: str = "householder",
):
    """Trace-time body: unrolled panel loop with static slices.

    Returns (R_full (m x n, upper-triangular in top n rows), Q (m x m) or
    None, QtB or None).  ``B`` rides along through every left-update so the
    least-squares path never materializes Q (the reference's solver applies
    pinv(Q) explicitly instead, ``python/linear_least_sqare.py:10``).

    panel_method:
      * 'householder' — GVL reflector loop (robust; exact reference
        semantics); applications use the compact-WY (V, T) factors.
      * 'cholqr1' / 'cholqr2' / 'cholqr2s' — (1-pass / 2-pass / shifted)
        CholeskyQR panel: all-GEMM; applications use the Yamamoto block
        reflector (Y, Sinv) with a Newton-Schulz S-inverse.  Low-aspect
        panels fall back to Householder (hybrid rule below).
      * 'cholqr1x2' — paired panels merged into one 2r-wide reflector
        (fewer large GEMMs).
    """
    m, n = A.shape
    r = min(block_size, n)
    A = A.astype(policy.panel)
    q_dtype = policy.q_store or policy.accum
    Q = jnp.eye(m, dtype=q_dtype) if want_q else None
    mm_t = lambda a, b: matmul(a, b, in_dtype=policy.trailing,
                               accum_dtype=policy.accum)
    mm_q = lambda a, b: matmul(a, b, in_dtype=policy.q_update,
                               accum_dtype=policy.accum)
    # NaN funnel into the poison canary: a rank-deficient panel NaNs its
    # Cholesky (or the Yamamoto S-inverse), but a MID-matrix breakdown
    # never reaches R[0,0] on its own — panel 0's R block is written
    # before the NaN exists, so `check='sync'` and checked_qr missed it
    # (round-7 battery: zero column at 300 of 512 left R[0,0] finite with
    # NaN R/Q bodies).  `sum(X * 0)` is 0 for finite X and NaN otherwise
    # (0*inf = 0*NaN = NaN), costs one r x r elementwise pass per panel,
    # and _poison_if_unconverged(NaN) poisons (NaN < tol is False).
    worst_resid = jnp.float32(0.0)

    def _sub_reflector(cols, lam_, w_):
        """CholeskyQR1 + Yamamoto of one sub-panel (rows lam_:, given the
        already-updated column block ``cols`` of height m - lam_)."""
        Q_red, Rp = cholesky_qr2(cols, passes=1)
        Y, Sinv, Rp = yamamoto_reflector(Q_red, Rp, inv_method="newton")
        return Y, Sinv, Rp

    pair_mode = panel_method == "cholqr1x2"
    base_method = "cholqr1" if pair_mode else panel_method

    lam = 0
    while lam < n:
        w = min(r, n - lam)

        # --- paired-panel fast path ("cholqr1x2"): factor two adjacent
        # r-wide panels, merge their Yamamoto reflectors into one 2r-wide
        # block reflector (H1 H2 = I - Yc Sc Yc^T with
        # Sc = [[S1, -S1 (Y1^T Y2) S2], [0, S2]]), and apply trailing/Q/B
        # updates ONCE — halving the count of the large GEMMs.
        if (
            pair_mode
            and w == r
            and lam + 2 * r <= n
            and (m - lam - r) >= 2 * r  # sub-panel 2 stays tall (aspect>=2)
        ):
            P1 = A[lam:, lam : lam + r]
            Y1, S1, R1 = _sub_reflector(P1, lam, r)
            A = A.at[lam:, lam : lam + r].set(
                jnp.concatenate(
                    [R1, jnp.zeros((m - lam - r, r), A.dtype)], axis=0
                ).astype(A.dtype)
            )
            # Update only the sibling panel's columns with H1^T.
            C = A[lam:, lam + r : lam + 2 * r]
            G1 = mm_t(Y1.T, C)
            C = C - mm_t(Y1, jnp.matmul(S1.T, G1, precision=_HI))
            # Sub-panel 2 lives on rows lam+r: (static slice).
            Y2b, S2, R2 = _sub_reflector(C[r:, :], lam + r, r)
            A = A.at[lam:, lam + r : lam + 2 * r].set(
                jnp.concatenate(
                    [C[:r, :], R2, jnp.zeros((m - lam - 2 * r, r), A.dtype)],
                    axis=0,
                ).astype(A.dtype)
            )
            Y2 = jnp.concatenate(
                [jnp.zeros((r, r), Y2b.dtype), Y2b], axis=0
            )
            # Merge: Sc upper block = -S1 (Y1^T Y2) S2.
            cross = jnp.matmul(
                jnp.matmul(S1, mm_t(Y1.T, Y2), precision=_HI),
                S2, precision=_HI,
            )
            Yc = jnp.concatenate([Y1, Y2], axis=1)       # (m-lam, 2r)
            Sc = jnp.concatenate(
                [
                    jnp.concatenate([S1, -cross], axis=1),
                    jnp.concatenate([jnp.zeros((r, r), S2.dtype), S2], axis=1),
                ],
                axis=0,
            )
            worst_resid = jnp.maximum(
                worst_resid,
                jnp.sum(Sc * 0.0) + jnp.sum(R1 * 0.0) + jnp.sum(R2 * 0.0),
            )

            if lam + 2 * r < n:
                C2 = A[lam:, lam + 2 * r :]
                G = mm_t(Yc.T, C2)
                C2 = C2 - mm_t(Yc, jnp.matmul(Sc.T, G, precision=_HI))
                A = A.at[lam:, lam + 2 * r :].set(C2.astype(A.dtype))
            if B is not None:
                Bl = B[lam:, :]
                Gb = mm_t(Yc.T, Bl)
                Bl = Bl - mm_t(Yc, jnp.matmul(Sc.T, Gb, precision=_HI))
                B = B.at[lam:, :].set(Bl.astype(B.dtype))
            if want_q:
                Qc = Q[:, lam:]
                XY = mm_q(Qc, Yc)
                Qc = Qc - mm_q(jnp.matmul(XY, Sc, precision=_HI), Yc.T)
                Q = Q.at[:, lam:].set(Qc.astype(q_dtype))
            lam += 2 * r
            continue

        panel = A[lam:, lam : lam + w]

        # CholeskyQR squares the panel's condition number; tall random
        # panels are safe (cond ~ O(1-10)) but the FINAL panel of a square
        # matrix is square and ill-conditioned — its Gram breaks fp32
        # Cholesky.  Hybrid rule: any panel with aspect < 2 falls back to
        # the Householder panel (static per-panel decision, zero overhead).
        pm = base_method
        if pm.startswith("cholqr") and (m - lam) < 2 * w:
            pm = "householder"

        if pm == "householder":
            V, T, Rp = panel_factor(panel)
            A = A.at[lam:, lam : lam + w].set(Rp)
            # Funnel Rp, not (only) T: panel_factor's masked reflector
            # arithmetic SWALLOWS an input NaN into finite V/T while the
            # NaN stays in Rp (measured: NaN at [3,5] of a 256^2 gave
            # finite V/T and NaN Rp).
            worst_resid = jnp.maximum(
                worst_resid, jnp.sum(Rp * 0.0) + jnp.sum(T * 0.0)
            )

            def left(X):
                return apply_block_reflector_left_t(X, V, T, policy)

            def right(X):
                return apply_block_reflector_right(X, V, T, policy)

        elif pm in ("cholqr1", "cholqr2", "cholqr2s"):
            # cholqr1: single orthogonalization pass + Newton-Schulz S
            # inverse — all small ops become GEMMs; panel orthogonality
            # ~cond^2*eps_f32, below bf16 noise (mixed-policy fast path).
            Q_red, Rp = cholesky_qr2(
                panel,
                shifted=pm == "cholqr2s",
                passes=1 if pm == "cholqr1" else 2,
            )
            # Newton-Schulz S-inverse — aspect-scaled iterations with a
            # residual-checked LU fallback on squarer panels, where
            # sigma_min(S) can be small (see newton_iters_for_aspect).
            Y, Sinv, Rp = yamamoto_reflector(
                Q_red, Rp, inv_method="newton",
                check=(m - lam) < 4 * w,
            )
            pad = jnp.zeros((m - lam - w, w), A.dtype)
            A = A.at[lam:, lam : lam + w].set(
                jnp.concatenate([Rp.astype(A.dtype), pad], axis=0)
            )
            worst_resid = jnp.maximum(
                worst_resid, jnp.sum(Sinv * 0.0) + jnp.sum(Rp * 0.0)
            )

            def left(X):
                # H^T X = X - Y Sinv^T (Y^T X)
                G = mm_t(Y.T, X)
                return X - mm_t(Y, jnp.matmul(Sinv.T, G, precision=_HI))

            def right(X):
                # X H = X - ((X Y) Sinv) Y^T
                XY = mm_q(X, Y)
                return X - mm_q(jnp.matmul(XY, Sinv, precision=_HI), Y.T)

        else:
            raise ValueError(f"unknown panel_method {pm!r}")

        if lam + w < n:
            C = A[lam:, lam + w :]
            A = A.at[lam:, lam + w :].set(left(C).astype(A.dtype))

        if B is not None:
            Bl = B[lam:, :]
            B = B.at[lam:, :].set(left(Bl).astype(B.dtype))

        if want_q:
            Qc = Q[:, lam:]
            Q = Q.at[:, lam:].set(right(Qc).astype(q_dtype))

        lam += w

    R_full = jnp.triu(A.astype(policy.accum))
    R_full, Q, B = _poison_if_unconverged(worst_resid, R_full, Q, B)
    return R_full, Q, B


def _block_qr_scan(
    A: jax.Array,
    block_size: int,
    policy: DTypePolicy,
    want_q: bool,
    B: Optional[jax.Array],
    panel_method: str = "cholqr1",
):
    """Scan-mode driver: ONE compiled panel step iterated by ``fori_loop``.

    The unrolled driver compiles n/r distinct panel programs (minutes at
    8192^2); here every panel shares one step:
    the CholeskyQR panel is masked to rows >= lam, the Yamamoto reflector is
    applied FULL-WIDTH (finished columns are invariant — Y has no support on
    their nonzero rows — and the panel columns become [R; 0] exactly), so no
    slice-and-scatter bookkeeping exists.  The final panel (square,
    CholeskyQR-hostile) runs statically through the Householder panel.

    Requires n % block_size == 0 (caller falls back to unrolled otherwise).
    """
    m, n = A.shape
    r = block_size
    A = A.astype(policy.panel)
    q_dtype = policy.q_store or policy.accum
    Q = jnp.eye(m, dtype=q_dtype) if want_q else None
    mm_t = lambda a, b: matmul(a, b, in_dtype=policy.trailing,
                               accum_dtype=policy.accum)
    mm_q = lambda a, b: matmul(a, b, in_dtype=policy.q_update,
                               accum_dtype=policy.accum)
    rows = jax.lax.broadcasted_iota(jnp.int32, (m, 1), 0)[:, 0]

    def panel_step(k, carry):
        A, Q, B = carry
        lam = k * r
        P = jax.lax.dynamic_slice(A, (0, lam), (m, r))
        P = jnp.where(rows[:, None] >= lam, P, 0.0)
        Q_red, _ = cholesky_qr2(
            P, shifted=panel_method == "cholqr2s",
            passes=1 if panel_method == "cholqr1" else 2,
        )
        # Yamamoto reflector anchored at global row lam.
        Q1 = jax.lax.dynamic_slice(Q_red, (lam, 0), (r, r))
        D = jnp.where(jnp.diag(Q1) > 0, -1.0, 1.0).astype(Q_red.dtype)
        Qs = Q_red * D[None, :]
        e1 = (
            (rows[:, None] - lam)
            == jax.lax.broadcasted_iota(jnp.int32, (m, r), 1)
        ).astype(Qs.dtype)
        Y = Qs - e1
        S = jnp.eye(r, dtype=Qs.dtype) - (Q1 * D[None, :]).T
        # ONE program serves every panel, so size the Newton chain for the
        # squarest in-loop panel (aspect can reach 2; sigma_min(S) can be
        # small there) and arm the residual-checked fallback.
        Sinv = newton_inv(S, iters=12, check=True)
        # Full-width left update A <- H^T A.
        G = mm_t(Y.T, A)
        A = (A - mm_t(Y, jnp.matmul(Sinv.T, G, precision=_HI))).astype(A.dtype)
        if B is not None:
            Gb = mm_t(Y.T, B)
            B = (B - mm_t(Y, jnp.matmul(Sinv.T, Gb, precision=_HI))).astype(
                B.dtype
            )
        if Q is not None:
            QY = mm_q(Q, Y)
            Q = (Q - mm_q(jnp.matmul(QY, Sinv, precision=_HI), Y.T)).astype(
                q_dtype
            )
        return A, Q, B

    nb = n // r
    dummy = jnp.zeros((1, 1), A.dtype)
    carry = (A, Q if want_q else dummy, B if B is not None else dummy)

    def wrapped(k, c):
        a, q, b = c
        a2, q2, b2 = panel_step(
            k, (a, q if want_q else None, b if B is not None else None)
        )
        return a2, (q2 if want_q else q), (b2 if B is not None else b)

    # All but the last panel via the scan; the final (aspect-1) panel runs
    # statically with the robust Householder factorization.
    A, Qc, Bc = jax.lax.fori_loop(0, nb - 1, wrapped, carry)
    Q = Qc if want_q else None
    B = Bc if B is not None else None

    lam = n - r
    V, T, Rp = panel_factor(A[lam:, lam:])
    A = A.at[lam:, lam:].set(Rp)
    if B is not None:
        B = B.at[lam:, :].set(
            apply_block_reflector_left_t(B[lam:, :], V, T, policy).astype(
                B.dtype
            )
        )
    if want_q:
        Qc = apply_block_reflector_right(
            Q[:, lam:].astype(policy.accum), V, T, policy
        )
        Q = Q.at[:, lam:].set(Qc.astype(q_dtype))

    R_full = jnp.triu(A.astype(policy.accum))
    return R_full, Q, B


def _block_qr_grouped(
    A: jax.Array,
    block_size: int,
    policy: DTypePolicy,
    want_q: bool,
    B: Optional[jax.Array],
    group_panels: int = 4,
    polar_iters: Optional[int] = None,
):
    """Aggregated-panel driver: triangular-NS panels + W-form merged block
    reflectors.

    Two structural changes vs ``_block_qr_traced``'s cholqr1 path:

    1. **No triangular library calls anywhere.**  Each panel is factored by
       the triangular Newton-Schulz inverse Cholesky (``ops/polar.py::
       tri_cholqr``): chained matmuls in place of the chol +
       solve_triangular library calls — and R comes out upper-triangular
       directly (X^{-1} = X^T G), so there is no deferred fixup either.
       The square tail panels use the same iteration with extra +
       refinement (CholeskyQR2-style) passes.

    2. **W-form reflectors, merged per group.**  Each panel's Yamamoto
       reflector is folded to ``H = I - W Y^T`` (W = Y S^{-1}, one tall
       GEMM), so every application is 2 GEMMs instead of 3, and ``group_
       panels`` consecutive reflectors are merged
       (``H_a H_b = I - [W_a, W_b - W_a (Y_a^T W_b)] [Y_a, Y_b]^T``) so the
       trailing matrix, B, and Q are each touched ONCE per group — cutting
       both wide-GEMM count and HBM passes by the group factor.  Inside a
       group, panels eagerly update only the group's own columns (narrow).

    Requires n % block_size == 0 and m >= n (``block_qr`` falls back to the
    unrolled driver otherwise).  Like cholqr1 this is a fast path whose
    Gram squares the panel condition number (tail panels get iteration
    headroom for cond(P) ~ 1e3-class); 'householder' remains the
    unconditionally robust default.
    """
    from mixedprecisionblockqr_tpu.ops.polar import (
        tri_cholqr,
        tri_iters_for_aspect,
    )

    m, n = A.shape
    r = block_size
    nb = n // r
    assert n % r == 0 and m >= n
    A = A.astype(policy.panel)
    worst_resid = jnp.float32(0.0)
    q_dtype = policy.q_store or policy.accum
    Q = jnp.eye(m, dtype=q_dtype) if want_q else None
    mm_t = lambda a, b: matmul(a, b, in_dtype=policy.trailing,
                               accum_dtype=policy.accum)
    mm_q = lambda a, b: matmul(a, b, in_dtype=policy.q_update,
                               accum_dtype=policy.accum)

    i = 0
    while i < nb:
        lam_g = i * r
        n_group = min(group_panels, nb - i)
        js = list(range(i, i + n_group))
        g_end = (js[-1] + 1) * r
        Yg = Wg = None
        for j in js:
            lam = j * r
            P = A[lam:, lam : lam + r]
            # Tall panels: plain iteration.  Tail panels (aspect < 2, incl.
            # the square final block, cond(G) up to ~1e5-class on random
            # inputs): extra iterations + a refinement pass.
            tail = (m - lam) < 2 * r
            if tail:
                # Square-ish tail panels inherit the trailing corner's
                # conditioning: shifted three-pass scheme (convergent for
                # any input, reconstruction-exact).
                from mixedprecisionblockqr_tpu.ops.polar import (
                    tri_cholqr_robust,
                )

                Qs, t, _, rresid = tri_cholqr_robust(P, return_resid=True)
                # robust-tail residuals carry the 1e-2 breakdown
                # threshold: pre-scaled 1e-2 against the shared 1e-4 tol
                # (see _poison_if_unconverged).
                worst_resid = jnp.maximum(worst_resid, 0.01 * rresid)
            else:
                iters = (
                    polar_iters
                    if polar_iters is not None
                    else tri_iters_for_aspect((m - lam) / r)
                )
                if lam == 0:
                    # Head panel factors RAW data — correlated inputs give
                    # it an outlier-spectrum Gram the aspect budget cannot
                    # converge (ops/polar.py::tri_head_iters; later panels
                    # see trailing-updated, decorrelated columns).
                    from mixedprecisionblockqr_tpu.ops.polar import (
                        tri_head_iters,
                    )

                    iters = tri_head_iters(iters)
                Qs, t, _, resid = tri_cholqr(
                    P, iters=iters, check=False, return_resid=True
                )
                # one-behind correction: squared = estimated true residual
                # (the _poison_if_unconverged convention)
                worst_resid = jnp.maximum(worst_resid, resid * resid)
            if m - lam == r:
                # SQUARE final panel: H = Qs exactly.  The Yamamoto S =
                # I - Qs^T of a fully-orthogonal Qs can be (near-)singular
                # — the newton_inv breakdown domain — so express H in the
                # same W-form directly: I - W Y^T = Qs with Y = I,
                # W = I - Qs (no inversion at all).
                Y = jnp.eye(r, dtype=Qs.dtype)
                W = Y - Qs
            else:
                rows = jax.lax.broadcasted_iota(jnp.int32, (m - lam, r), 0)
                cols = jax.lax.broadcasted_iota(jnp.int32, (m - lam, r), 1)
                Y = Qs - (rows == cols).astype(Qs.dtype)
                S = jnp.eye(r, dtype=Qs.dtype) - Qs[:r, :].T
                # sigma_min(S) shrinks as panels get squarer and Newton
                # under-converges silently (measured: aspect-2 corner panel
                # sigma_min 0.236, 5-iter residual 8e-5 -> Q orth 2.2e-4).
                # Aspect-scaled iterations keep tall panels on the short
                # chain; the residual-checked LU fallback (one extra GEMM)
                # only arms on aspect < 4 panels.
                aspect = (m - lam) / r
                from mixedprecisionblockqr_tpu.ops.cholqr import (
                    newton_iters_for_aspect,
                )

                ni = newton_iters_for_aspect(aspect)
                Sinv = newton_inv(S, iters=ni, check=aspect < 4)
                W = jnp.matmul(Y, Sinv, precision=_HI)
            A = A.at[lam:, lam : lam + r].set(
                jnp.concatenate(
                    [t, jnp.zeros((m - lam - r, r), jnp.float32)], 0
                ).astype(A.dtype)
            )
            if lam + r < g_end:  # eager update of the group's own cols
                C = A[lam:, lam + r : g_end]
                C = C - mm_t(Y, mm_t(W.T, C))
                A = A.at[lam:, lam + r : g_end].set(C.astype(A.dtype))
            pad = lam - lam_g
            if pad:
                z = jnp.zeros((pad, r), jnp.float32)
                Yj = jnp.concatenate([z, Y], 0)
                Wj = jnp.concatenate([z, W], 0)
            else:
                Yj, Wj = Y, W
            if Yg is None:
                Yg, Wg = Yj, Wj
            else:
                # H_g H_j = I - [Wg, Wj - Wg (Yg^T Wj)] [Yg, Yj]^T
                Wj = Wj - mm_t(Wg, mm_t(Yg.T, Wj))
                Yg = jnp.concatenate([Yg, Yj], 1)
                Wg = jnp.concatenate([Wg, Wj], 1)
        if g_end < n:
            C = A[lam_g:, g_end:]
            C = C - mm_t(Yg, mm_t(Wg.T, C))
            A = A.at[lam_g:, g_end:].set(C.astype(A.dtype))
        if B is not None:
            Bl = B[lam_g:, :]
            Bl = Bl - mm_t(Yg, mm_t(Wg.T, Bl))
            B = B.at[lam_g:, :].set(Bl.astype(B.dtype))
        if want_q:
            Qc = Q[:, lam_g:]
            Qc = Qc - mm_q(mm_q(Qc, Wg), Yg.T)
            Q = Q.at[:, lam_g:].set(Qc.astype(q_dtype))
        i = js[-1] + 1

    R_full = jnp.triu(A.astype(policy.accum))

    R_full, Q, B = _poison_if_unconverged(worst_resid, R_full, Q, B)
    return R_full, Q, B


def _sync_retry_method(panel_method, loop_mode, policy, mode, m, n):
    """The robust retry target for ``check='sync'`` — or None when the
    primary method already IS the most robust one available for its loop
    mode (retrying would repeat the same program).

    Unrolled: 'householder' (exact for any input incl. rank-deficient —
    reflector zero-norm skip).  Scan: the Householder loop would re-create
    the compile explosion scan exists to avoid, so the all-robust scan-BGS
    tier (shifted three-pass chains — converges for any FULL-RANK
    spectrum; exactly singular inputs still poison and the caller raises
    with the fix named); 'cholqr2s' where BGS's shape/policy contract
    doesn't hold (complete-Q with m > n, fp64)."""
    if loop_mode == "scan":
        bgs_ok = (mode != "complete" or m == n) and (
            jnp.dtype(policy.panel) != jnp.float64
        )
        retry = "bgs" if bgs_ok else "cholqr2s"
    else:
        retry = "householder"
    return None if retry == panel_method else retry


def _poison_if_unconverged(worst_resid, R_full, Q, B, tol: float = 1e-4):
    """Fail LOUDLY instead of silently wrong: when any panel's NS residual
    exceeds ``tol`` (correlated data can out-cond the fixed iteration
    budgets — the reference's positive-uniform generator does), write a
    NaN CANARY into R[0,0] / Q[0,0] / B[0,0].

    ``worst_resid`` convention (round-5b): contributors normalize to an
    ESTIMATED TRUE residual before aggregation — robust chains report
    their exact final residual x 1e-2 (their healthy range is looser),
    plain chains report the free one-behind correction SQUARED (the
    quadratic final step means true ~= one-behind^2; the raw one-behind
    over-reports by orders of magnitude on converged structured panels —
    measured 1.3e-4 one-behind vs 2e-7 true — and falsely poisoned every
    Bierlaire-conditioned draw, while a stalled chain at 6e-2 still
    squares to 3.6e-3 >> tol and trips).  The PUBLIC drivers
    (``block_qr``/``block_qr_qtb``) detect it with one scalar fetch and
    transparently retry via the direct-Cholesky driver; in-jit callers can
    detect it with ``utils.checks.checked_qr`` (the canary is a signal,
    not full propagation).

    Why this shape: a ``lax.cond`` whose branches carry the m x m buffers
    copies its captured operands, and a per-panel cond or a diag-wide NaN
    scatter costs far more than the single-element updates used here.
    """
    bad = jnp.where(worst_resid < tol, 0.0, jnp.float32(jnp.nan))
    R_full = R_full.at[0, 0].add(bad.astype(R_full.dtype))
    if Q is not None:
        Q = Q.at[0, 0].add(bad.astype(Q.dtype))
    if B is not None:
        B = B.at[0, 0].add(bad.astype(B.dtype))
    return R_full, Q, B


def _rescrub_panel(Qpre, qk, t, *, platform: str, psum_axis=None):
    """The corner-leak rescrub (docs/ALGORITHMS.md D9), shared by all four
    BGS drivers (single-chip unrolled/scan, distributed unrolled/scan —
    the dist mirrors pass ``psum_axis`` and every cross-device reduction
    happens here, keeping the math literally identical across drivers).

    The pre-factorization BCGS2 scrub leaves ``O(eps)`` components along
    previous Q; the ill-conditioned trailing-corner factorization then
    amplifies them by ~kappa(P) (measured: every Q^T Q block at fp32
    roundoff EXCEPT the tail panel's cross terms, uniformly ~5e-5 at
    1024^2 — more NS iterations cannot move it).  One projection of the
    FINISHED panel plus a 4-iteration refactorization of the
    nearly-orthonormal remainder folds exactly:

        qk t = q2 (s t) + Qpre (W t)

    so R gains ``W t`` above the diagonal block and ``s t`` replaces it.
    All dots fp32 HIGHEST — the rescrub runs once per tail panel, so its
    precision is not a throughput knob (an earlier HIGH variant on the
    bgs2 rung saved ~nothing and forked the tiers' quality).

    ``Qpre`` may contain zero columns (scan buffers): their W rows are
    exactly zero, so the fold stays upper triangular.  Returns
    ``(q2, s @ t, W @ t, resid)``.
    """
    qf = qk.astype(jnp.float32)
    Qp = Qpre.astype(jnp.float32)
    W = jnp.matmul(Qp.T, qf, precision=_HI,
                   preferred_element_type=jnp.float32)
    if psum_axis is not None:
        W = jax.lax.psum(W, psum_axis)
    q2 = qf - jnp.matmul(Qp, W, precision=_HI,
                         preferred_element_type=jnp.float32)
    Gq = jnp.matmul(q2.T, q2, precision=_HI,
                    preferred_element_type=jnp.float32)
    if psum_axis is not None:
        Gq = jax.lax.psum(Gq, psum_axis)
    X, s, rs = chain_for(platform)(Gq, 4)
    q2 = jnp.matmul(q2, X, precision=_HI,
                    preferred_element_type=jnp.float32)
    t32 = t.astype(jnp.float32)
    return (q2, jnp.matmul(s, t32, precision=_HI),
            jnp.matmul(W, t32, precision=_HI), rs)


def _block_qr_bgs(
    A: jax.Array,
    block_size: int,
    policy: DTypePolicy,
    want_q: bool,
    B: Optional[jax.Array],
    group_panels: int = 4,
    platform: str = "cpu",
    reorth: bool = True,
    robust_tail: Optional[int] = None,
    mid_tier: bool = False,
):
    """Right-looking Block Gram-Schmidt QR — the throughput flagship
    (``panel_method='bgs'``).

    The reflector drivers spend most of their time on op COUNT and on
    Q-accumulation GEMMs.  BGS removes both classes structurally:

      * panels keep FULL height, so every Gram has aspect m/r (short
        triangular-NS chains, no Yamamoto S / Newton inverse / reflector
        merge at all),
      * **Q materializes by concatenation** — zero Q-update GEMMs (for
        m == n the reduced Q IS the complete Q: the bench config),
      * R rows are written directly (diagonal t + the projection
        coefficients), no triangularization epilogue,
      * the trailing projection runs once per GROUP with the concatenated
        group Q (a few large well-shaped GEMMs instead of many shrinking
        ones); inside a group only the group's own columns update eagerly.

    Each panel is a tall Gram and ``Q = P X`` as XLA GEMMs around one r x r
    triangular-NS chain (``chain_for(platform)``: one kernel on a GPU at
    r <= 64).

    Numerics: plain one-pass BCGS loses inter-block orthogonality like
    eps_trailing * kappa(A)..kappa(A)^2 — matrix-dependent and fragile —
    so by default (``reorth=True``, BCGS2-style) each GROUP's columns are
    re-projected against ALL previous Q once at group start (two extra
    GEMMs per group; the scrubbed coefficients fold into R so the
    reconstruction stays exact), restoring eps_trailing-class
    orthogonality with only in-group single-pass drift (bounded by the
    group width).  Late panels inherit the trailing corner's conditioning:
    the shifted three-pass factorization takes over there.  The reflector
    paths ('polar', 'householder') remain the unconditionally
    Householder-grade tier.

    Requires n % block_size == 0, m >= n; complete mode only for m == n
    (``block_qr`` falls back otherwise).
    """
    from mixedprecisionblockqr_tpu.ops.polar import (
        tri_head_iters,
        tri_iters_for_aspect,
        tri_robust_panel,
    )

    chain = chain_for(platform)
    m, n = A.shape
    r = block_size
    nb = n // r
    base_iters = tri_iters_for_aspect(m / r)

    def _plain_iters(j: int) -> int:
        # Panel 0 factors RAW (unprojected) data: correlated inputs (the
        # reference's positive-uniform generator, Jacobians) give it an
        # outlier-spectrum Gram ~1e3 cond that the aspect budgets cannot
        # converge — the head boost covers it (ops/polar.py::
        # tri_head_iters; every later panel is projected first and drops
        # to O(1) cond).
        if j == 0:
            return tri_head_iters(base_iters)
        return base_iters if j < 0.75 * nb else base_iters + 4
    # Robust-tail count (the shifted three-pass chain on the last panels):
    # ~1 per 12 panels, minimum 1, on tall problems; SQUARISH problems
    # (panel aspect m/r < 8) keep max(2, nb // 8) — there every panel's
    # Gram is low-aspect/ill-conditioned and trimming robustness leaks
    # orthogonality past the fp32 criterion (256^2 sweep).  The NaN canary
    # + public-driver retry guard hostile spectra loudly.
    if robust_tail is not None:
        n_robust = robust_tail
    elif m / r >= 8:
        n_robust = max(1, nb // 12)
    else:
        n_robust = max(2, nb // 8)
    # want_q yields the (m, n) concatenated Q — the reduced factor; for
    # m == n that IS the complete Q (block_qr guards complete-mode m > n).
    assert n % r == 0 and m >= n
    # The working set is a SHRINKING trailing carry ``T`` (columns not yet
    # factored), never an in-place update of A: mutating the jit input
    # forces XLA to clone the full (m, n) parameter buffer and every
    # trailing update then rewrites the whole buffer instead of its live
    # suffix.  Each group peels its columns off the front of T and the
    # group projection produces the next, narrower T.
    T = A.astype(policy.panel)
    worst_resid = jnp.float32(0.0)
    mm_t = lambda a, b: matmul(a, b, in_dtype=policy.trailing,
                               accum_dtype=policy.accum)
    # Reorth tiers: ALL in-group dots fp32 HIGHEST — single-pass bf16
    # in-group projections floor orth at ~2^-11 no matter how precise the
    # scrub is.  INTER-group trailing projections stay mm_t by design: the
    # next group's scrub runs above that noise (BCGS2).
    mm_e = (
        (lambda a, b: jnp.matmul(
            a.astype(jnp.float32), b.astype(jnp.float32), precision=_HI,
            preferred_element_type=jnp.float32))
        if reorth else mm_t
    )
    gram_prec = (
        _HI
        if jnp.dtype(policy.trailing) == jnp.float32 or mid_tier or reorth
        else BF16_X3
    )
    R = jnp.zeros((n, n), jnp.float32)
    qtb = [] if B is not None else None
    qcols = []
    # Reorth tiers ('bgs'/'bgs2', the quality-ladder rungs) return Q at
    # accumulation precision: their whole point is orthogonality, and a
    # bf16 Q residency rounds every entry to 2^-9 — max|Q^T Q - I| lands
    # exactly at the bf16 STORAGE floor (~4.4e-4 at 2048) no matter how
    # precise the scrub was.  The compact q_store residency is the bgs1
    # traffic lever; the ladder pays fp32 output for its quality.
    q_dtype = policy.accum if reorth else (policy.q_store or policy.accum)
    # Fast tiers under a compact q_store cast each panel's Q ONCE: the
    # inter-group projection (mm_t) and the Q assembly both consume that
    # same compact buffer.  The casts only commute when the projections
    # would cast to q_store precision ANYWAY — i.e. policy.trailing ==
    # q_store (all the built-in _FAST policies).  A custom policy with
    # fp32 trailing + compact q_store must keep fp32 Q for its
    # projections/Q^T B and cast only at assembly.
    cast_early = (
        not reorth
        and jnp.dtype(q_dtype) != jnp.dtype(policy.accum)
        and jnp.dtype(policy.trailing) == jnp.dtype(q_dtype)
    )
    # Fast tiers assemble Q by in-place DUS into one preallocated buffer
    # instead of a final jnp.concatenate (which XLA lowers to full-size
    # pads plus a combine).  Reorth tiers keep the qcols list — their
    # per-group scrubs need the concatenated prefix anyway.
    Qacc = jnp.zeros((m, n), q_dtype) if (want_q and not reorth) else None

    i = 0
    while i < nb:
        lam_g = i * r
        js = list(range(i, min(i + group_panels, nb)))
        g_end = (js[-1] + 1) * r
        gw = g_end - lam_g
        # Peel this group's columns off the trailing carry.
        Pbuf, T = T[:, :gw], T[:, gw:]
        if reorth and lam_g > 0:
            # BCGS2-style group re-projection: scrub what the single-pass
            # trailing projections left behind on this group's columns
            # before any of its panels factor.  The scrub must run ABOVE
            # the noise it scrubs: at trailing (bf16) precision the
            # leftover is ~2^-8-class and the reorth tiers' orth floor
            # stays no better than bgs1.  bgs2 scrubs in 3-pass bf16
            # (BF16_X3, ~2^-16 class — the mid cost/quality point), bgs in
            # fp32 (HIGHEST).
            Qprev = jnp.concatenate(qcols, axis=1)
            Cg = Pbuf.astype(jnp.float32)
            rp = BF16_X3 if mid_tier else _HI
            C2 = jnp.matmul(Qprev.T, Cg, precision=rp,
                            preferred_element_type=jnp.float32)
            Pbuf = (Cg - jnp.matmul(Qprev, C2, precision=rp,
                                    preferred_element_type=jnp.float32)
                    ).astype(Pbuf.dtype)
            R = R.at[:lam_g, lam_g:g_end].add(C2)
        # qcols holds one entry per panel: record where this group's start.
        q_start = len(qcols)
        for j in js:
            lam = j * r
            c0 = lam - lam_g  # column offset within the group buffer
            P = Pbuf[:, c0 : c0 + r]
            if j >= nb - n_robust:
                # The last panel(s) inherit the trailing corner's
                # conditioning (cond(G) can reach 1e5-1e8): shifted
                # three-pass scheme, convergent for any input.
                Qk, t, rresid = tri_robust_panel(P, chain)
                # robust-tail residuals carry the 1e-2 breakdown threshold:
                # pre-scaled 1e-2 against the shared 1e-4 tol.
                worst_resid = jnp.maximum(worst_resid, 0.01 * rresid)
                if reorth and qcols:
                    # Post-factorization rescrub (the shared D9 helper).
                    q2, t, dW, rs = _rescrub_panel(
                        jnp.concatenate(qcols, axis=1), Qk, t,
                        platform=platform)
                    worst_resid = jnp.maximum(worst_resid, rs * rs)
                    R = R.at[:lam, lam : lam + r].add(dW)
                    Qk = q2
            else:
                G = jnp.matmul(P.T, P, precision=gram_prec,
                               preferred_element_type=jnp.float32)
                X, t, resid = chain(G, _plain_iters(j))
                Qk = jnp.matmul(P, X, precision=gram_prec,
                                preferred_element_type=jnp.float32)
                # One-behind correction: squared = estimated true residual.
                worst_resid = jnp.maximum(worst_resid, resid * resid)
            R = R.at[lam : lam + r, lam : lam + r].set(t)
            if lam + r < g_end:  # eager projection of the group's own cols
                C = Pbuf[:, c0 + r :]
                G1 = mm_e(Qk.T, C)
                # .at.set on the INTERNAL group buffer is an in-place DUS
                # (the old Pbuf is dead here) — only the live suffix is
                # rewritten, and the jit parameter A is never cloned.
                Pbuf = Pbuf.at[:, c0 + r :].set(
                    (C - mm_e(Qk, G1)).astype(Pbuf.dtype)
                )
                R = R.at[lam : lam + r, lam + r : g_end].set(G1)
            if cast_early:
                Qk = Qk.astype(q_dtype)
            if B is not None:
                qtb.append(mm_t(Qk.T, B))
            if Qacc is not None:
                Qacc = Qacc.at[:, lam : lam + r].set(Qk.astype(q_dtype))
            qcols.append(Qk)
        if g_end < n:
            # one wide projection per group with the concatenated group Q
            Qg = jnp.concatenate(qcols[q_start:], axis=1)
            G1 = mm_t(Qg.T, T)
            T = (T - mm_t(Qg, G1)).astype(T.dtype)
            R = R.at[lam_g:g_end, g_end:].set(G1)
        i = js[-1] + 1

    R_full = (
        jnp.concatenate([R, jnp.zeros((m - n, n), R.dtype)], 0)
        if m > n else R
    )
    # No jnp.triu here (a full n x n mask pass): unlike the in-A drivers
    # (whose below-diagonal holds reflector or trailing junk and MUST be
    # masked), this R is assembled from exact pieces — zeros init, r x r
    # diagonal blocks that every chain masks before returning, and
    # strictly-above-diagonal projection blocks.  Guarded by
    # tests/test_blockqr.py::test_bgs_r_exactly_triangular.
    R_full = R_full.astype(policy.accum)
    if Qacc is not None:
        Q = Qacc
    else:
        Q = (jnp.concatenate(qcols, axis=1).astype(q_dtype)
             if want_q else None)
    Bout = jnp.concatenate(qtb, axis=0) if B is not None else None

    R_full, Q, Bout = _poison_if_unconverged(worst_resid, R_full, Q, Bout)
    return R_full, Q, Bout


def _block_qr_bgs_scan(
    A: jax.Array,
    block_size: int,
    policy: DTypePolicy,
    want_q: bool,
    B: Optional[jax.Array],
    platform: str = "cpu",
    reorth: bool = True,
    group_panels: int = 1,
    reorth_grouped: bool = False,
):
    """Scan-mode Block Gram-Schmidt: ONE compiled panel step, classical-GS
    projections against a preallocated Q buffer.

    ``group_panels > 1`` runs a GROUPED scan (round-4): each fori step
    factors g panels, projecting the whole group against Qbuf ONCE (plus
    eager in-group projections on static column slices).  The scan driver
    is Qbuf-BANDWIDTH-bound at 16384^2 — every per-panel step reads the
    m x n buffer twice (~137 GB total at g=1 ≈ the measured 218 ms) — so
    grouping divides the dominant traffic by g.  Falls back to g=1 when
    g does not divide nb.

    The unrolled BGS driver (``_block_qr_bgs``) compiles n/r distinct panel
    programs — minutes at 8192+.  Here every panel shares one
    ``fori_loop`` step:

      * the panel projects against ALL previous Q columns in one full-width
        GEMM pair (unwritten columns are zero, so their coefficients vanish
        — no masking, no slice bookkeeping); ``reorth=True`` (BCGS2) runs
        the projection twice, restoring eps_trailing-class orthogonality
        for any kappa at 2x the projection FLOPs;
      * every panel factors through the shifted three-pass NS scheme
        (convergent for ANY conditioning — one step must serve the
        well-conditioned head panels and the cond(G) ~ 1e5-1e8 trailing
        corner alike);
      * Q materializes by ``dynamic_update_slice`` into the buffer — zero
        Q-update GEMMs, R column blocks are the projection coefficients +
        the panel t, written in one update each.

    Projection GEMMs run full-width (m x n x r) regardless of progress —
    2x the exact-slice FLOPs of the unrolled driver — at policy.trailing
    precision on the bgs1 tier (reorth tiers run them fp32 HIGHEST against
    an fp32-resident Qbuf, the ladder's price — see
    ``_bgs_scan_machinery``).  Requires n % r == 0; complete mode only for m == n (same contract as
    ``_block_qr_bgs``).
    """
    step, carry0, nsteps = _bgs_scan_machinery(
        A, B, block_size, policy, platform=platform, reorth=reorth,
        group_panels=group_panels, reorth_grouped=reorth_grouped,
    )
    Qbuf, R, QtB, worst_resid = jax.lax.fori_loop(0, nsteps, step, carry0)
    return _bgs_scan_finalize(
        A.shape[0], A.shape[1], policy, want_q, B is not None,
        Qbuf, R, QtB, worst_resid, reorth=reorth,
    )


def _bgs_scan_machinery(
    A: jax.Array,
    B: Optional[jax.Array],
    block_size: int,
    policy: DTypePolicy,
    platform: str,
    reorth: bool,
    group_panels: int,
    reorth_grouped: bool = False,
):
    """The scan-BGS step function, exposed so both the one-shot driver
    (``_block_qr_bgs_scan``) and the checkpointed segmented driver
    (``models/resumable.py`` — SURVEY §5 checkpoint/resume) run the SAME
    compiled step: identical math, identical carry, so a resumed run is
    bit-identical to an uninterrupted one.  Returns
    ``(step, carry0, nsteps)`` with carry = (Qbuf, R, QtB, worst_resid).
    """
    from mixedprecisionblockqr_tpu.ops.polar import tri_robust_panel

    m, n = A.shape
    r = block_size
    nb = n // r
    assert n % r == 0 and m >= n
    chain = chain_for(platform)
    A = A.astype(policy.panel)
    q_dtype = policy.q_store or policy.accum
    mm_t = lambda a, b: matmul(a, b, in_dtype=policy.trailing,
                               accum_dtype=policy.accum)
    # Reorth tiers ('bgs' per-panel, 'bgs2' grouped): ALL projection
    # passes run fp32 HIGHEST and Qbuf carries fp32 through the loop —
    # a scrub at the trailing precision's own noise scrubs nothing, and a
    # bf16-resident Qbuf caps it at bf16 regardless (round-3 ADVICE item 2
    # / round-4 isolation; same fix as the unrolled drivers and the dist
    # scan driver).  'bgs1' keeps trailing-precision projections and the
    # policy's resident Q dtype (max throughput).
    mm_p = (
        (lambda a, b: jnp.matmul(
            a.astype(jnp.float32), b.astype(jnp.float32), precision=_HI))
        if reorth else mm_t
    )
    qbuf_dtype = jnp.float32 if reorth else q_dtype
    Qbuf = jnp.zeros((m, n), qbuf_dtype)
    R = jnp.zeros((n, n), jnp.float32)
    kB = B.shape[1] if B is not None else 1
    QtB = jnp.zeros((n, kB), jnp.float32)
    Bc = B if B is not None else jnp.zeros((m, 1), jnp.float32)

    # Grouping reorders the SAME single-pass CGS math (one Qbuf pass per
    # group + eager in-group projections), so it serves the bgs1 tier
    # unchanged; the FULL reorth tier ('bgs') needs its BCGS2 second pass
    # against the freshly-written in-group panels too — grouping would
    # skip it (measured orth 1.3e-4 vs the 6.1e-5 fp32 criterion at
    # 512^2) — so it stays per-panel.  ``reorth_grouped`` (the 'bgs2'
    # scan tier) keeps the group width WITH the double Qbuf pass: the
    # scrub kills the inter-group drift that grows with n/r (the 16384^2
    # fp32-criterion breaker) at half the 'bgs' traffic, leaving only the
    # group-width-bounded in-group single-pass term.
    g = (
        group_panels
        if group_panels > 1 and nb % group_panels == 0
        and (not reorth or reorth_grouped)
        else 1
    )
    gw = g * r
    n_steps = nb // g
    # Rescrub coverage: the corner amplification spans the ill-conditioned
    # TAIL, not just the final group — mirror the unrolled/dist robust-tail
    # count (max(2, nb // 8) panels) in steps, ceil-divided by g.  A
    # final-step-only rescrub left the earlier tail panels' leaks in place
    # at nb > 8g (e.g. 16384^2 r=128 g4: 16 robust panels across 4 steps).
    rescrub_from = n_steps - min(n_steps, -(-max(2, nb // 8) // g))

    def step(k, carry):
        Qbuf, R, QtB, wr = carry
        lam_g = k * gw
        Cg = jax.lax.dynamic_slice(A, (0, lam_g), (m, gw)).astype(
            policy.accum
        )
        # Classical-GS projection of the WHOLE group against every written
        # Q column (columns >= lam_g are still zero -> zero coefficients,
        # exact no-ops) — ONE full-width pass over Qbuf per group (mm_p:
        # fp32 HIGHEST on the reorth tiers, trailing precision on bgs1).
        C = mm_p(Qbuf.T, Cg)
        Cg = Cg - mm_p(Qbuf, C)
        if reorth:
            C2 = mm_p(Qbuf.T, Cg)
            Cg = Cg - mm_p(Qbuf, C2)
            C = C + C2
        # Rcol accumulates the group's (n, gw) coefficient block: previous
        # groups' coefficients from C, then per-panel t / in-group
        # projections at dynamic row offsets.
        Rcol = C[:n, :]
        for j in range(g):  # static unroll inside the one compiled step
            P = Cg[:, j * r : (j + 1) * r]
            # One robust panel factorization serves every step.
            Qk, t, resid = tri_robust_panel(P, chain)
            wr = jnp.maximum(wr, 0.01 * resid)  # robust panels: 1e-2 tol
            if reorth:
                # Rescrub the robust-corner steps only (lax.cond: compiled
                # once, executed on the final ceil(tail/g) iterations) —
                # the amplification lives in the corner, so the whole-run
                # cost is ~tail/g extra Qbuf double-passes, not one per
                # panel.
                Qk, t, dW, rs = jax.lax.cond(
                    k >= rescrub_from,
                    lambda a: _rescrub_panel(Qbuf, *a, platform=platform),
                    lambda a: (a[0].astype(jnp.float32),
                               a[1].astype(jnp.float32),
                               jnp.zeros((n, r), jnp.float32),
                               jnp.float32(0.0)),
                    (Qk, t),
                )
                wr = jnp.maximum(wr, rs * rs)
                Rcol = Rcol.at[:, j * r : (j + 1) * r].add(dW)
            Qbuf = jax.lax.dynamic_update_slice(
                Qbuf, Qk.astype(qbuf_dtype), (0, lam_g + j * r)
            )
            row = lam_g + j * r
            row = jnp.asarray(row)
            jr = jnp.full((), j * r, dtype=row.dtype)  # index dtypes match
            zero = jnp.zeros((), row.dtype)
            if j + 1 < g:
                # eager in-group projection (static column slices)
                Ct = Cg[:, (j + 1) * r :]
                G1 = mm_p(Qk.T, Ct)
                Cg = Cg.at[:, (j + 1) * r :].set(Ct - mm_p(Qk, G1))
                Rcol = jax.lax.dynamic_update_slice(
                    Rcol, jnp.concatenate([t, G1], axis=1), (row, jr)
                )
            else:
                Rcol = jax.lax.dynamic_update_slice(Rcol, t, (row, jr))
            if B is not None:
                QtB = jax.lax.dynamic_update_slice(
                    QtB, mm_t(Qk.T, Bc), (row, zero)
                )
        R = jax.lax.dynamic_update_slice(R, Rcol, (0, lam_g))
        return Qbuf, R, QtB, wr

    carry0 = (Qbuf, R, QtB, jnp.float32(0.0))
    return step, carry0, n_steps


def _bgs_scan_finalize(
    m: int,
    n: int,
    policy: DTypePolicy,
    want_q: bool,
    with_b: bool,
    Qbuf,
    R,
    QtB,
    worst_resid,
    reorth: bool = True,
):
    """Close a scan-BGS carry into the public (R_full, Q, B) triple —
    shared by the one-shot and resumable drivers."""
    R_full = (
        jnp.concatenate([R, jnp.zeros((m - n, n), R.dtype)], 0)
        if m > n else R
    )
    R_full = jnp.triu(R_full.astype(policy.accum))
    # Reorth tiers carry Qbuf fp32 through the loop AND return it fp32:
    # a bf16 return residency would round Q to the ~4.4e-4 storage floor
    # (see _block_qr_bgs), wasting the scrub.  bgs1 keeps the compact
    # q_store residency (its traffic lever).
    q_dtype = policy.accum if reorth else (policy.q_store or policy.accum)
    Q = Qbuf.astype(q_dtype) if want_q else None
    Bout = QtB if with_b else None
    R_full, Q, Bout = _poison_if_unconverged(worst_resid, R_full, Q, Bout)
    return R_full, Q, Bout


@lru_cache(maxsize=None)
def _jitted_driver(
    block_size: int,
    policy: DTypePolicy,
    want_q: bool,
    with_b: bool,
    panel_method: str = "householder",
    loop_mode: str = "unroll",
    platform: str = "cpu",
    group_panels: int = 4,
):
    # platform is part of the cache key so a process that switches backends
    # re-traces with the right chain instead of replaying a stale one.

    def fn(A, B=None):
        if panel_method in ("bgs", "bgs1", "bgs2"):
            # 'bgs1' = single-pass projections at trailing precision (max
            #          throughput);
            # 'bgs2' = BCGS2 reorth scrub in 3-pass bf16, fp32 in-group dots;
            # 'bgs'  = same with the reorth scrub in fp32.
            # Any bf16 single-pass projection anywhere in the chain pins the
            # orth floor at ~0.1, so the reorth tiers run ALL in-group dots
            # fp32 and differ only in the scrub's precision.
            if loop_mode == "scan":
                return _block_qr_bgs_scan(
                    A, block_size, policy, want_q, B, platform=platform,
                    reorth=panel_method in ("bgs", "bgs2"),
                    group_panels=group_panels,
                    # bgs2 scan = grouped inter-group BCGS2 (half the
                    # 'bgs' Qbuf traffic; in-group drift bounded by the
                    # group width).
                    reorth_grouped=panel_method == "bgs2",
                )
            return _block_qr_bgs(
                A, block_size, policy, want_q, B,
                group_panels=group_panels, platform=platform,
                reorth=panel_method in ("bgs", "bgs2"),
                mid_tier=panel_method == "bgs2",
            )
        if panel_method == "polar":
            return _block_qr_grouped(
                A, block_size, policy, want_q, B, group_panels=group_panels,
            )
        if loop_mode == "scan":
            return _block_qr_scan(A, block_size, policy, want_q, B,
                                  panel_method)
        return _block_qr_traced(A, block_size, policy, want_q, B,
                                panel_method)

    if with_b:
        return jax.jit(lambda A, B: fn(A, B))
    return jax.jit(lambda A: fn(A, None))


def block_qr(
    A,
    block_size: int = DEFAULT_BLOCK_SIZE,
    policy: DTypePolicy = POLICY_FP32,
    mode: str = "reduced",
    panel_method: str = "householder",
    loop_mode: str = "unroll",
    group_panels: int = 4,
    quality: Optional[str] = None,
    check: str = "defer",
):
    """Blocked WY Householder QR: A = QR.

    Args:
        A: (m, n) matrix, m >= n.
        block_size: panel width r (the reference sweeps r in its size tables,
            ``Cuda/qr.cu:1762-1787``).
        policy: dtype policy. ``POLICY_FP32`` mirrors ``dev_block_qr_wy``;
            ``POLICY_MIXED`` mirrors ``dev_mixed_precision_block_qr`` with
            bf16 GEMMs in place of FP16 TensorCores.
        mode: 'reduced' -> (Q[:, :n], R[:n]); 'complete' -> (Q, R); 'r' ->
            R only (skips all Q-accumulation GEMMs).
        panel_method: 'householder' (robust, reference semantics),
            'cholqr1'/'cholqr2'/'cholqr2s' (all-GEMM CholeskyQR panels),
            'polar' (chol-free Newton-Schulz panels + group-aggregated
            W-form updates), 'bgs'/'bgs2'/'bgs1' (Block Gram-Schmidt
            quality ladder), or 'auto' (the measured per-size dispatch;
            see ``qr``).
        group_panels: reflector/projection aggregation factor — trailing
            matrix / B / Q are each touched once per group.
        quality: speed/orthogonality ladder knob for ``panel_method='auto'``
            (requires it): 'fast' (single-pass projections, compact bf16
            Q), 'balanced' (3-pass bf16 reorth scrub, fp32 Q), 'high' (fp32
            reorth scrub, fp32 Q).  ``block_qr`` is the
            EXPERT/throughput driver: under mixed policies
            ``quality=None`` means the 'fast' rung (what bench.py times);
            the convenience entry ``qr()`` defaults mixed policies to
            'balanced' instead.
            'robust' = Householder-grade factorization for hostile spectra (its
            returned Q stays policy-resident — under compact-Q policies
            use 'high' for orthogonality; see QUALITY_LEVELS).  Measured
            ladder: PERF.md.
        check: NaN-canary handling for the Newton-Schulz tiers, which
            poison R[0,0]/Q[0,0] when a panel under-converges
            (``_poison_if_unconverged``):
            * 'defer' (default) — no host synchronization; a breakdown
              surfaces as NaN in the outputs at first materialization
              (inspect with ``utils.checks.checked_qr``).  Keeps the call
              fully async/pipelineable — the factorization itself never
              blocks on a device->host fetch.
            * 'sync' — one blocking scalar fetch per call; on breakdown the
              factorization transparently reruns through the robust
              reflector tier ('householder', or 'cholqr2s' in scan mode)
              and raises ``NonFiniteError`` if even that fails.
    """
    A = jnp.asarray(A)
    if A.dtype not in (jnp.float32, jnp.float64, jnp.bfloat16):
        A = A.astype(policy.panel)
    if jnp.dtype(policy.panel) == jnp.float64 and not jax.config.jax_enable_x64:
        raise ValueError(
            "POLICY_FP64 requires jax_enable_x64 "
            "(jax.config.update('jax_enable_x64', True))"
        )
    if check not in ("defer", "sync", "off"):
        raise ValueError(f"check must be 'defer'|'sync'|'off', got {check!r}")
    m, n = A.shape
    if m < n:
        raise ValueError(f"block_qr requires m >= n, got {A.shape}")
    want_q = mode in ("reduced", "complete")
    platform = jax.default_backend()
    panel_method, loop_mode, group_panels = resolve_panel_config(
        m, n, block_size, policy, panel_method, loop_mode, group_panels,
        mode=mode, platform=platform, quality=quality,
    )
    R_full, Q, _ = _jitted_driver(
        block_size, policy, want_q, False, panel_method, loop_mode, platform,
        group_panels,
    )(A)
    if check == "sync" and not bool(jnp.isfinite(R_full[0, 0])):
        # NaN canary fired: NS under-convergence, OR a cholqr tier's
        # Cholesky breaking on a (near-)rank-deficient Gram (round-7: the
        # sync guard used to cover only the NS tiers, so cholqr1/cholqr2s
        # violated the 'sync always retries' contract on singular inputs;
        # _block_qr_traced now funnels per-panel non-finiteness into the
        # canary so ALL tiers are detected here).  Rerun through the
        # robust tier: 'householder' handles rank deficiency exactly
        # (reflector zero-norm skip); in scan mode the Householder loop
        # would re-create the compile explosion the scan exists to avoid,
        # so retry the all-robust scan-BGS tier (shifted three-pass
        # chains: any FULL-RANK hostile spectrum converges; exactly
        # singular inputs still poison -> the raise below names the fix).
        # cholqr1 is NOT a valid retry target — its Cholesky NaNs on
        # exactly the Grams that trigger poisoning (round-3 ADVICE 1).
        retry_pm = _sync_retry_method(
            panel_method, loop_mode, policy, mode, m, n
        )
        from mixedprecisionblockqr_tpu.utils.checks import NonFiniteError

        if retry_pm is None:
            raise NonFiniteError(
                f"block_qr: non-finite factorization via {panel_method!r} "
                "— the input likely contains NaN/Inf"
            )
        R_full, Q, _ = _jitted_driver(
            block_size, policy, want_q, False, retry_pm, loop_mode, platform,
        )(A)
        if not bool(jnp.isfinite(R_full[0, 0])):
            raise NonFiniteError(
                f"block_qr: non-finite factorization even via {retry_pm!r} "
                "— the input contains NaN/Inf, or is numerically "
                "rank-deficient (use panel_method='householder' with "
                "loop_mode='unroll', or pivoted_qr/lstsq for rank-revealing "
                "handling)"
            )
        if Q is not None and panel_method in ("bgs", "bgs2"):
            # Dtype stability: the reorth tiers' primary path returns Q
            # fp32 — the reflector retry must not hand the SAME call a
            # bf16 Q (downstream jit would recompile; the fp32-Q contract
            # would silently depend on the input's spectrum).  The upcast
            # cannot recover the reflector path's q_store rounding — the
            # retry's orthogonality is policy-limited, a documented
            # trade for surviving a hostile spectrum.
            Q = Q.astype(policy.accum)
    if mode == "r":
        return R_full[:n, :]
    if mode == "reduced":
        return Q[:, :n], R_full[:n, :]
    if mode == "complete":
        return Q, R_full
    raise ValueError(f"unknown mode {mode!r}")


def block_qr_qtb(
    A,
    B,
    block_size: int = DEFAULT_BLOCK_SIZE,
    policy: DTypePolicy = POLICY_FP32,
    panel_method: str = "householder",
    quality: Optional[str] = None,
    check: str = "defer",
) -> Tuple[jax.Array, jax.Array]:
    """Factor A and return (R (n x n), Q^T B) without materializing Q.

    The least-squares fast path: B is updated by each panel's block reflector
    in the same pass as the trailing matrix.  ``check`` semantics match
    ``block_qr`` ('defer' keeps the call async; 'sync' fetches the NaN
    canary and retries through the robust reflector tier).
    """
    A = jnp.asarray(A)
    B = jnp.asarray(B)
    squeeze = B.ndim == 1
    if squeeze:
        B = B[:, None]
    if check not in ("defer", "sync", "off"):
        raise ValueError(f"check must be 'defer'|'sync'|'off', got {check!r}")
    m, n = A.shape
    platform = jax.default_backend()
    panel_method, _, group_panels = resolve_panel_config(
        m, n, block_size, policy, panel_method, "unroll",
        DEFAULT_GROUP_PANELS, mode="qtb", platform=platform, quality=quality,
    )
    R_full, _, QtB = _jitted_driver(
        block_size, policy, False, True, panel_method, "unroll", platform,
        group_panels,
    )(A, B.astype(policy.panel))
    if check == "sync" and not bool(jnp.isfinite(R_full[0, 0])):
        # NaN-poisoned (any tier — NS under-convergence or a cholqr
        # Cholesky breakdown, see block_qr): retry via the robust
        # reflector tier (NOT cholqr1, whose Cholesky NaNs on the same
        # hostile Grams — round-3 ADVICE).
        from mixedprecisionblockqr_tpu.utils.checks import NonFiniteError

        if panel_method == "householder":
            raise NonFiniteError(
                "block_qr_qtb: non-finite factorization via 'householder' "
                "— the input likely contains NaN/Inf"
            )
        R_full, _, QtB = _jitted_driver(
            block_size, policy, False, True, "householder", "unroll", platform,
        )(A, B.astype(policy.panel))
        if not bool(jnp.isfinite(R_full[0, 0])):
            raise NonFiniteError(
                "block_qr_qtb: non-finite factorization even via "
                "'householder' — the input likely contains NaN/Inf"
            )
    QtB = QtB.astype(policy.accum)
    if squeeze:
        QtB = QtB[:, 0]
    return R_full[:n, :], QtB


def block_recursive_qr(A, mode: str = "reduced", min_block: int = 64):
    """Recursive blocked QR on *reduced* factors (GVL Alg 5.2.4; spec at
    ``python/qr.py:145-173`` — whose leaf returns reduced factors regardless
    of the mode argument, making the whole recursion reduced-form; we follow
    that semantics and therefore only support ``mode='reduced'``).

    Columns are split in half recursively; leaves use the blocked driver.
    The combine step is two block GEMMs.
    """
    if mode != "reduced":
        raise ValueError("block_recursive_qr supports mode='reduced' only")
    A = jnp.asarray(A, dtype=jnp.float32)

    @jax.jit
    def run(A):
        def rec(A):
            m, n = A.shape
            if n <= min_block:
                R_full, Q, _ = _block_qr_traced(A, min_block, POLICY_FP32, True, None)
                return Q[:, :n], R_full[:n, :]
            n1 = n // 2
            Q1, R11 = rec(A[:, :n1])
            R12 = jnp.matmul(Q1.T, A[:, n1:], precision=_HI)
            Q2, R22 = rec(A[:, n1:] - jnp.matmul(Q1, R12, precision=_HI))
            Q = jnp.concatenate([Q1, Q2], axis=1)
            top = jnp.concatenate([R11, R12], axis=1)
            bot = jnp.concatenate(
                [jnp.zeros((R22.shape[0], n1), A.dtype), R22], axis=1
            )
            return Q, jnp.concatenate([top, bot], axis=0)

        return rec(A)

    return run(A)


def block_qr_batched(
    A_batch,
    block_size: int = DEFAULT_BLOCK_SIZE,
    policy: DTypePolicy = POLICY_FP32,
    mode: str = "reduced",
    panel_method: str = "householder",
):
    """Batched blocked QR over a leading batch axis (vmap; the data-parallel
    analog — shard the batch axis over a mesh for multi-chip DP)."""
    A_batch = jnp.asarray(A_batch)
    if A_batch.ndim != 3:
        raise ValueError(f"expected (batch, m, n), got {A_batch.shape}")
    want_q = mode in ("reduced", "complete")
    fn = _jitted_driver(
        block_size, policy, want_q, False, panel_method, "unroll",
        jax.default_backend(),
    )
    R_full, Q, _ = jax.vmap(fn)(A_batch)
    n = A_batch.shape[2]
    if mode == "r":
        return R_full[:, :n, :]
    if mode == "reduced":
        return Q[:, :, :n], R_full[:, :n, :]
    return Q, R_full


def qr(
    A,
    block_size: int = DEFAULT_BLOCK_SIZE,
    policy: DTypePolicy = POLICY_FP32,
    mode: str = "reduced",
    panel_method: str = "auto",
    loop_mode: str = "unroll",
    group_panels: int = DEFAULT_GROUP_PANELS,
    quality: Optional[str] = None,
    check: str = "defer",
):
    """Main entry: dispatches unblocked for narrow/wide problems, blocked
    otherwise.  Wide matrices (m < n) go through the unblocked path, matching
    the reference's ``householder_qr`` semantics (``python/qr.py:26``):
    Q is (m, k) / (m, m) and R is (k, n) / (m, n) with k = min(m, n).

    ``panel_method`` defaults to ``'auto'``: on a GPU the per-size fast
    tier is selected (``resolve_panel_config`` — e.g. 2048^2 mixed hits the
    bgs1 g8 headline config with zero flags); on other platforms and for
    fp64/hostile shapes it resolves to the robust 'householder' tier.  The
    reference's users get its flagship by calling one function
    (``Cuda/main.cu:11-26``); so do ours.

    ``quality`` exposes the measured speed/orthogonality ladder without
    method strings: 'fast' (compact bf16 Q), 'balanced' (fp32 Q, the mixed
    DEFAULT), 'high' (fp32 Q), 'robust' = Householder-grade.

    Default quality (round-4 VERDICT weak item 4): ``qr()`` is the
    numpy-like convenience entry, so under mixed/bf16 policies
    ``quality=None`` means **'balanced'** — an uninformed
    ``qr(A, policy=POLICY_MIXED)`` gets <= 1e-5 orthogonality, not the
    throughput rung's ~0.1 floor.  fp32 policies already default to
    'high' in ``resolve_panel_config``.  The throughput rung stays one
    knob away (``quality='fast'``) and is the DEFAULT of the expert
    driver ``block_qr`` (which bench.py pins explicitly); this mirrors
    the reference's own split between its fp32 default path
    (``dev_block_qr_wy``, ``Cuda/qr.cu:958``) and its opt-in
    mixed-precision flagship (``Cuda/qr.cu:1049``).

    ``check='sync'`` opts into the blocking NaN-canary
    fetch + transparent robust retry (see ``block_qr``); the default
    'defer' never blocks the dispatch pipeline."""
    A = jnp.asarray(A)
    m, n = A.shape
    if n <= 8 or m < n:
        return householder_qr(A.astype(policy.panel), mode=mode, dtype=policy.panel)
    if (
        quality is None
        and panel_method == "auto"
        and jnp.dtype(policy.trailing) == jnp.bfloat16
    ):
        quality = "balanced"
    return block_qr(
        A, block_size=block_size, policy=policy, mode=mode,
        panel_method=panel_method, loop_mode=loop_mode,
        group_panels=group_panels, quality=quality, check=check,
    )
