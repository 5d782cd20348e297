"""Smoke test of the library on the card: the main path at the shapes its
users run, every kernel compiled for the GPU and compared with its plain
reference, every result checked against the reference's error criteria.

    python chip_smoke.py          # one card
    python chip_smoke.py --four   # the sharded path on four cards

Phases (one card): the device; kernel parity (the triangular-NS chain
kernel against the plain chain at HIGHEST); the main path through the
public API — ``block_qr`` (bench.py's call) and ``qr`` at 2048^2 mixed,
``qr`` at 1024^2 fp32, ``lstsq`` on a 2000x1000 SLAM-shaped Jacobian,
``tsqr`` on 100000x64 — each checked with ``ops/metrics.evaluate`` against
``2^-bits*m`` and the tight ``2^-bits*sqrt(m)`` bound and against float64
NumPy on the host.  With ``--four``: ``dist_block_qr`` at 16384^2 on a
1-D ``rows`` mesh of four cards and ``tsqr_sharded`` on 4x100000x64,
compared with the single-card factorization of the same matrix.

Any failed check raises and the script exits non-zero; the last line of
standard output is the JSON result only when every phase passed.  Exits
non-zero, printing no result, when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def check(name: str, value: float, limit: float, reason: str) -> None:
    """One printed line per check; raises when ``value`` exceeds ``limit``
    or is not finite."""
    ok = math.isfinite(value) and value <= limit
    print(f"  [{'ok' if ok else 'FAIL'}] {name}: {value:.3e} <= {limit:.3e}"
          f"  ({reason})", flush=True)
    if not ok:
        raise AssertionError(f"{name}: {value!r} exceeds {limit!r}")


def check_report(name: str, rep) -> None:
    """The reference's criteria: backward, orthogonality and lower-trapezoid
    error against 2^-bits*m, and the first two against 2^-bits*sqrt(m)."""
    crit = f"2^-{rep.precision_bits}*m, m={rep.m}"
    tight = f"2^-{rep.precision_bits}*sqrt(m)"
    check(f"{name} backward", rep.backward, rep.limit, crit)
    check(f"{name} orthogonality", rep.orthogonality, rep.limit, crit)
    check(f"{name} lower-trapezoid", rep.lower_trapezoid, rep.limit, crit)
    check(f"{name} backward (tight)", rep.backward, rep.tight, tight)
    check(f"{name} orthogonality (tight)", rep.orthogonality, rep.tight,
          tight)


def diag_error(R, R_ref) -> float:
    """max_k | |R_kk| - |Rref_kk| | / max_k |Rref_kk| (column signs are a
    convention)."""
    import numpy as np

    d = np.abs(np.diag(np.asarray(R, np.float64)))
    d_ref = np.abs(np.diag(np.asarray(R_ref, np.float64)))
    return float(np.max(np.abs(d - d_ref)) / np.max(d_ref))


def phase_device(need: int = 1) -> dict:
    """Fail unless JAX's first device is a GPU; print its kind, the device
    count and the card's name and power limit."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke.py needs a GPU; JAX found {devices[0].platform!r}")
    if len(devices) < need:
        raise SystemExit(f"needs {need} GPUs, JAX found {len(devices)}")
    from mixedprecisionblockqr_tpu.utils.timing import card_line

    print(f"device: {devices[0].device_kind}, {len(devices)} visible, "
          f"{need} used", flush=True)
    print(card_line(), flush=True)
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind, "count": need}


def phase_kernel(m: int = 2048, r: int = 64, interpret: bool = False):
    """The chain kernel at width ``r`` against the plain chain at HIGHEST,
    on the Gram of an m x r random panel and on a Gram of condition ~1e6
    under the robust pass's shift."""
    import jax.numpy as jnp
    import numpy as np

    from mixedprecisionblockqr_tpu.ops.pallas.ns import ns_chain
    from mixedprecisionblockqr_tpu.ops.polar import tri_chain

    print(f"kernel parity: ns_chain r={r} vs tri_chain (HIGHEST)",
          flush=True)
    rng = np.random.default_rng(1)
    P1 = rng.standard_normal((m, r))
    U, _ = np.linalg.qr(rng.standard_normal((m, r)))
    V, _ = np.linalg.qr(rng.standard_normal((r, r)))
    P2 = (U * np.logspace(0, -3, r)) @ V.T  # cond(P) 1e3, cond(G) 1e6
    cases = (
        ("random Gram", P1, dict(iters=6), 1e-5),
        ("cond-1e6 Gram, shift 1e-3", P2,
         dict(iters=14, shift=1e-3, omega=False), 1e-4),
    )
    for name, P, kw, tol in cases:
        G = jnp.asarray((P.T @ P).astype(np.float32))
        X, t, _ = ns_chain(G, interpret=interpret, **kw)
        Xr, tr, _ = tri_chain(G, **kw)
        Gs = np.asarray(G, np.float64)
        if kw.get("shift"):
            from mixedprecisionblockqr_tpu.ops.polar import _spectral_guard

            Gs = Gs + kw["shift"] * float(_spectral_guard(G)) * np.eye(r)
        for label, XX in (("kernel", X), ("plain", Xr)):
            XX = np.asarray(XX, np.float64)
            res = float(np.max(np.abs(XX.T @ Gs @ XX - np.eye(r))))
            print(f"  {name}: {label} max|X^T G X - I| = {res:.3e}",
                  flush=True)
        tn, trn = np.asarray(t, np.float64), np.asarray(tr, np.float64)
        check(f"{name}: rel. diff of t", float(
            np.max(np.abs(tn - trn)) / np.max(np.abs(trn))), tol,
            "two fp32 evaluations summed in different orders: "
            "roundoff class, not bit equality")


def phase_main(n_mixed: int = 2048, n_fp32: int = 1024,
               slam: tuple = (2000, 1000), tall: tuple = (100000, 64)):
    """The main path through the public API with the default
    ``panel_method='auto'``."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mixedprecisionblockqr_tpu import block_qr, lstsq, qr, tsqr
    from mixedprecisionblockqr_tpu.ops import metrics
    from mixedprecisionblockqr_tpu.ops.policy import (
        POLICY_FP32,
        POLICY_MIXED,
        POLICY_MIXED_FAST,
    )
    from mixedprecisionblockqr_tpu.utils.datagen import slam_jacobian

    rng = np.random.default_rng(0)
    a = rng.random((n_mixed, n_mixed), dtype=np.float32) - 0.5
    A = jnp.asarray(a)
    R_ref = np.linalg.qr(a.astype(np.float64), mode="r")

    step = jax.jit(lambda x: block_qr(
        x, 128, POLICY_MIXED_FAST, mode="complete", panel_method="auto",
        quality="fast", check="defer"))
    t0 = time.perf_counter()
    compiled = step.lower(A).compile()
    print(f"main path: block_qr {n_mixed}^2 mixed_fast compiled in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    mem = compiled.memory_analysis()
    print(f"  memory_analysis: argument {mem.argument_size_in_bytes} B, "
          f"output {mem.output_size_in_bytes} B, "
          f"temp {mem.temp_size_in_bytes} B, "
          f"code {mem.generated_code_size_in_bytes} B", flush=True)

    def mixed_diag_tol(m):
        # diag(R) of a backward-stable factorization is the diag of A+dA's
        # exact R: normwise within the tight backward bound's class.
        return metrics.tight_limit(8, m), "2^-8*sqrt(m)"

    Q, R = compiled(A)
    rep = metrics.evaluate(a, Q, R, precision_bits=8)
    check_report(f"block_qr {n_mixed}^2 mixed_fast 'fast'", rep)
    tol, why = mixed_diag_tol(n_mixed)
    check(f"block_qr {n_mixed}^2 |diag R| vs float64 NumPy",
          diag_error(R, R_ref), tol, why)

    Q, R = qr(A, policy=POLICY_MIXED)
    rep = metrics.evaluate(a, Q, R, precision_bits=8)
    check_report(f"qr {n_mixed}^2 mixed 'balanced'", rep)
    check(f"qr {n_mixed}^2 mixed |diag R| vs float64 NumPy",
          diag_error(R, R_ref), tol, why)

    a32 = rng.random((n_fp32, n_fp32), dtype=np.float32) - 0.5
    Q, R = qr(jnp.asarray(a32), policy=POLICY_FP32, block_size=64)
    rep = metrics.evaluate(a32, Q, R, precision_bits=23)
    check_report(f"qr {n_fp32}^2 fp32", rep)
    check(f"qr {n_fp32}^2 fp32 |diag R| vs float64 NumPy",
          diag_error(R, np.linalg.qr(a32.astype(np.float64), mode="r")),
          metrics.error_limit(23, n_fp32), "2^-23*m")

    ms, ns_ = slam
    J = slam_jacobian(ms, ns_)
    b = rng.standard_normal(ms).astype(np.float32)
    x = np.asarray(lstsq(jnp.asarray(J), jnp.asarray(b)), np.float64)
    J64, b64 = J.astype(np.float64), b.astype(np.float64)
    x_ref = np.linalg.lstsq(J64, b64, rcond=None)[0]
    res = np.linalg.norm(J64 @ x - b64) / np.linalg.norm(b64)
    res_ref = np.linalg.norm(J64 @ x_ref - b64) / np.linalg.norm(b64)
    print(f"  lstsq {ms}x{ns_}: residual {res:.6e}, float64 NumPy "
          f"{res_ref:.6e}", flush=True)
    check(f"lstsq {ms}x{ns_} residual vs float64 NumPy",
          abs(res - res_ref) / res_ref, metrics.tight_limit(23, ms),
          "the minimum residual is unique; 2^-23*sqrt(m)")

    mt, nt = tall
    t = rng.standard_normal((mt, nt)).astype(np.float32)
    Q, R = tsqr(jnp.asarray(t))
    rep = metrics.evaluate(t, Q, R, precision_bits=23)
    check_report(f"tsqr {mt}x{nt}", rep)
    check(f"tsqr {mt}x{nt} |diag R| vs float64 NumPy",
          diag_error(R, np.linalg.qr(t.astype(np.float64), mode="r")),
          metrics.tight_limit(23, mt), "2^-23*sqrt(m)")


def phase_four(n: int = 16384, tall: tuple = (100000, 64),
               block: int = 128):
    """``dist_block_qr`` on a 1-D ``rows`` mesh of four devices, mixed,
    quality='balanced', scan mode — R with Q^T b, and the reduced Q —
    plus ``tsqr_sharded``, each checked with the criteria and against the
    single-card factorization of the same matrix on device 0."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mixedprecisionblockqr_tpu import block_qr, tsqr
    from mixedprecisionblockqr_tpu.models.lstsq import back_substitution
    from mixedprecisionblockqr_tpu.ops import metrics
    from mixedprecisionblockqr_tpu.ops.policy import POLICY_MIXED
    from mixedprecisionblockqr_tpu.parallel.dist_qr import dist_block_qr
    from mixedprecisionblockqr_tpu.parallel.mesh import make_mesh
    from mixedprecisionblockqr_tpu.parallel.tsqr import tsqr_sharded

    devices = jax.devices()[:4]
    mesh = make_mesh((4,), ("rows",), devices=devices)
    rows = NamedSharding(mesh, P("rows", None))
    hi = jax.lax.Precision.HIGHEST

    rng = np.random.default_rng(0)
    a = rng.random((n, n), dtype=np.float32) - 0.5
    A = jax.device_put(a, rows)
    b = jax.device_put(rng.standard_normal(n).astype(np.float32),
                       NamedSharding(mesh, P("rows")))

    def devs(x):
        return sorted(d.id for d in x.sharding.device_set)

    # The single-card factorization of the same matrix on device 0.
    A0 = jax.device_put(a, devices[0])
    t0 = time.perf_counter()
    R0 = block_qr(A0, block, POLICY_MIXED, mode="r", panel_method="auto",
                  quality="fast")
    R0 = np.asarray(R0, np.float64)
    print(f"single-card block_qr {n}^2 mixed 'fast' on device 0: "
          f"{time.perf_counter() - t0:.1f} s (compile included)", flush=True)
    del A0, a

    tight = metrics.tight_limit(8, n)
    t0 = time.perf_counter()
    R, qtb = dist_block_qr(A, mesh, block_size=block, policy=POLICY_MIXED,
                           mode="r", b=b, quality="balanced",
                           loop_mode="scan")
    jax.block_until_ready((R, qtb))
    print(f"dist_block_qr {n}^2 mixed 'balanced' scan, mode='r' + b: "
          f"{time.perf_counter() - t0:.1f} s (compile included); "
          f"R on devices {devs(R)}, Q^T b on devices {devs(qtb)}",
          flush=True)
    check(f"dist {n}^2 R lower-trapezoid",
          float(metrics.lower_trapezoid_error(R)),
          metrics.error_limit(8, n), "2^-8*m")
    check(f"dist {n}^2 |diag R| vs single-card", diag_error(R, R0),
          tight, "both factor the same A; 2^-8*sqrt(m)")
    x = back_substitution(R[:n, :], qtb[:n, 0])
    x = jax.device_put(x, NamedSharding(mesh, P()))
    res = jax.jit(lambda A, x, b: jnp.linalg.norm(
        jnp.matmul(A, x, precision=hi) - b) / jnp.linalg.norm(b))(A, x, b)
    check(f"dist {n}^2 solve relative residual ||Ax-b||/||b||",
          float(res), tight, "square full-rank system; 2^-8*sqrt(m)")
    del R, qtb, x

    t0 = time.perf_counter()
    Q, R = dist_block_qr(A, mesh, block_size=block, policy=POLICY_MIXED,
                         mode="reduced", quality="balanced",
                         loop_mode="scan")
    jax.block_until_ready((Q, R))
    print(f"dist_block_qr {n}^2 mixed 'balanced' scan, mode='reduced': "
          f"{time.perf_counter() - t0:.1f} s (compile included); "
          f"Q on devices {devs(Q)}, R on devices {devs(R)}", flush=True)
    # The criteria, evaluated sharded (each device its rows; one psum):
    # the gathering ops/metrics path would run two n^3 products per card.
    backward = jax.jit(lambda A, Q, R: jnp.linalg.norm(
        A - jnp.matmul(Q, R, precision=hi)) / jnp.linalg.norm(A))(A, Q, R)
    rep = NamedSharding(mesh, P())
    orth = jax.jit(lambda Q: jnp.max(jnp.abs(
        jnp.matmul(Q.T, Q, precision=hi, out_sharding=rep)
        - jnp.eye(n, dtype=Q.dtype))))(Q)
    crit, why = metrics.error_limit(8, n), "2^-8*m"
    check(f"dist {n}^2 backward", float(backward), crit, why)
    check(f"dist {n}^2 orthogonality", float(orth), crit, why)
    check(f"dist {n}^2 lower-trapezoid",
          float(metrics.lower_trapezoid_error(R)), crit, why)
    check(f"dist {n}^2 backward (tight)", float(backward), tight,
          "2^-8*sqrt(m)")
    check(f"dist {n}^2 orthogonality (tight)", float(orth), tight,
          "2^-8*sqrt(m)")
    check(f"dist {n}^2 reduced |diag R| vs single-card",
          diag_error(R, R0), tight, "2^-8*sqrt(m)")
    del Q, R, A

    mt, nt = tall
    t = rng.standard_normal((4 * mt, nt)).astype(np.float32)
    T = jax.device_put(t, rows)
    Q, R = tsqr_sharded(T, mesh)
    jax.block_until_ready((Q, R))
    print(f"tsqr_sharded {4 * mt}x{nt}: Q on devices {devs(Q)}", flush=True)
    rep = metrics.evaluate(t, Q, R, precision_bits=23)
    check_report(f"tsqr_sharded {4 * mt}x{nt}", rep)
    _, R1 = tsqr(jax.device_put(t, devices[0]))
    check(f"tsqr_sharded {4 * mt}x{nt} |diag R| vs single-card",
          diag_error(R, R1), metrics.tight_limit(23, 4 * mt),
          "2^-23*sqrt(m)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the sharded path on four cards")
    args = parser.parse_args(argv)

    from mixedprecisionblockqr_tpu.utils.cache import enable_compile_cache

    enable_compile_cache(ROOT)
    device = phase_device(need=4 if args.four else 1)
    if args.four:
        phase_four()
    else:
        phase_kernel()
        phase_main()
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
