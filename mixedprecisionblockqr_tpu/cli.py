"""Command-line interface.

The reference has no runtime configuration at all — tile sizes are compile
-time ``#define``s, the dataset path is baked by CMake into ``qr_config.h``,
and test selection means editing ``main()`` (``Cuda/main.cu:13-14``).  This
CLI is the runtime replacement: dtype policy, block size, panel method,
dataset paths and benchmark sweeps are flags.

    python -m mixedprecisionblockqr_tpu qr --m 1024 --n 1024 --policy mixed
    python -m mixedprecisionblockqr_tpu suite            # Cuda/main.cu parity
    python -m mixedprecisionblockqr_tpu bench --sizes 256,512,1024
    python -m mixedprecisionblockqr_tpu solve --m 2000 --n 1000
    python -m mixedprecisionblockqr_tpu dataset --out data/jacobians
    python -m mixedprecisionblockqr_tpu plot log/*.txt
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

import numpy as np


def _load_matrix(args) -> np.ndarray:
    if getattr(args, "file", None):
        from mixedprecisionblockqr_tpu.utils.euroc import read_euroc_jacobian

        _, _, a = read_euroc_jacobian(args.file)
        return a
    if getattr(args, "cond", None):
        from mixedprecisionblockqr_tpu.utils.datagen import conditioned_matrix

        if getattr(args, "m", None) not in (None, args.n):
            # The Bierlaire generator is square-only; an explicit
            # rectangular request used to silently produce an n x n
            # matrix (review finding: results reported for the wrong
            # shape).
            raise SystemExit(
                f"error: --cond generates a square n x n matrix; got "
                f"--m {args.m} --n {args.n} (drop --m or use --file)"
            )
        return conditioned_matrix(args.n, args.cond, seed=args.seed).astype(
            np.float32
        )
    rng = np.random.default_rng(args.seed)
    m = args.m if args.m is not None else args.n
    return (rng.random((m, args.n), dtype=np.float32) - 0.5)


def _common_flags(p: argparse.ArgumentParser, with_matrix: bool = True):
    if with_matrix:
        p.add_argument("--m", type=int, default=None,
                       help="rows (default: n, i.e. square)")
        p.add_argument("--n", type=int, default=1024)
        p.add_argument("--file", help="Euroc Jacobian text file")
        p.add_argument("--cond", type=float, help="target condition number")
        p.add_argument("--seed", type=int, default=0)
    p.add_argument("--policy", default="mixed",
                   choices=["fp32", "mixed", "mixed_fast", "bf16", "fp64"])
    p.add_argument("--block-size", type=int, default=128)
    p.add_argument(
        "--panel-method",
        default="auto",
        choices=["auto", "householder", "cholqr1",
                 "cholqr2", "cholqr2s", "cholqr1x2", "polar", "bgs", "bgs1",
                 "bgs2"],
        help="auto = the per-size fast tier on a GPU "
             "(ops/blockqr.py::resolve_panel_config), householder elsewhere",
    )
    p.add_argument("--loop-mode", default="unroll",
                   choices=["unroll", "scan"],
                   help="scan = one compiled panel step (fast compile at "
                        "large n/r, ~2-3x slower runtime)")
    p.add_argument(
        "--group-panels", type=int, default=4,
        help="reflector/panel aggregation factor for bgs/bgs1/polar "
             "(8 = the bench headline config at 2048^2)",
    )
    p.add_argument(
        "--quality", default=None,
        choices=["fast", "balanced", "high", "robust"],
        help="speed/orthogonality ladder for --panel-method auto "
             "(fast = single-pass projections, balanced = 3-pass bf16 "
             "reorth, high = fp32 reorth, robust = Householder-grade; "
             "measured ladder: PERF.md)",
    )
    p.add_argument("--log-dir", default="log")


def cmd_qr(args) -> int:
    from mixedprecisionblockqr_tpu.ops import metrics
    from mixedprecisionblockqr_tpu.ops.blockqr import block_qr
    from mixedprecisionblockqr_tpu.ops.policy import policy_by_name
    from mixedprecisionblockqr_tpu.utils.flops import qr_flops
    from mixedprecisionblockqr_tpu.utils.logging import ResultsLogger

    a = _load_matrix(args)
    policy = policy_by_name(args.policy)
    if args.pivoted != "off":
        from mixedprecisionblockqr_tpu.ops.pivoted import (
            numerical_rank,
            pivoted_qr,
        )
        from mixedprecisionblockqr_tpu.utils.flops import qr_flops as _qf

        # The pivoted tiers are fp32-only and pick their own method; don't
        # silently ignore knobs that cannot apply (the repo convention —
        # see models/lstsq.py's refine_steps/quality guard).  'mixed' is
        # the subcommand's DEFAULT policy, so it is tolerated (and runs
        # fp32); explicitly incompatible choices are rejected.
        if args.policy not in ("fp32", "mixed") or args.quality is not None:
            raise SystemExit(
                "qr --pivoted runs the fp32 rank-revealing tiers; "
                f"--policy {args.policy} / --quality do not apply — drop "
                "them (--panel-method/--loop-mode/--group-panels are "
                "likewise unused here)"
            )
        t0 = time.perf_counter()
        Q, R, perm = pivoted_qr(a, mode="reduced", method=args.pivoted,
                                block_size=args.block_size)
        dt = time.perf_counter() - t0
        an = np.asarray(a)[:, np.asarray(perm)]
        rep = metrics.evaluate(an, Q, R, precision_bits=23)
        rank = numerical_rank(R, m=a.shape[0])
        print(rep)
        print(json.dumps({"rank": int(rank), "method": args.pivoted,
                          "seconds_with_compile": dt}))
        ResultsLogger(args.log_dir).write_csv(
            f"{_platform()}_pivoted_{args.pivoted}", a.shape[0], a.shape[1],
            dt,
            _qf(*a.shape), rep.backward
        )
        return 0 if rep.all_ok else 1
    t0 = time.perf_counter()
    Q, R = block_qr(
        a, block_size=args.block_size, policy=policy, mode="complete",
        panel_method=args.panel_method, loop_mode=args.loop_mode,
        group_panels=args.group_panels, quality=args.quality,
        check="sync",  # CLI materializes results: take the robust retry
    )
    rep = metrics.evaluate(a, Q, R, precision_bits=policy.precision_bits)
    dt = time.perf_counter() - t0  # includes compile; see `bench` for rates
    print(rep)
    name = f"{_platform()}_block_{args.policy}"
    ResultsLogger(args.log_dir).write_csv(
        name, a.shape[0], a.shape[1], dt, qr_flops(*a.shape), rep.backward
    )
    return 0 if rep.all_ok else 1


def _platform_tag() -> str:
    import jax

    try:
        return jax.devices()[0].platform
    except Exception:
        return "cpu"


def cmd_bench(args) -> int:
    import jax.numpy as jnp

    from mixedprecisionblockqr_tpu.ops import metrics
    from mixedprecisionblockqr_tpu.ops.blockqr import block_qr
    from mixedprecisionblockqr_tpu.ops.policy import policy_by_name
    from mixedprecisionblockqr_tpu.utils.flops import qr_flops
    from mixedprecisionblockqr_tpu.utils.logging import ResultsLogger
    from mixedprecisionblockqr_tpu.utils.timing import time_step_amortized

    policy = policy_by_name(args.policy)
    sizes = [int(s) for s in args.sizes.split(",")]
    logger = ResultsLogger(args.log_dir)
    for s in sizes:
        rng = np.random.default_rng(0)
        a = rng.random((s, s), dtype=np.float32) - 0.5
        A = jnp.asarray(a)
        Q, R = block_qr(
            A, block_size=min(args.block_size, s), policy=policy,
            mode="complete", panel_method=args.panel_method,
            loop_mode=args.loop_mode, group_panels=args.group_panels,
            quality=args.quality, check="sync",
        )
        rep = metrics.evaluate(a, Q, R, precision_bits=policy.precision_bits)

        from mixedprecisionblockqr_tpu.ops.blockqr import (
            _jitted_driver,
            resolve_panel_config,
        )

        # Same dispatch as block_qr (auto resolution + the full
        # panel_method/loop_mode fallback chain via the SHARED helper) so
        # the timed program is exactly the public driver's.
        r_eff = min(args.block_size, s)
        platform = _platform()
        pm, lm, gp = resolve_panel_config(
            s, s, args.block_size, policy, args.panel_method,
            args.loop_mode, args.group_panels, mode="complete",
            platform=platform, quality=args.quality,
        )
        drv = _jitted_driver(r_eff, policy, True, False, pm, lm, platform, gp)

        def step(x, drv=drv):
            R_full, Qc, _ = drv(x)
            return x * (1.0 + 1e-12 * R_full[0, 0])

        if args.profile_dir:
            from mixedprecisionblockqr_tpu.utils.timing import trace

            with trace(f"blockqr_{s}", log_dir=args.profile_dir):
                sec = time_step_amortized(step, A, iters=args.iters)
        else:
            sec = time_step_amortized(step, A, iters=args.iters)
        tflops = qr_flops(s, s) / sec / 1e12
        logger.write_csv(
            f"{_platform_tag()}_block_{args.policy}", s, s, sec,
            qr_flops(s, s), rep.backward,
        )
        print(
            json.dumps(
                {
                    "m": s, "n": s, "seconds": round(sec, 6),
                    "tflops": round(tflops, 3),
                    "backward_error": rep.backward,
                    "criteria_ok": rep.all_ok,
                }
            )
        )
    return 0


def cmd_suite(args) -> int:
    """The reference's full test/benchmark entry (``Cuda/main.cu:11-26``):
    static random size table + Jacobian dataset, each through the CPU-spec,
    fp32-blocked, and mixed-precision drivers, CSV-logged."""
    import os

    import jax.numpy as jnp

    from mixedprecisionblockqr_tpu.models.slam import enumerate_jacobians
    from mixedprecisionblockqr_tpu.ops import metrics
    from mixedprecisionblockqr_tpu.ops.blockqr import block_qr, qr
    from mixedprecisionblockqr_tpu.ops.policy import POLICY_FP32, POLICY_MIXED
    from mixedprecisionblockqr_tpu.utils.datagen import STATIC_QR_SIZES
    from mixedprecisionblockqr_tpu.utils.flops import qr_flops
    from mixedprecisionblockqr_tpu.utils.logging import ResultsLogger

    logger = ResultsLogger(args.log_dir)
    failures = 0
    done: dict = {}
    if args.resume:
        # Sweep-resume: skip cases already in the CSV logs — long dataset
        # sweeps survive interruption (SURVEY §5 checkpoint/resume).
        # COUNT occurrences per (name, m, n) rather than set membership:
        # the static table deliberately repeats shapes with different
        # block sizes r (and the CSV schema — reference parity — does not
        # record r), so a set key skipped every later r-variant of a
        # duplicated shape forever (review finding).  Cases run in
        # deterministic table order, so skipping the first K occurrences
        # resumes exactly where the log left off.
        import glob as _glob

        from mixedprecisionblockqr_tpu.utils.logging import read_csv_log

        for path in _glob.glob(os.path.join(args.log_dir, "*.txt")):
            name = os.path.splitext(os.path.basename(path))[0]
            try:
                for rec in read_csv_log(path):
                    key = (name, rec["rows"], rec["cols"])
                    done[key] = done.get(key, 0) + 1
            except Exception:
                pass

    def run_case(name, a, r, policy, bits):
        nonlocal failures
        key = (name, a.shape[0], a.shape[1])
        if done.get(key, 0) > 0:
            done[key] -= 1
            return
        t0 = time.perf_counter()
        # The suite exercises what users get: auto dispatch (the per-size
        # tier on a GPU) with the sync canary/retry — mirroring the
        # reference's main() running its flagship drivers over the tables
        # (``Cuda/main.cu:11-26``).
        Q, R = block_qr(a, block_size=r, policy=policy, mode="complete",
                        panel_method="auto", check="sync")
        rep = metrics.evaluate(a, Q, R, precision_bits=bits)
        dt = time.perf_counter() - t0
        logger.write_csv(name, a.shape[0], a.shape[1], dt,
                         qr_flops(*a.shape), rep.backward)
        # Acceptance = reference 2^-bits*m criterion; the sqrt(m) tightness
        # gate (ops/metrics.py::tight_limit) is the regression tripwire.
        ok = rep.all_ok and (rep.tight_ok or not args.strict)
        status = "ok" if ok else (
            "FAIL" if not rep.all_ok else "FAIL-tight"
        )
        print(f"{name} {a.shape[0]}x{a.shape[1]} r={r}: "
              f"err={rep.backward:.3e} [{status}]")
        failures += 0 if ok else 1

    rng = np.random.default_rng(0)
    table = STATIC_QR_SIZES if not args.quick else STATIC_QR_SIZES[:8]
    platform = _platform()
    for m, n, r in table:
        a = rng.random((m, n), dtype=np.float32)
        run_case(f"{platform}_block_fp32", a, r, POLICY_FP32, 23)
        run_case(f"{platform}_block_mixed", a, r, POLICY_MIXED, 8)

    for case in enumerate_jacobians(args.data_dir)[: args.max_jacobians]:
        a = case.load()
        if a.shape[0] < a.shape[1]:
            continue
        run_case(f"{platform}_jacobian_fp32", a, 128, POLICY_FP32, 23)
        run_case(f"{platform}_jacobian_mixed", a, 128, POLICY_MIXED, 8)

    print(f"suite complete, {failures} failures")
    return 1 if failures else 0


def cmd_solve(args) -> int:
    from mixedprecisionblockqr_tpu.models.lstsq import lstsq
    from mixedprecisionblockqr_tpu.ops.policy import policy_by_name

    a = _load_matrix(args)
    rng = np.random.default_rng(args.seed + 1)
    xtrue = rng.random(a.shape[1]).astype(np.float32)
    b = a @ xtrue
    # --quality implies auto dispatch (the subcommand default is the
    # robust 'householder'; the library rejects quality with an explicit
    # non-auto method).
    pm = ("auto" if args.quality and args.panel_method == "householder"
          else args.panel_method)
    x = np.asarray(
        lstsq(a, b, block_size=args.block_size,
              policy=policy_by_name(args.policy),
              panel_method=pm, quality=args.quality)
    )
    resid = float(np.linalg.norm(a @ x - b) / np.linalg.norm(b))
    err = float(np.max(np.abs(x - xtrue)))
    print(json.dumps({"m": a.shape[0], "n": a.shape[1],
                      "rel_residual": resid, "max_x_error": err}))
    return 0 if resid < 1e-2 else 1


def cmd_dataset(args) -> int:
    from mixedprecisionblockqr_tpu.utils.euroc import synthesize_dataset

    sizes = [tuple(map(int, s.split("x"))) for s in args.sizes.split(",")]
    paths = synthesize_dataset(args.out, sizes=sizes)
    print(f"wrote {len(paths)} files to {args.out}")
    return 0


def cmd_dist(args) -> int:
    """Distributed QR over all available devices (1-D rows mesh)."""
    import jax

    from mixedprecisionblockqr_tpu.ops import metrics
    from mixedprecisionblockqr_tpu.ops.policy import policy_by_name
    from mixedprecisionblockqr_tpu.parallel.dist_qr import dist_block_qr
    from mixedprecisionblockqr_tpu.parallel.mesh import make_mesh

    a = _load_matrix(args)
    mesh = make_mesh()
    policy = policy_by_name(args.policy)
    if args.quality:
        if args.panel_method != "auto":
            # Same conflict rule as single-chip qr --quality (review
            # finding: this used to silently drop --quality instead).
            print(
                "error: --quality is the auto-dispatch ladder knob; it "
                f"cannot combine with --panel-method {args.panel_method!r}",
                file=sys.stderr,
            )
            return 2
        # Map through the library's ladder table (one source of truth —
        # the CLI previously duplicated it as a literal dict and the two
        # had drifted; dist_block_qr(quality=) applies the same mapping
        # and scan guard for library callers).
        from mixedprecisionblockqr_tpu.ops.blockqr import _QUALITY_BGS

        args.panel_method = _QUALITY_BGS.get(args.quality, "householder")
        if (
            args.panel_method.startswith("bgs")
            and a.shape[1] % min(args.block_size, a.shape[1]) == 0
            and a.shape[1] // min(args.block_size, a.shape[1]) > 32
            and args.loop_mode == "unroll"
        ):
            args.loop_mode = "scan"
    if args.panel_method == "auto":
        m_, n_ = a.shape
        r_ = min(args.block_size, n_)
        n_dev = max(1, len(jax.devices()))
        per_dev_rows = m_ // n_dev
        if (
            n_ % r_ == 0
            and n_ >= 2 * args.block_size
            and not (m_ != n_)  # complete-mode output below needs m == n
        ):
            # Distributed BGS tier: full-height panels (no square-leaf
            # hazard), one psum per Gram/projection, Q by concatenation.
            args.panel_method = "bgs"
            if n_ // r_ > 32 and args.loop_mode == "unroll":
                # Large panel counts: the unrolled driver compiles n/r
                # distinct panel programs (minutes to hours) — switch to
                # scan, matching resolve_panel_config.  In scan mode 'bgs'
                # runs PER-PANEL (3 collectives + 2 full-width Qbuf passes
                # per panel); the grouped inter-group-BCGS2 tier ('bgs2')
                # keeps the group width at the same criterion-passing
                # quality class.
                args.loop_mode = "scan"
                args.panel_method = "bgs2"
        elif per_dev_rows >= 2 * args.block_size:
            # Shifted CholeskyQR2 leaves (plain cholqr2 collapsed at
            # 8192^2 in the trailing corner).
            args.panel_method = "cholqr2s"
        else:
            # Squarish per-device leaves are CholeskyQR-hostile.
            args.panel_method = "householder"
    if args.panel_method not in (
        "householder", "cholqr2", "cholqr2s", "bgs", "bgs1", "bgs2"
    ):
        # Error instead of silently coercing (round-1 VERDICT CLI drift):
        # the distributed leaf factorization supports exactly these.
        print(
            "error: dist supports --panel-method "
            "householder|cholqr2|cholqr2s|bgs|bgs1|bgs2, "
            f"got {args.panel_method!r}",
            file=sys.stderr,
        )
        return 2
    # BGS materializes the reduced Q (m x n): evaluate reduced for m != n.
    mode = (
        "reduced"
        if args.panel_method in ("bgs", "bgs1", "bgs2")
        and a.shape[0] != a.shape[1]
        else "complete"
    )
    Q, R = dist_block_qr(
        a, mesh, block_size=args.block_size, policy=policy, mode=mode,
        panel_method=args.panel_method,
        loop_mode=args.loop_mode,
        group_panels=args.group_panels,
    )
    rep = metrics.evaluate(a, Q, R, precision_bits=policy.precision_bits)
    print(
        f"devices={len(jax.devices())} mesh={dict(mesh.shape)} "
        f"panel_method={args.panel_method} loop_mode={args.loop_mode} "
        f"group_panels={args.group_panels}"
    )
    print(rep)
    return 0 if rep.all_ok else 1


def cmd_tsqr_bench(args) -> int:
    import jax.numpy as jnp

    from mixedprecisionblockqr_tpu.ops import metrics
    from mixedprecisionblockqr_tpu.parallel.tsqr import tsqr
    from mixedprecisionblockqr_tpu.utils.flops import tsqr_flops
    from mixedprecisionblockqr_tpu.utils.timing import time_step_amortized

    m, n = args.m, args.n
    A = jnp.asarray(
        np.random.default_rng(0).random((m, n), dtype=np.float32)
    )
    Q, R = tsqr(A, n_leaves=args.leaves, method=args.method)
    rep_b = float(metrics.backward_error(A, Q, R))
    rep_o = float(metrics.orthogonality_error(Q))

    def step(x):
        # Time the EXACT program whose errors were just validated — tsqr's
        # own dispatch.  Timing _tsqr_impl directly diverged at --leaves 1
        # (tsqr dispatches the direct no-tree leaf path there; the impl
        # adds a degenerate tree + fix-up einsum the validated path never
        # runs — review finding, the timed-equals-dispatched rule).
        Q, R = tsqr(x, n_leaves=args.leaves, method=args.method)
        return x * (1.0 + 1e-12 * R[0, 0])

    sec = time_step_amortized(step, A, iters=args.iters)
    print(json.dumps({
        "m": m, "n": n, "leaves": args.leaves, "method": args.method,
        "seconds": round(sec, 6),
        "tflops_2mn2": round(tsqr_flops(m, n) / sec / 1e12, 3),
        "backward_error": rep_b, "orthogonality_error": rep_o,
    }))
    return 0


def cmd_precision_study(args) -> int:
    from mixedprecisionblockqr_tpu.models.precision_study import write_study

    sizes = tuple(int(x) for x in args.sizes.split(","))
    conds = tuple(float(x) for x in args.conds.split(","))
    paths = write_study(args.out, sizes=sizes, condition_numbers=conds,
                        block_size=args.block_size)
    print("\n".join(paths))
    return 0


def cmd_plot(args) -> int:
    from mixedprecisionblockqr_tpu.utils.plotting import plot_logs

    written = plot_logs(args.logs, out_dir=args.out)
    print("\n".join(written))
    return 0


def _platform() -> str:
    """The backend the run is on — the prefix of every results log name."""
    import jax

    return jax.default_backend()


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="mixedprecisionblockqr_tpu",
        description="Mixed-precision block QR",
    )
    parser.add_argument(
        "--platform",
        choices=["cpu", "gpu"],
        help="force the JAX backend (the environment may override "
        "JAX_PLATFORMS; this flag always wins)",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("qr", help="factor one matrix, report error metrics")
    _common_flags(p)
    p.add_argument(
        "--pivoted", default="off", choices=["off", "auto", "exact",
                                             "rqrcp"],
        help="column-pivoted (rank-revealing) factorization instead of "
             "the blocked fast tiers; reports the numerical rank "
             "(ops/pivoted.py — 'rqrcp' = the sketch-pivoting tier)",
    )
    p.set_defaults(fn=cmd_qr)

    p = sub.add_parser("bench", help="amortized TFLOP/s sweep")
    _common_flags(p, with_matrix=False)
    p.add_argument("--sizes", default="256,512,1024,2048")
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--profile-dir", default=None,
                   help="capture a jax.profiler trace here (NVTX analog)")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("suite", help="full test/bench suite (main.cu parity)")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--max-jacobians", type=int, default=8)
    p.add_argument("--quick", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="skip shapes already present in the CSV logs")
    p.add_argument("--log-dir", default="log")
    p.add_argument("--no-strict", dest="strict", action="store_false",
                   help="disable the 2^-bits*sqrt(m) tightness gate "
                        "(acceptance criterion only)")
    p.set_defaults(fn=cmd_suite, strict=True)

    p = sub.add_parser("solve", help="QR least-squares solve")
    _common_flags(p)
    # Solves keep the robust reflector default (lstsq's own default and
    # rationale: solver workloads skew ill-conditioned); explicit
    # --panel-method/--quality are now FORWARDED to lstsq rather than
    # silently ignored (review finding).
    p.set_defaults(fn=cmd_solve, policy="fp32", panel_method="householder")

    p = sub.add_parser("dataset", help="synthesize Euroc-format Jacobians")
    p.add_argument("--out", default="data/jacobians")
    p.add_argument("--sizes", default="256x128,512x256,1024x512,2000x1000")
    p.set_defaults(fn=cmd_dataset)

    p = sub.add_parser("dist", help="distributed QR over all devices")
    _common_flags(p)  # includes --loop-mode
    p.set_defaults(fn=cmd_dist)

    p = sub.add_parser("tsqr-bench", help="tall-skinny QR benchmark")
    p.add_argument("--m", type=int, default=100000)
    p.add_argument("--n", type=int, default=64)
    p.add_argument("--leaves", type=int, default=8)
    p.add_argument("--method", default="cholqr2",
                   choices=["householder", "cholqr2", "cholqr2s"])
    p.add_argument("--iters", type=int, default=16)
    p.set_defaults(fn=cmd_tsqr_bench)

    p = sub.add_parser("precision-study",
                       help="dtype x cond error/duration tables "
                            "(performance_test_result parity)")
    p.add_argument("--sizes", default="128,256,500")
    p.add_argument("--conds", default="1e3,1e4,1e5,1e6,1e7")
    p.add_argument("--block-size", type=int, default=64)
    p.add_argument("--out", default="log/precision_study")
    p.set_defaults(fn=cmd_precision_study)

    p = sub.add_parser("plot", help="plot CSV logs")
    p.add_argument("logs", nargs="+")
    p.add_argument("--out", default="log/plots")
    p.set_defaults(fn=cmd_plot)

    args = parser.parse_args(argv)
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
