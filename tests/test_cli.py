"""CLI smoke tests (in-process; CPU)."""

import os

import numpy as np
import pytest

from mixedprecisionblockqr_tpu.cli import main


def test_cli_dataset_qr_solve_plot(tmp_path):
    d = str(tmp_path)
    assert main(["dataset", "--out", f"{d}/jac", "--sizes", "64x32,48x24"]) == 0
    assert os.path.exists(f"{d}/jac/A_000000100.txt")
    assert (
        main(
            ["qr", "--m", "96", "--n", "64", "--block-size", "32",
             "--policy", "fp32", "--log-dir", f"{d}/log"]
        )
        == 0
    )
    assert (
        main(
            ["qr", "--file", f"{d}/jac/A_000000100.txt", "--block-size", "16",
             "--log-dir", f"{d}/log"]
        )
        == 0
    )
    assert (
        main(
            ["solve", "--m", "128", "--n", "48", "--block-size", "16",
             "--log-dir", f"{d}/log"]
        )
        == 0
    )
    assert main(["plot", f"{d}/log/cpu_block_fp32.txt", "--out", f"{d}/p"]) == 0
    assert os.listdir(f"{d}/p")


def test_cli_qr_conditioned(tmp_path):
    assert (
        main(
            ["qr", "--n", "64", "--cond", "1000", "--block-size", "16",
             "--policy", "fp32", "--panel-method", "cholqr2s",
             "--log-dir", str(tmp_path)]
        )
        == 0
    )


def test_cli_suite_quick(tmp_path):
    assert (
        main(["suite", "--quick", "--max-jacobians", "0",
              "--log-dir", str(tmp_path)])
        == 0
    )


def test_cli_dist(tmp_path):
    assert (
        main(["dist", "--m", "128", "--n", "64", "--block-size", "16",
              "--policy", "fp32", "--log-dir", str(tmp_path)])
        == 0
    )


def test_cli_bench_matches_public_dispatch(tmp_path, capsys):
    """cmd_bench must time the SAME program the public driver dispatches
    (round-2 ADVICE item 3): bgs at a non-divisible size falls back through
    the shared resolver instead of hitting the raw driver assert."""
    assert (
        main(["bench", "--sizes", "96", "--iters", "2",
              "--panel-method", "bgs1", "--policy", "fp32",
              "--log-dir", str(tmp_path)])
        == 0
    )
    out = capsys.readouterr().out
    assert '"m": 96' in out and '"criteria_ok": true' in out


def test_cli_bench_scan_fallback(tmp_path, capsys):
    # scan at a size <= block_size must normalize to unroll, not crash.
    assert (
        main(["bench", "--sizes", "64", "--iters", "2", "--block-size", "64",
              "--loop-mode", "scan", "--policy", "fp32",
              "--log-dir", str(tmp_path)])
        == 0
    )
    assert '"criteria_ok": true' in capsys.readouterr().out


def test_cli_dist_bgs_and_rejection(tmp_path, capsys):
    assert (
        main(["dist", "--m", "256", "--n", "64", "--block-size", "32",
              "--policy", "fp32", "--panel-method", "bgs",
              "--log-dir", str(tmp_path)])
        == 0
    )
    # unsupported dist method errors loudly (no silent coercion)
    assert (
        main(["dist", "--m", "128", "--n", "64", "--block-size", "16",
              "--panel-method", "polar", "--log-dir", str(tmp_path)])
        == 2
    )


def test_cli_dist_auto_leaf_selection(tmp_path):
    # auto on a square-leaf-hostile shape must still succeed (householder
    # or bgs leaf; never a crashing cholqr leaf).
    assert (
        main(["dist", "--m", "128", "--n", "96", "--block-size", "16",
              "--policy", "fp32", "--log-dir", str(tmp_path)])
        == 0
    )


def test_cli_dist_auto_large_nb_takes_grouped_bgs2_scan(tmp_path, capsys):
    # nb = n/r > 32: auto must leave the unrolled driver (n/r distinct
    # panel programs) for the GROUPED inter-group-BCGS2 scan tier — the
    # certified 16384^2 config — not the per-panel 'bgs' scan (the
    # round-4 collective-budget blowout).
    assert (
        main(["dist", "--m", "1024", "--n", "1024", "--block-size", "16",
              "--policy", "fp32", "--log-dir", str(tmp_path)])
        == 0
    )
    out = capsys.readouterr().out
    assert "panel_method=bgs2" in out and "loop_mode=scan" in out, out


def test_cli_dist_explicit_bgs2(tmp_path):
    # bgs2 is a supported explicit dist method (the certified tier must
    # be reachable by name, not only via auto).
    assert (
        main(["dist", "--m", "256", "--n", "128", "--block-size", "16",
              "--policy", "fp32", "--panel-method", "bgs2",
              "--loop-mode", "scan", "--log-dir", str(tmp_path)])
        == 0
    )


def test_cli_tsqr_bench(capsys):
    assert (
        main(["tsqr-bench", "--m", "2048", "--n", "32", "--leaves", "4",
              "--iters", "2"])
        == 0
    )
    out = capsys.readouterr().out
    assert '"backward_error"' in out


def test_cli_precision_study(tmp_path, capsys):
    assert (
        main(["precision-study", "--sizes", "32", "--conds", "1e3",
              "--block-size", "16", "--out", str(tmp_path / "ps")])
        == 0
    )
    written = capsys.readouterr().out.strip().splitlines()
    assert written and all(os.path.exists(p) for p in written)


def test_cli_suite_resume_skips_done(tmp_path, capsys):
    d = str(tmp_path)
    assert main(["suite", "--quick", "--max-jacobians", "0",
                 "--log-dir", d]) == 0
    first = capsys.readouterr().out
    assert "suite complete, 0 failures" in first
    # resume: everything already logged -> no new case lines
    assert main(["suite", "--quick", "--max-jacobians", "0", "--resume",
                 "--log-dir", d]) == 0
    second = capsys.readouterr().out
    assert "suite complete, 0 failures" in second
    assert second.count("cpu_block_fp32") < first.count("cpu_block_fp32")


def test_cli_dist_quality_flag(tmp_path, capsys):
    # --quality resolves the dist ladder exactly like single-chip qr.
    assert (
        main(["dist", "--m", "256", "--n", "256", "--block-size", "32",
              "--policy", "fp32", "--quality", "balanced",
              "--log-dir", str(tmp_path)])
        == 0
    )
    out = capsys.readouterr().out
    assert "panel_method=bgs2" in out, out


def test_cli_qr_pivoted(tmp_path):
    d = str(tmp_path)
    # exact tier, small; reports rank and passes fp32 criteria
    assert main(["qr", "--n", "64", "--block-size", "16", "--pivoted",
                 "exact", "--log-dir", f"{d}/log"]) == 0
    # rqrcp tier (explicit) at its minimum eligible shape
    assert main(["qr", "--n", "512", "--block-size", "128", "--pivoted",
                 "rqrcp", "--log-dir", f"{d}/log"]) == 0
