"""chip_smoke.py's phases at tiny shapes on the CPU backend: the same checks
the card runs at full size, so a wrong path, argument or tolerance shows
here first.  ``main()`` itself must refuse a non-GPU device."""

import math

import numpy as np
import pytest

import chip_smoke


def test_main_refuses_non_gpu(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert "needs a GPU" in str(exc.value.code)
    assert capsys.readouterr().out == ""  # no result line


@pytest.mark.parametrize("value", [2.0, math.nan, math.inf])
def test_check_raises_past_limit(value, capsys):
    with pytest.raises(AssertionError):
        chip_smoke.check("x", value, 1.0, "reason")
    assert "[FAIL] x" in capsys.readouterr().out


def test_diag_error_ignores_signs():
    R = np.diag([3.0, -2.0, 1.0])
    assert chip_smoke.diag_error(R, -R) == 0.0
    assert chip_smoke.diag_error(R, np.diag([3.0, 2.0, 1.5])) == pytest.approx(
        0.5 / 3.0)


def test_kernel_phase_interpret(capsys):
    chip_smoke.phase_kernel(m=256, r=32, interpret=True)
    out = capsys.readouterr().out
    assert out.count("[ok]") == 2 and "FAIL" not in out


def test_main_phase_small(capsys):
    chip_smoke.phase_main(n_mixed=256, n_fp32=128, slam=(200, 100),
                          tall=(4096, 16))
    out = capsys.readouterr().out
    assert "memory_analysis" in out
    assert "FAIL" not in out and out.count("[ok]") == 25


def test_four_phase_small(capsys):
    chip_smoke.phase_four(n=256, tall=(2048, 16), block=32)
    out = capsys.readouterr().out
    assert "FAIL" not in out and out.count("[ok]") == 15
    assert "on devices [0, 1, 2, 3]" in out
