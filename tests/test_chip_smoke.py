"""``chip_smoke.py``: what of it runs without a GPU."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import chip_smoke  # noqa: E402


def test_chip_smoke_refuses_a_cpu_only_process():
    with pytest.raises(SystemExit) as exc:
        chip_smoke.require_gpu()
    assert "needs a GPU" in str(exc.value)


def test_chip_smoke_rotation_error_is_small_angle_accurate():
    r = chip_smoke.rotation(0.0, 0.0, 0.17)
    for angle in (1e-6, 1e-4, 0.3):
        dr = chip_smoke.rotation(angle, 0.0, 0.0)
        np.testing.assert_allclose(chip_smoke.rotation_error(r @ dr, r), angle,
                                   rtol=1e-6)
