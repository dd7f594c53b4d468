"""Checks that need the GPU, at small sizes: the smoke run's apply and
solve-parity phases and the driver's default jitted dispatch. They skip
where no card is visible; on a machine with one:

    EXSADDLE_TEST_GPU=1 python -m pytest tests/ -m gpu -p no:xdist -q
"""

import pytest

import chip_smoke

pytestmark = pytest.mark.gpu


def test_apply_on_gpu_matches_cpu_float64(gpu):
    r = chip_smoke.apply_phase(mx=8, inner=5, reps=2)
    assert r["f32_rel_err"] <= chip_smoke.APPLY_F32_TOL
    assert r["f64_rel_err"] <= chip_smoke.APPLY_F64_TOL


def test_direct_solve_gpu_vs_cpu_mx6(gpu):
    r = chip_smoke.parity_phase(mx=6)
    assert r["its_device"] <= chip_smoke.REF_ITS_MX6


def test_driver_dispatches_ir_by_default_on_gpu(gpu):
    r = chip_smoke.solve_phase(mx=8, nlevels=3, warm=1)
    assert r["mode"] == "ir"
    assert r["true_rel_residual_cpu"] <= chip_smoke.RTOL_TRUE
