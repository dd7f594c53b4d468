"""CPU checks of what the GPU smoke run and the benchmark are built from:
chip_smoke.py's phases at tiny sizes on the CPU backend (the same code the
card runs at mx=32), its refusal to run without a GPU, the compile-cache
rule, and bench.py's peak table, roofline and trace reduction."""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import pytest

import bench
import chip_smoke
from exsaddle_tpu import compile_cache


def test_solve_phase_dispatches_ir_and_converges():
    # an odd element count does not split over the 8 virtual devices, so
    # saddle_solve stays on one device; an odd grid coarsens once
    r = chip_smoke.solve_phase(mx=3, nlevels=2, extra_args=["-jit", "1"],
                               warm=1)
    assert r["mode"] == "ir"
    assert r["true_rel_residual_cpu"] <= chip_smoke.RTOL_TRUE
    assert r["ir_rounds"] >= 1 and r["outer_its"] > 0
    assert r["memory_analysis"]["argument_size_in_bytes"] > 0
    assert r["setup_s"] > 0 and r["compile_first_solve_s"] > 0


def test_apply_phase_matches_float64_reference():
    r = chip_smoke.apply_phase(mx=4, inner=3, reps=1)
    assert r["f32_rel_err"] <= chip_smoke.APPLY_F32_TOL
    assert r["f64_rel_err"] <= chip_smoke.APPLY_F64_TOL
    assert r["flops"] > 0 and r["bytes_min"] > 0


def test_parity_phase_runs_both_legs():
    r = chip_smoke.parity_phase(mx=4, max_its=30)
    assert r["its_device"] == r["its_cpu"]
    assert r["rel_solution_diff"] <= chip_smoke.SOLVE_DIFF_TOL


def test_four_phase_on_virtual_devices():
    """The --four path over the 8 virtual CPU devices: cartesian dispatch
    against the single-device solve."""
    r = chip_smoke.four_phase(mx=4, nlevels=3, extra_args=["-jit", "1"])
    assert r["mode"] == "cart" and r["devices"] == len(jax.devices())
    assert abs(r["its_cart"] - r["its_single"]) <= 1


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_main_refuses_without_gpu(argv, monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main(argv)
    assert exc.value.code not in (0, None)


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_rule(env_set, tmp_path, monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            assert compile_cache.enable_compile_cache() == str(tmp_path)
            # JAX owns an explicit setting: nothing else is configured
            assert jax.config.jax_compilation_cache_dir == before
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            path = compile_cache.enable_compile_cache()
            assert path == os.path.join(compile_cache.CHECKOUT,
                                        ".jax_cache")
            assert os.path.isdir(path)
            assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("kind,platform,known", [
    ("NVIDIA H100 80GB HBM3", "gpu", True),
    ("Some Other Accelerator", "gpu", False),
    ("cpu", "cpu", False),
])
def test_device_peaks_table(kind, platform, known):
    dev = SimpleNamespace(device_kind=kind, platform=platform)
    if known:
        pk = bench.device_peaks(dev)
        assert pk["hbm_gbs"] == 3350.0 and pk["fp32_tflops"] == 67.0
        assert pk["source"]
    else:
        with pytest.raises(ValueError):
            bench.device_peaks(dev)


@pytest.mark.parametrize("flops,nbytes,bound", [
    (1e12, 1e6, "compute"),
    (1e6, 1e12, "memory"),
])
def test_roofline_takes_the_larger_bound(flops, nbytes, bound):
    r = bench.roofline(flops, nbytes, 1.0, 1e12, 1e12)
    assert r["bound"] == bound
    assert r["t_floor_us"] == max(r["t_flops_us"], r["t_bytes_us"])
    assert r["share"] == pytest.approx(1.0, rel=1e-3)


def test_trace_without_gpu_events_is_an_error():
    f = jax.jit(lambda x: (x @ x).sum())
    x = jnp.ones((64, 64))
    with pytest.raises(RuntimeError, match="GPU"):
        bench._trace_top_ops(lambda: jax.block_until_ready(f(x)))
