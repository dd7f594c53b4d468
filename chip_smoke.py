"""Smoke run on the GPU: the flagship ABF solve through the driver.

Drives `driver.saddle_solve` -- the function behind
`python -m exsaddle_tpu.driver` -- on the 3D pseudoice Stokes system
(model 11, size_x 0.1) at mx=32 (859,812 dofs) with the committed abf.opts
solver tree in -ir mode: float32 inner ABF (FGMRES / fieldsplit-Schur-upper
/ Galerkin-MG / Chebyshev) inside float64 iterative refinement to a true
relative residual of 1e-8, with 4 velocity-MG levels so the replicated
dense coarse inverse stays small. Then it checks the fine operator apply
on the card against the float64 apply on the CPU backend, and the jitted
float64 solve on the card against the same solve on the CPU backend at the
reference's mx=6 case.

    python chip_smoke.py          # one GPU (the default)
    python chip_smoke.py --four   # four GPUs: the cartesian device-mesh
                                  # solve against one card, nothing else

Every line before the last is one JSON object; the last line is
{"ok": true, "device": {"platform", "kind", "count"}}. A failed check
raises and the script exits non-zero without that line. With no GPU
visible it stops before running anything.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
ABF_OPTS = os.path.join(REPO, "abf.opts")
SEED = 0
RTOL_TRUE = 1e-8        # the flagship target: true float64 ||r|| / ||r0||

# Apply tolerances, relative max error normalised by max|y_ref|:
# - float32 with full-FP32 products: unit roundoff 6e-8 over sums of a few
#   hundred products leaves this ~1e-6; TF32 products (10-bit mantissa)
#   land near 1e-3, so 1e-5 also catches TF32 slipping in.
# - float64 on the card vs the CPU backend: the same arithmetic in another
#   summation order, unit roundoff 1.1e-16.
APPLY_F32_TOL = 1e-5
APPLY_F64_TOL = 1e-12
# Solve parity, both float64: the card and the CPU backend run the same
# algorithm and differ only in summation order, so the solutions agree to
# far below the solver's own rtol; one iteration of slack covers a
# convergence test landing on the other side of rtol.
SOLVE_DIFF_TOL = 1e-8
REF_ITS_MX6 = 20        # testref/exSaddle3d_pseudoice_1.ref


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def flagship_args(mx, nlevels, ir=True):
    """Command line of the flagship solve (README quick start)."""
    args = ["-options_file", ABF_OPTS, "-model", "11", "-size_x", "0.1",
            "-mx", str(mx), "-saddle_fieldsplit_u_pc_mg_levels",
            str(nlevels)]
    if ir:
        args += ["-ir", "-rtol_true", str(RTOL_TRUE)]
    return args


def _cpu():
    import jax
    return jax.local_devices(backend="cpu")[0]


def true_rel_residual(slv, F, x):
    """||F - A x|| / ||F|| in float64 on the CPU backend, with the float64
    factored operator the solver's setup built (its data lives on the
    CPU)."""
    import jax
    import jax.numpy as jnp
    sop = slv.setup["sop"]
    with jax.default_device(_cpu()):
        Ax = np.asarray(jax.jit(type(sop).mult)(
            sop, jnp.asarray(x, jnp.float64)))
    F = np.asarray(F, np.float64)
    return float(np.linalg.norm(F - Ax) / np.linalg.norm(F))


def solve_phase(mx=32, nlevels=4, extra_args=(), warm=3):
    """The flagship IR solve through driver.saddle_solve, timed and
    checked. extra_args: more command-line options (the CPU tests pass
    -jit 1, which an accelerator does not need)."""
    import jax
    from exsaddle_tpu.driver import saddle_solve
    from exsaddle_tpu.options import Options

    opts = Options.from_args(flagship_args(mx, nlevels) + list(extra_args))
    r = saddle_solve(opts, 3, log=lambda *a, **k: None)
    ksp = r["ksp"]
    # guard against the silent fallback to the host KSP stack
    mode = getattr(ksp, "_mode", None)
    if mode != "ir":
        raise AssertionError(f"saddle_solve dispatched {mode!r}, not 'ir'")
    if "CONVERGED" not in str(r["result"].reason):
        raise AssertionError(f"cold solve: {r['result'].reason}")
    slv = ksp._slv
    F = np.asarray(r["F"])
    times = []
    for _ in range(warm):
        t0 = time.perf_counter()
        res = slv.solve_ir(F, rtol=RTOL_TRUE)
        times.append(time.perf_counter() - t0)
    if not res["converged"]:
        raise AssertionError(f"warm IR solve did not converge: {res}")
    rel = true_rel_residual(slv, F, res["x"])
    if not rel <= RTOL_TRUE:
        raise AssertionError(f"true relative residual {rel:g} > "
                             f"{RTOL_TRUE:g}")
    mem = slv._solve_ir_fn.lower(*slv.ir_args(F, RTOL_TRUE)).compile() \
        .memory_analysis()
    stats = jax.devices()[0].memory_stats() or {}
    return {
        "mode": mode,
        "ndof": int(r["mesh"].ndof),
        "setup_s": r["stages"]["Setup"] + r["stages"]["SolverSetup"],
        "compile_first_solve_s": r["stages"]["KSPSolve"],
        "warm_solve_s": times,
        "warm_solve_median_s": float(np.median(times)),
        "outer_its": int(res["inner_its"]),
        "ir_rounds": int(res["rounds"]),
        "true_rel_residual_cpu": rel,
        "memory_analysis": {
            k: int(getattr(mem, k)) for k in (
                "argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes", "generated_code_size_in_bytes")},
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
    }


def apply_phase(mx=32, inner=100, reps=20):
    """matfree.mult_tree on the default device, float32 and float64,
    against the float64 apply on the CPU backend on the same seeded input;
    plus the float32 apply's median time in a jitted loop."""
    import jax
    import jax.numpy as jnp
    import bench
    from exsaddle_tpu.matfree import (ParityMatFreeOperator, from_tree,
                                      mult_tree, to_tree, tree_aux)

    prob = bench._build_problem(mx)
    mesh = prob["mesh"]
    bc_mask = np.zeros(mesh.ndof)
    bc_mask[prob["bc_idx"]] = 1.0
    x = np.random.default_rng(SEED).standard_normal(mesh.ndof)

    def build(dtype):
        return ParityMatFreeOperator.build(mesh, prob["fes"], prob["coeff"],
                                           bc_mask, dtype=dtype)

    @jax.jit
    def apply(op, aux, tree):
        with jax.default_matmul_precision("float32"):
            return mult_tree(op, aux, tree)

    def run(op, dtype):
        return np.asarray(from_tree(apply(op, tree_aux(op), to_tree(
            op, jnp.asarray(x, dtype)))), np.float64)

    with jax.default_device(_cpu()):
        y_ref = run(build(jnp.float64), jnp.float64)
    scale = np.abs(y_ref).max()
    op32 = build(jnp.float32)
    err32 = float(np.abs(run(op32, jnp.float32) - y_ref).max() / scale)
    err64 = float(np.abs(run(build(jnp.float64), jnp.float64) - y_ref)
                  .max() / scale)
    if not err32 <= APPLY_F32_TOL:
        raise AssertionError(f"float32 apply error {err32:g} > "
                             f"{APPLY_F32_TOL:g}")
    if not err64 <= APPLY_F64_TOL:
        raise AssertionError(f"float64 apply error {err64:g} > "
                             f"{APPLY_F64_TOL:g}")

    aux32 = tree_aux(op32)
    applies, op_c, tree_c, _ = bench.stabilized_applies(
        op32, aux32, to_tree(op32, jnp.asarray(x, jnp.float32)), inner)
    t, t_min, t_max = bench.time_per_iter(applies, (op_c, aux32, tree_c),
                                          inner, reps)
    flops, nbytes = bench._apply_flops_bytes(mesh, op32, 4)
    return {"ndof": int(mesh.ndof), "f32_rel_err": err32,
            "f64_rel_err": err64, "f32_apply_median_us": t * 1e6,
            "f32_apply_spread_us": [t_min * 1e6, t * 1e6, t_max * 1e6],
            "flops": flops, "bytes_min": nbytes}


def parity_phase(mx=6, max_its=REF_ITS_MX6):
    """The jitted direct-float64 ABFSolver.solve on the default device and
    on the CPU backend, same process, same problem (at mx=6 the
    reference's exSaddle3d_pseudoice_1 case, which takes 20 iterations)."""
    import jax
    import jax.numpy as jnp
    import bench
    from exsaddle_tpu.abf import ABFSolver

    prob = bench._build_problem(mx, with_rhs=True)

    def solve():
        slv = ABFSolver(prob["mesh"], prob["fes"], prob["coeff"],
                        prob["bc_idx"], prob["bc_vals"], dtype=jnp.float64)
        return slv.solve(prob["F_raw"] + slv.setup["rhs_diri"])

    dev = solve()
    with jax.default_device(_cpu()):
        cpu = solve()
    for name, res in (("device", dev), ("cpu", cpu)):
        if res["reason"] != "CONVERGED_RTOL":
            raise AssertionError(f"{name} solve: {res['reason']}")
    diff = float(np.linalg.norm(dev["x"] - cpu["x"])
                 / np.linalg.norm(cpu["x"]))
    if abs(dev["its"] - cpu["its"]) > 1 or dev["its"] > max_its:
        raise AssertionError(f"iterations device {dev['its']} vs cpu "
                             f"{cpu['its']} (at most {max_its})")
    if not diff <= SOLVE_DIFF_TOL:
        raise AssertionError(f"device vs cpu solution diff {diff:g}")
    return {"its_device": dev["its"], "its_cpu": cpu["its"],
            "rel_solution_diff": diff}


def four_phase(mx=32, nlevels=4, extra_args=()):
    """saddle_solve over every visible device (the cartesian device-mesh
    solve, float64: refinement is single-device) against the single-device
    jitted float64 ABFSolver.solve with the same options."""
    import jax
    import jax.numpy as jnp
    from exsaddle_tpu.abf import ABFSolver
    from exsaddle_tpu.driver import abf_solver_kw, saddle_solve
    from exsaddle_tpu.options import Options

    args = flagship_args(mx, nlevels, ir=False) + list(extra_args)
    t0 = time.perf_counter()
    r = saddle_solve(Options.from_args(args), 3, log=lambda *a, **k: None)
    t_cart = time.perf_counter() - t0
    mode = getattr(r["ksp"], "_mode", None)
    if mode != "cart":
        raise AssertionError(f"saddle_solve dispatched {mode!r}, not 'cart'")
    fine = r["levels"][-1]
    t0 = time.perf_counter()
    with jax.default_device(jax.devices()[0]):
        slv = ABFSolver(fine.mesh, fine.fes, fine.coeff_qp, fine.bc_idx,
                        fine.bc_vals, dtype=jnp.float64,
                        **abf_solver_kw(Options.from_args(args)))
        one = slv.solve(np.asarray(r["F"]))
    t_one = time.perf_counter() - t0
    its = int(r["result"].its)
    diff = float(np.linalg.norm(np.asarray(r["X"]) - one["x"])
                 / np.linalg.norm(one["x"]))
    if "CONVERGED" not in str(r["result"].reason) or \
            one["reason"] != "CONVERGED_RTOL":
        raise AssertionError(f"cart {r['result'].reason}, single "
                             f"{one['reason']}")
    if abs(its - one["its"]) > 1:
        raise AssertionError(f"iterations cart {its} vs single {one['its']}")
    if not diff <= SOLVE_DIFF_TOL:
        raise AssertionError(f"cart vs single-device solution diff {diff:g}")
    return {"mode": mode, "devices": len(jax.devices()),
            "dev_shape": list(r["ksp"]._slv.part.dev_shape),
            "its_cart": its, "its_single": one["its"],
            "rel_solution_diff": diff,
            "cart_setup_plus_solve_s": t_cart,
            "single_setup_plus_solve_s": t_one}


def _select_cards(four):
    """Before JAX starts: keep one card visible unless --four."""
    if four:
        return
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = (
        visible.split(",")[0].strip() if visible else "0")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU cartesian solve check")
    args = ap.parse_args(argv)
    _select_cards(args.four)

    import jax
    import bench
    from exsaddle_tpu.compile_cache import enable_compile_cache

    jax.config.update("jax_enable_x64", True)
    enable_compile_cache()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke.py needs a GPU; JAX found "
                 f"{devs[0].platform!r}")
    want = 4 if args.four else 1
    if len(devs) != want:
        sys.exit(f"expected {want} visible GPU(s), JAX sees {len(devs)}")
    card = bench.card_info()
    emit("card", nvidia_smi=card["nvidia_smi"],
         device_kind=devs[0].device_kind)

    if args.four:
        emit("four", **four_phase(), power_limit=card["power_limit"])
    else:
        s = solve_phase()
        emit("dispatch", mode=s.pop("mode"))
        emit("setup", seconds=s.pop("setup_s"))
        emit("compile_first_solve", seconds=s.pop("compile_first_solve_s"))
        emit("warm_solve", median_seconds=s.pop("warm_solve_median_s"),
             seconds=s.pop("warm_solve_s"), power_limit=card["power_limit"])
        emit("memory", memory_analysis=s.pop("memory_analysis"),
             peak_bytes_in_use=s.pop("peak_bytes_in_use"))
        emit("solve", **s)
        a = apply_phase()
        pk = bench.device_peaks(devs[0])
        roof = bench.roofline(a["flops"], a["bytes_min"],
                              a["f32_apply_median_us"] * 1e-6,
                              pk["fp32_tflops"] * 1e12, pk["hbm_gbs"] * 1e9)
        emit("apply", **a, roofline_vs_published=roof,
             peaks_source=pk["source"], power_limit=card["power_limit"])
        emit("parity_mx6", **parity_phase())

    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
