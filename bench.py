"""Benchmark: flagship 3D pseudoice Stokes -- operator apply AND full solve.

Two measurements on one GPU:

1. The hot kernel (matrix-free parity-layout saddle apply, the SpMV of every
   Krylov iteration -- SURVEY.md section 3.2) timed inside one jit
   (lax.fori_loop) in float32 with full-FP32 matmuls. Reported against the
   card's published peaks (PEAKS) as a roofline share -- the larger of
   FLOPs over the FP32 peak and bytes over HBM bandwidth, naming which one
   binds -- and against a same-call measured copy and GEMM
   (_device_calibration). The headline vs_baseline keeps the historical
   effective-CSR-bandwidth fraction: the bytes an assembled-CSR SpMV would
   move over the measured time, as a fraction of HBM bandwidth.

2. The full ABF solve (exsaddle_tpu/abf.py: FGMRES / fieldsplit-Schur /
   Galerkin-MG / Chebyshev, the abf.opts flagship configuration) to a TRUE
   float64 relative residual of 1e-8 via mixed-precision iterative
   refinement -- end-to-end wall clock, iterations, ms per outer iteration
   (extras "solve_*").

Needs a GPU listed in PEAKS; any other device is an error. Prints exactly
ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "extras": {...}}
and exits non-zero when the solve fails.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np


# Published peaks per jax device_kind. Source: NVIDIA H100 Tensor Core GPU
# data sheet, H100 SXM column, dense rates without sparsity, rated at the
# full 700 W power limit (a card capped lower cannot hold its top clock).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "name": "H100 SXM",
        "hbm_gbs": 3350.0,
        "fp32_tflops": 67.0,        # CUDA cores, no tensor cores
        "tf32_tflops": 495.0,       # tensor cores
        "fp64_tflops": 34.0,        # CUDA cores
        "fp64_tensor_tflops": 67.0,
        "source": "NVIDIA H100 Tensor Core GPU data sheet, SXM, dense",
    },
}


def device_peaks(dev):
    """Published peaks of `dev`; raises for a device not in PEAKS."""
    kind = dev.device_kind
    if kind not in PEAKS:
        raise ValueError(f"no published peaks for device_kind {kind!r} "
                         f"(platform {dev.platform}); add a PEAKS row")
    return PEAKS[kind]


def card_info():
    """(name, power limit) of the GPU as nvidia-smi reports them -- read
    by a child process that never touches JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    first = out.strip().splitlines()[0]
    name, limit = (f.strip() for f in first.split(",", 1))
    return {"nvidia_smi": first.strip(), "name": name, "power_limit": limit}


def roofline(flops, nbytes, seconds, flops_per_s, bytes_per_s):
    """Least time the chip could take (the larger of FLOPs over compute
    peak and bytes over memory bandwidth), which bound binds, and the
    measured time's share of it."""
    t_flops = flops / flops_per_s
    t_bytes = nbytes / bytes_per_s
    t_floor = max(t_flops, t_bytes)
    return {"t_flops_us": round(t_flops * 1e6, 2),
            "t_bytes_us": round(t_bytes * 1e6, 2),
            "bound": "compute" if t_flops >= t_bytes else "memory",
            "t_floor_us": round(t_floor * 1e6, 2),
            "share": round(t_floor / seconds, 4)}


def time_per_iter(fn, args, n_inner, reps):
    """(median, min, max) seconds per inner iteration of fn(*args) over
    `reps` timed calls after one warm call."""
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) / n_inner)
    return float(np.median(ts)), float(min(ts)), float(max(ts))


def _build_problem(mx, with_rhs=False):
    from exsaddle_tpu import models as emodels, driver
    from exsaddle_tpu.assembly import (FESpace, project_qp_to_q1,
                                       interp_q1_to_qp, assemble_rhs,
                                       scatter_vector)
    from exsaddle_tpu.mesh import SaddleMesh
    from exsaddle_tpu.options import Options

    opts = Options.from_args(["-model", "11", "-size_x", "0.1"])
    ctx = emodels.ModelContext(opts, 3, log=lambda *a, **k: None)
    mesh = SaddleMesh(3, (mx, mx, mx), (0.1, 1.0, 1.0))
    fes = FESpace(mesh)
    bc_idx, bc_vals = emodels.create_bc_list(ctx, mesh)
    c = emodels.evaluate_coefficients(
        ctx, fes.qp_coords.reshape(-1, 3)).reshape(mesh.nel, fes.nqp, -1)
    nodal = project_qp_to_q1(fes, c)
    coeff = driver._qp_dict(ctx, interp_q1_to_qp(fes, nodal))
    out = {"mesh": mesh, "fes": fes, "coeff": coeff, "bc_idx": bc_idx,
           "bc_vals": bc_vals}
    if with_rhs:
        f1, f2 = assemble_rhs(fes, coeff["Fu"], coeff["Fp"])
        F = scatter_vector(mesh, f1, f2)
        F[: mesh.nu][bc_idx] = bc_vals
        out["F_raw"] = F
    return out


def bench_solver_kw(env=True):
    """The tuned mixed-precision IR schedule for the flagship bench solve
    (all knobs env-overridable). The values were tuned on earlier
    hardware and are not yet re-measured on the H100 (ROADMAP S5):

      gcr_rtol 3e-2      the u-block GCR tolerance loosens from abf.opts'
                         1e-2 (the flexible outer FGMRES absorbs the
                         weaker inner solve for a couple more outer its)
      gcr_restart 12     the GCR truncation window shrinks to the
                         iterations actually used (identical math, less
                         Gram-Schmidt traffic)
      cheb_pre_its 4     the V-cycle pre-smooth drops to 4 Chebyshev its
                         (post stays 8)
      rtol 3e-4          the per-round inner FGMRES stops at 3e-4, tight
                         enough that three refinement rounds reach the
                         true 1e-8 target

    The TRUE float64 1e-8 target is unchanged and verified per round.

    env=False ignores the BENCH_* environment overrides and returns the
    committed defaults -- the convergence-anchor tests use this so stale
    sweep variables in a developer's shell cannot shift their bands."""
    if not env:
        return dict(cheb_its=8, rtol=3e-4, gcr_rtol=0.03, gcr_restart=12,
                    cheb_pre_its=4)
    return dict(
        cheb_its=8,
        rtol=float(os.environ.get("BENCH_INNER_RTOL", "3e-4")),
        gcr_rtol=float(os.environ.get("BENCH_GCR_RTOL", "0.03")),
        gcr_restart=int(os.environ.get("BENCH_GCR_RESTART", "12")),
        cheb_pre_its=int(os.environ.get("BENCH_CHEB_PRE", "4")),
    )


def _apply_flops_bytes(mesh, op, itemsize):
    """Exact matmul FLOPs and minimum HBM bytes of one mult_tree apply."""
    nel = mesh.nel
    nud = mesh.ndim * mesh.u_basis
    npb = mesh.p_basis
    nqp = op.nqp
    nqpc = nqp * op.ncomp
    flops = 2 * nel * (nud * nqpc      # xe @ Bs^T
                       + nqpc * nud    # strain @ Bs
                       + npb * nqp     # pe @ Np^T
                       + nqp * nud     # ptmp @ Dm
                       + nud * nqp     # xe @ Dm^T
                       + nqp * npb)    # div @ Np
    flops += nel * (nqpc * 2 + nqp * 3)          # elementwise scalings
    # minimum HBM traffic: per-element coefficient data + x read + y write
    # + keep/mask reads (intermediates that spill add on top of this)
    ndof = mesh.ndof
    bytes_min = (nel * nqpc * itemsize           # scale_visc
                 + 4 * ndof * itemsize)          # x, y, keep, mask
    return flops, bytes_min


def _trace_top_ops(run, n=5):
    """jax.profiler trace of run() -> the top-n GPU operations by total
    device time. A trace without GPU device events is an error."""
    import glob
    import tempfile

    import jax
    from jax.profiler import ProfileData

    with tempfile.TemporaryDirectory() as td:
        with jax.profiler.trace(td):
            run()
        paths = glob.glob(f"{td}/**/*.xplane.pb", recursive=True)
        if not paths:
            raise RuntimeError("profiler wrote no trace")
        prof = ProfileData.from_file(paths[0])
        totals = {}
        for plane in prof.planes:
            if not plane.name.startswith("/device:GPU"):
                continue
            lines = list(plane.lines)
            ops = [ln for ln in lines if ln.name == "XLA Ops"] or lines
            for ln in ops:
                for ev in ln.events:
                    totals[ev.name] = (totals.get(ev.name, 0.0)
                                       + ev.duration_ns / 1e3)
    if not totals:
        raise RuntimeError("trace holds no GPU device events")
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
    return [{"name": k[:80], "total_us": round(v, 1)} for k, v in top]


def stabilized_applies(op, aux, tree, inner):
    """A jitted loop of `inner` float32 applies whose iterates stay
    bounded, with nothing in the loop body but the production apply.

    A repeated apply needs bounded magnitudes; a per-iteration
    norm+rescale would add dependent reductions to every step. Instead a
    constant 1/rho, rho the measured dominant growth rate, is folded into
    the operator's coefficient data (scale_visc and fac): the timed body
    is then the production apply's exact HLO, and the iterates converge
    to the dominant eigenvector with growth ~1.

    Returns (applies, op_c, tree_c, rho) with applies(op_c, aux, tree_c)
    the timed loop."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax import lax
    from exsaddle_tpu.matfree import mult_tree, tree_norm

    @jax.jit
    def norm_applies(op, aux, tree):
        with jax.default_matmul_precision("float32"):
            def step(_, carry):
                y = mult_tree(op, aux, carry[0])
                n = tree_norm(y)
                return jax.tree.map(lambda a: a / n, y), n
            return lax.fori_loop(0, 30, step, (tree, jnp.float32(1.0)))

    tree_c, rho = norm_applies(op, aux, tree)
    c = jnp.float32(1.0 / float(rho))
    op_c = dataclasses.replace(op, scale_visc=op.scale_visc * c,
                               fac=op.fac * c)

    @jax.jit
    def applies(op, aux, tree):
        with jax.default_matmul_precision("float32"):
            return lax.fori_loop(0, inner,
                                 lambda _, tr: mult_tree(op, aux, tr), tree)

    out = applies(op_c, aux, tree_c)
    fin = float(tree_norm(out))
    if not (np.isfinite(fin) and 1e-12 < fin < 1e12):
        raise RuntimeError(f"scaled apply loop left float32 range: {fin}")
    return applies, op_c, tree_c, float(rho)


def bench_apply(mx, inner, reps):
    import jax
    import jax.numpy as jnp
    from exsaddle_tpu.matfree import (ParityMatFreeOperator, assembled_nnz,
                                      tree_aux, to_tree, mult_tree)

    prob = _build_problem(mx)
    mesh = prob["mesh"]
    bc_mask = np.zeros(mesh.ndof)
    bc_mask[prob["bc_idx"]] = 1.0
    op = ParityMatFreeOperator.build(mesh, prob["fes"], prob["coeff"],
                                     bc_mask, dtype=jnp.float32)
    aux = tree_aux(op)
    x = jnp.asarray(np.random.default_rng(0)
                    .standard_normal(mesh.ndof).astype(np.float32))
    applies, op_c, tree, rho = stabilized_applies(op, aux, to_tree(op, x),
                                                  inner)
    t_apply, t_min, t_max = time_per_iter(applies, (op_c, aux, tree),
                                          inner, reps)
    breakdown = {"power_rho": round(rho, 4),
                 "apply_spread_us": [round(t_min * 1e6, 2),
                                     round(t_apply * 1e6, 2),
                                     round(t_max * 1e6, 2)]}

    nnz = assembled_nnz(mesh)
    csr_bytes = nnz * 8 + 3 * mesh.ndof * 4      # CSR vals+cols + x,y traffic
    flops, bytes_min = _apply_flops_bytes(mesh, op, 4)

    # XLA's own flop/byte count for ONE apply (XLA counts a while body
    # once, so the looped executable under-reports by the trip count)
    def one_fn(op, aux, tr):
        with jax.default_matmul_precision("float32"):
            return mult_tree(op, aux, tr)
    compiled = jax.jit(one_fn).lower(op_c, aux, tree).compile()
    ca = compiled.cost_analysis() or {}
    xf = float(ca.get("flops", 0.0))
    xb = float(ca.get("bytes accessed", 0.0))
    mem = compiled.memory_analysis()
    breakdown.update({
        "xla_flops_per_apply": xf,
        "xla_bytes_per_apply": xb,
        "xla_tflops_measured": round(xf / t_apply / 1e12, 3),
        "xla_hbm_gbs_measured": round(xb / t_apply / 1e9, 1),
        "xla_temp_bytes": mem.temp_size_in_bytes,
        "xla_arg_bytes": mem.argument_size_in_bytes,
    })
    breakdown["trace_top_ops"] = _trace_top_ops(
        lambda: jax.block_until_ready(applies(op_c, aux, tree)))

    # roofline against the published peaks (full-FP32 matmuls: the
    # solver needs float32-accurate products, so the FP32 peak -- not
    # TF32 -- bounds the FLOPs), then against this card's same-call
    # measured copy bandwidth and FP32 GEMM rate
    pk = device_peaks(jax.devices()[0])
    breakdown["roofline"] = roofline(flops, bytes_min, t_apply,
                                     pk["fp32_tflops"] * 1e12,
                                     pk["hbm_gbs"] * 1e9)
    cal = _device_calibration(reps, mesh.nel)
    breakdown["device_calibration"] = cal
    breakdown["roofline_measured"] = roofline(
        flops, bytes_min, t_apply, cal["gemm4k_f32_tflops"] * 1e12,
        cal["stream_gbs"] * 1e9)
    breakdown["roofline_measured"]["fraction_of_shape_ceiling"] = round(
        cal["t_2gemm_shape_us"] / (t_apply * 1e6), 3)

    return {
        "t_apply_us": round(t_apply * 1e6, 2),
        "spmv_nnz_per_s": round(nnz / t_apply / 1e9, 2),   # Gnnz/s
        "effective_csr_gbs": round(csr_bytes / t_apply / 1e9, 1),
        "actual_bytes_min": bytes_min,
        "achieved_gbs_min": round(bytes_min / t_apply / 1e9, 1),
        "apply_tflops": round(flops / t_apply / 1e12, 3),
        "assembled_nnz": nnz,
        "kernel_breakdown": breakdown,
    }


def _device_calibration(reps, nel):
    """What this card delivers, measured in the same call: a 256 MB
    streaming triad, a 4096^3 full-FP32 GEMM, and the apply's own
    GEMM-shaped chain ((nel,81)@(81,162)@(162,81), i.e. the apply with
    all gather/scatter/coupling/mask work deleted) -- the tightest honest
    ceiling for the apply's matmuls at their small K/N."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    rng = np.random.default_rng(0)
    out = {}
    n = 256 * 1024 * 1024 // 4
    x = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    T_IN = 20

    @jax.jit
    def triad(x):
        def body(i, y):
            return y * jnp.float32(0.999) + x * (1e-9 * i.astype(
                jnp.float32))
        return lax.fori_loop(0, T_IN, body, jnp.zeros_like(x))[::65536]

    t, _, _ = time_per_iter(triad, (x,), T_IN, reps)
    out["stream_gbs"] = round(3 * n * 4 / t / 1e9, 1)
    del x

    m = 4096
    A = jnp.asarray(rng.standard_normal((m, m)).astype(np.float32))
    B = jnp.asarray(rng.standard_normal((m, m)).astype(np.float32))

    @jax.jit
    def gemm(A, B):
        with jax.default_matmul_precision("float32"):
            def body(i, A):
                return jnp.tanh(A @ B)
            return lax.fori_loop(0, T_IN, body, A)[::512, ::512]

    t, _, _ = time_per_iter(gemm, (A, B), T_IN, reps)
    out["gemm4k_f32_tflops"] = round(2 * m ** 3 / t / 1e12, 1)
    del A, B

    A = jnp.asarray(rng.standard_normal((nel, 81)).astype(np.float32))
    B1 = jnp.asarray(rng.standard_normal((81, 162)).astype(np.float32))
    B2 = jnp.asarray(rng.standard_normal((162, 81)).astype(np.float32))

    @jax.jit
    def two(A):
        with jax.default_matmul_precision("float32"):
            def body(i, A):
                return ((A @ B1) @ B2) * jnp.float32(0.05)
            return lax.fori_loop(0, 100, body, A)

    t, _, _ = time_per_iter(two, (A,), 100, reps)
    out["t_2gemm_shape_us"] = round(t * 1e6, 1)
    out["gemm_shape_tflops"] = round(
        2 * nel * (81 * 162 * 2) / t / 1e12, 2)
    return out


def bench_solve(mx, rtol):
    """Full jitted ABF solve (mixed-precision IR to true f64 rtol)."""
    import jax.numpy as jnp
    from exsaddle_tpu.abf import ABFSolver

    prob = _build_problem(mx, with_rhs=True)
    mesh = prob["mesh"]
    # enough levels that the replicated dense coarse solve stays small
    nlevels = 3
    while min((g - 1) // 2 ** (nlevels - 1) + 1
              for g in mesh.nn_u) > 12:
        nlevels += 1
    t0 = time.perf_counter()
    slv = ABFSolver(mesh, prob["fes"], prob["coeff"], prob["bc_idx"],
                    prob["bc_vals"], dtype=jnp.float32, nlevels=nlevels,
                    ir=True, **bench_solver_kw())
    t_setup = time.perf_counter() - t0
    F = prob["F_raw"] + slv.setup["rhs_diri"]
    t0 = time.perf_counter()
    res = slv.solve_ir(F, rtol=rtol)             # compile + first solve
    t_first = time.perf_counter() - t0
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        res = slv.solve_ir(F, rtol=rtol)
        times.append(time.perf_counter() - t0)
    t_solve = float(np.median(times))
    return {
        "solve_spread_s": [min(times), t_solve, max(times)],
        "solve_mx": mx,
        "solve_nlevels": nlevels,
        "solve_ndof": mesh.ndof,
        "solve_rtol": rtol,
        "solve_converged": bool(res["converged"]),
        "solve_true_rel_resid": res["rnorm"] / res["rnorm0"],
        "solve_seconds": t_solve,
        "solve_setup_seconds": t_setup,
        "solve_compile_first_seconds": t_first,
        "solve_outer_its": res["inner_its"],
        "solve_ir_rounds": res["rounds"],
        "solve_ms_per_outer_it": 1e3 * t_solve / max(res["inner_its"], 1),
    }


def main():
    import jax
    from exsaddle_tpu.compile_cache import enable_compile_cache
    # float64 must be real for the IR true-residual path (the apply bench
    # keeps explicit float32 dtypes)
    jax.config.update("jax_enable_x64", True)
    enable_compile_cache()

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; found {dev.platform}")
    peaks = device_peaks(dev)
    mx = int(os.environ.get("BENCH_MX", "32"))
    inner = int(os.environ.get("BENCH_INNER", "100"))
    reps = int(os.environ.get("BENCH_REPS", "5"))
    solve_mx = int(os.environ.get("BENCH_SOLVE_MX", "32"))
    rtol = float(os.environ.get("BENCH_SOLVE_RTOL", "1e-8"))

    extras = {"device": {"platform": dev.platform,
                         "kind": dev.device_kind,
                         "count": len(jax.devices())},
              "card": card_info()}
    extras.update(bench_apply(mx, inner, reps))
    solve_ok = False
    try:
        extras.update(bench_solve(solve_mx, rtol))
        solve_ok = bool(extras.get("solve_converged"))
    except Exception as e:
        extras["solve_error"] = f"{type(e).__name__}: {e}"

    kind = peaks["name"].replace(" ", "_")
    if solve_ok:
        # headline: end-to-end flagship solve (3D pseudoice ABF to TRUE
        # f64 rtol 1e-8), with the apply roofline numbers alongside
        print(json.dumps({
            "metric": f"pseudoice3d_abf_solve_mx{solve_mx}"
                      f"_rtol{rtol:g}_{kind}",
            "value": extras["solve_seconds"],
            "unit": "s",
            "vs_baseline": round(extras["effective_csr_gbs"]
                                 / peaks["hbm_gbs"], 3),
            "extras": extras,
        }))
    else:
        print(json.dumps({
            "metric": f"pseudoice3d_SOLVE_FAILED_mx{solve_mx}_{kind}",
            "value": 0.0,
            "unit": "s",
            "vs_baseline": 0.0,
            "extras": extras,
        }))
        sys.exit(1)


if __name__ == "__main__":
    main()
