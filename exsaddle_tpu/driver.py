"""Driver: end-to-end saddle solve, the equivalent of exSaddle.c's
SaddleSolve_Q2Q1 (exSaddle.c:124-566).

Pipeline: options -> MG mesh hierarchy -> BC lists -> coefficient evaluation
+ Q1 projection + restriction chain -> per-level assembly with Dirichlet
elimination -> RHS -> solver tree from options -> solve -> diagnostics /
error checks / dumps. Output lines reproduce the reference's stdout so runs
can be diffed against testref/."""

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from exsaddle_tpu import io as esio
from exsaddle_tpu import models as emodels
from exsaddle_tpu import solver_config as sc
from exsaddle_tpu.assembly import (FESpace, assemble_element_matrices,
                                   assemble_rhs, assemble_schur_pre,
                                   scatter_vector, project_qp_to_q1,
                                   interp_q1_to_qp)
from exsaddle_tpu.krylov import KSPConfig
from exsaddle_tpu.mesh import SaddleMesh
from exsaddle_tpu.operator import (apply_dirichlet_elimination,
                                   PressureOperator)
from exsaddle_tpu.precond_mg import Prolongation, BlockDiagProlongation
from exsaddle_tpu.options import Options


@dataclass
class LevelData:
    mesh: SaddleMesh
    fes: FESpace
    coeff_qp: dict          # per-qp coefficient dict (post-projection)
    op: object = None       # SaddleOperator
    rhs_diri: object = None
    bc_idx: object = None
    bc_vals: object = None


def _coefficient_pipeline(levels, ctx):
    """FEMixedSpaceDefineQPwiseProperties_Q1Projection
    (femixedspace.c:1937-2266): evaluate at fine qps, project to Q1 nodes,
    re-interpolate; coarse levels by scaled restriction of the nodal fields.
    """
    nlev = len(levels)
    fine = levels[-1]
    pts = fine.fes.qp_coords.reshape(-1, ctx.ndim)
    c = emodels.evaluate_coefficients(ctx, pts).reshape(
        fine.mesh.nel, fine.fes.nqp, -1)
    nodal = project_qp_to_q1(fine.fes, c)
    fine.coeff_qp = _qp_dict(ctx, interp_q1_to_qp(fine.fes, nodal))

    view_coeffs = ctx.opts.get_bool("view_coeffs", False)

    def _dump_coeffs(lvl_idx, lvl, nod):
        """-view_coeffs: nodal Q1 coefficient fields as VTK
        (femixedspace.c:2092-2123, 2224-2254)."""
        names = (["mu", "Fu_x", "Fu_y", "Fp", "lambda", "Fu_z"][:nod.shape[1]]
                 if ctx.lame else
                 ["eta", "Fu_x", "Fu_y", "Fp", "Fu_z"][:nod.shape[1]])
        esio.write_vts(f"coeffs_{lvl_idx}.vts", lvl.mesh.nn_p,
                       lvl.mesh.p_coords,
                       {nm: nod[:, j] for j, nm in enumerate(names)})

    if view_coeffs:
        _dump_coeffs(nlev - 1, fine, nodal)

    nodal_f = nodal
    for k in range(nlev - 2, -1, -1):
        P = Prolongation(levels[k].mesh.nn_p, levels[k + 1].mesh.nn_p, dof=1)
        scale = np.asarray(P.restriction_scale())
        nodal_c = np.stack(
            [np.asarray(P.restrict(jnp.asarray(nodal_f[:, j]))) * scale
             for j in range(nodal_f.shape[1])], axis=1)
        levels[k].coeff_qp = _qp_dict(
            ctx, interp_q1_to_qp(levels[k].fes, nodal_c))
        if view_coeffs:
            _dump_coeffs(k, levels[k], nodal_c)
        nodal_f = nodal_c


def _qp_dict(ctx, cq):
    nel, nqp, _ = cq.shape
    d = emodels.unpack_coefficients(ctx, cq.reshape(nel * nqp, -1))
    out = {"Fu": d["Fu"].reshape(nel, nqp, ctx.ndim),
           "Fp": d["Fp"].reshape(nel, nqp)}
    if ctx.lame:
        out["mu"] = d["mu"].reshape(nel, nqp)
        out["lambda"] = d["lambda"].reshape(nel, nqp)
    else:
        out["eta"] = d["eta"].reshape(nel, nqp)
    return out


def _make_saddle_matshell(lv, lame, dm_info=None, names=("Asaddle",
                                                        "Mpscaled")):
    """MatShell for a level's saddle operator, with fieldsplit block info,
    velocity-grid MG info, and DM decomposition info (for -pc_type asm
    virtual-rank subdomains) attached.

    names: (saddle matrix name, Schur-pre name) for -ksp_view. The
    reference names ONLY the fine-level objects "Asaddle"/"Mpscaled"
    (exSaddle.c:272,316) and the fs_coarse Schur-pre "Mpscaled_coarse"
    (exSaddle.c:369); rediscretized coarse saddle matrices are unnamed."""
    op = lv.op
    mesh = lv.mesh
    mult = jax.jit(op.mult)
    A00 = sc.MatShell(
        mesh.nu, jax.jit(op.mult_u),
        diagonal=lambda: np.asarray(op.diagonal())[: mesh.nu],
        csr=lambda: op.to_csr()[: mesh.nu, : mesh.nu].tocsr(),
        mg_info={"node_nn": mesh.nn_u, "dof": mesh.ndim})
    A11p = sc.MatShell(
        mesh.np_, jax.jit(op.mult_p),
        diagonal=lambda: np.asarray(op.diagonal())[mesh.nu:],
        csr=lambda: op.to_csr()[mesh.nu:, mesh.nu:].tocsr())
    Sel = assemble_schur_pre(lv.fes, lv.coeff_qp, lame=lame)
    pop = PressureOperator(S=jnp.asarray(Sel),
                           p_el_nodes=jnp.asarray(mesh.p_el_nodes),
                           n=mesh.np_)
    Sp = sc.MatShell(mesh.np_, jax.jit(pop.mult),
                     diagonal=lambda: np.asarray(pop.diagonal()),
                     csr=pop.to_csr)
    fieldsplit = {"A00": A00, "A11": A11p,
                  "mult_up": jax.jit(op.mult_up),
                  "mult_pu": jax.jit(op.mult_pu), "Sp": Sp}
    amat = sc.MatShell(mesh.ndof, mult,
                       diagonal=lambda: np.asarray(op.diagonal()),
                       csr=op.to_csr, fieldsplit=fieldsplit)
    amat.Sp = Sp
    # -ksp_view metadata (exsaddle_tpu/ksp_view.py): names, the reference's
    # preallocation estimate, I-node counts (dof-triple velocity rows
    # coalesce; pressure rows do not), coupling-block sizes
    from exsaddle_tpu.matfree import allocated_nnz, coupling_nnz
    amat.view_info = {"name": names[0],
                      "allocated": allocated_nnz(mesh),
                      "inode": mesh.n_u_nodes + mesh.np_}
    A00.view_info = {"inode": mesh.n_u_nodes}
    Sp.view_info = {"name": names[1]}
    fieldsplit["view"] = {"A10_nnz": coupling_nnz(mesh),
                          "A01_inode": mesh.n_u_nodes,
                          "A00_n": mesh.nu}
    if dm_info is not None:
        amat.dm_info = dict(dm_info, mesh=mesh)
        nranks = dm_info["nranks"]
        if nranks > 1:
            from exsaddle_tpu import decomp
            blocks = decomp.bjacobi_block_ranges(mesh, nranks)
            amat.block_info = blocks
            A00.block_info = [b[b < mesh.nu] for b in blocks]
            pblocks = [b[b >= mesh.nu] - mesh.nu for b in blocks]
            A11p.block_info = pblocks
            Sp.block_info = pblocks
    return amat


def _abf_options_match(opts, prefix="saddle_"):
    """True when the options tree requests the abf.opts ABF configuration
    (fgmres / fieldsplit-Schur-UPPER / u: gcr + Galerkin MG +
    chebyshev-jacobi / p: preonly) -- the configuration the fully-jitted
    ABFSolver implements. Deliberately conservative: any sub-option the
    jitted path would IGNORE (a different fieldsplit type/factorization,
    non-jacobi smoother PC, a custom esteig transform, nonzero initial
    guess) rejects the dispatch so the host path honors it instead."""
    est = opts.get_real_list("fieldsplit_u_mg_levels_ksp_chebyshev_esteig",
                             None, prefix=prefix)
    return (opts.get_bool("fs", False)
            and opts.get_string("ksp_type", "gmres",
                                prefix=prefix) == "fgmres"
            and opts.get_string("fieldsplit_u_ksp_type", "gmres",
                                prefix=prefix) == "gcr"
            and opts.get_string("fieldsplit_u_pc_type", "ilu",
                                prefix=prefix) == "mg"
            and opts.get_bool("fieldsplit_u_pc_mg_galerkin", False,
                              prefix=prefix)
            and opts.get_string("fieldsplit_u_mg_levels_ksp_type",
                                "chebyshev",
                                prefix=prefix) == "chebyshev"
            and opts.get_string("fieldsplit_p_ksp_type", "preonly",
                                prefix=prefix) == "preonly"
            and opts.get_string("pc_fieldsplit_type", "schur",
                                prefix=prefix) == "schur"
            and opts.get_string("pc_fieldsplit_schur_fact_type", "upper",
                                prefix=prefix) == "upper"
            and opts.get_string("fieldsplit_u_mg_levels_pc_type",
                                "jacobi", prefix=prefix) == "jacobi"
            and (est is None or tuple(est) == (0.0, 0.2, 0.0, 1.1))
            and not opts.get_bool("ksp_initial_guess_nonzero", False,
                                  prefix=prefix)
            and opts.get_string("ksp_norm_type", "unpreconditioned",
                                prefix=prefix) == "unpreconditioned"
            and opts.get_string("ksp_pc_side", "right",
                                prefix=prefix) == "right"
            # sub-options the jitted path cannot honor reject the
            # dispatch (ADVICE r4): any p-block PC other than the
            # bjacobi+ILU the Chebyshev polynomial stands in for, a
            # non-default Galerkin coarse solver, or a non-NONE smoother
            # norm type (which changes Chebyshev semantics)
            and opts.get_string("fieldsplit_p_pc_type", "bjacobi",
                                prefix=prefix) == "bjacobi"
            and opts.get_string("fieldsplit_p_sub_pc_type", "ilu",
                                prefix=prefix) == "ilu"
            and opts.get_string("fieldsplit_u_mg_coarse_pc_type",
                                "redundant", prefix=prefix) == "redundant"
            and opts.get_string("fieldsplit_u_mg_coarse_ksp_type",
                                "preonly", prefix=prefix) == "preonly"
            and opts.get_string("fieldsplit_u_mg_levels_ksp_norm_type",
                                "none", prefix=prefix) == "none")


def abf_solver_kw(opts, prefix="saddle_"):
    """Keyword arguments of the jitted ABF solvers (ABFSolver,
    CartABFSolver) that the options tree sets."""
    nlv_u = opts.get_int("fieldsplit_u_pc_mg_levels", 3, prefix=prefix)
    max_it = opts.get_int("ksp_max_it", 10000, prefix=prefix)
    return dict(
        nlevels=nlv_u,
        restart=opts.get_int("ksp_gmres_restart", 30, prefix=prefix),
        rtol=opts.get_real("ksp_rtol", 1e-5, prefix=prefix),
        atol=opts.get_real("ksp_atol", 1e-50, prefix=prefix),
        dtol=opts.get_real("ksp_divtol", 1e4, prefix=prefix),
        max_it=max_it,
        # monitor history must not truncate where the host path would
        # print every iteration
        hist_len=max(256, min(max_it, 100000) + 1),
        # default matches the host KSPConfig default (1e-5) so an
        # options tree omitting the rtol solves identically on both
        # paths; abf.opts sets 1e-2 explicitly
        gcr_rtol=opts.get_real("fieldsplit_u_ksp_rtol", 1e-5,
                               prefix=prefix),
        # numeric u-KSP sub-options ARE honored (ADVICE r4): the GCR
        # truncation window and iteration cap plumb straight through
        gcr_restart=opts.get_int("fieldsplit_u_ksp_gcr_restart", 30,
                                 prefix=prefix),
        gcr_max_it=opts.get_int("fieldsplit_u_ksp_max_it", 200,
                                prefix=prefix),
        cheb_its=opts.get_int("fieldsplit_u_mg_levels_ksp_max_it", 8,
                              prefix=prefix))


def _choose_dev_shape(m_el, ndev):
    """Cartesian device grid for `ndev` devices over `m_el` elements:
    prime factors of ndev assigned largest-first to the axis with the
    largest local element count that divides (balanced slabs, z-major
    tie-break so single-axis splits land on the outermost axis, the
    layout parallel.multihost.host_partition assumes). Returns None when
    ndev does not factor into the mesh (caller falls back to the
    single-device solver)."""
    nd = len(m_el)
    shape = [1] * nd
    mloc = list(m_el)
    rem = ndev
    factors = []
    f = 2
    while f * f <= rem:
        while rem % f == 0:
            factors.append(f)
            rem //= f
        f += 1
    if rem > 1:
        factors.append(rem)
    for f in sorted(factors, reverse=True):
        cands = [d for d in range(nd) if mloc[d] % f == 0]
        if not cands:
            return None
        d = max(cands, key=lambda d: (mloc[d], d))
        shape[d] *= f
        mloc[d] //= f
    return tuple(shape)


def _reason_from_state(state):
    from exsaddle_tpu.treeops import reason_name
    return reason_name(state)


class _JittedKSPShim:
    """Duck-typed stand-in for the host KSP in the jitted dispatch path:
    carries .solve / .cfg so -twosolves and the result plumbing work
    unchanged.

    mode: "direct" (ABFSolver.solve), "cart" (CartABFSolver.solve over
    the device mesh) or "ir" (ABFSolver.solve_ir mixed-precision
    iterative refinement; monitor lines are the TRUE float64 residual
    per refinement round)."""

    def __init__(self, slv, monitor, reason_log, prefix, mode="direct",
                 rtol_true=1e-8):
        from exsaddle_tpu.krylov import KSPConfig
        self._slv = slv
        self._mode = mode
        self._rtol_true = rtol_true
        self.cfg = KSPConfig(type="fgmres", prefix=prefix)
        self.cfg.monitor = monitor
        self.cfg.converged_reason_log = reason_log
        self.pc = None

    def solve(self, F):
        from exsaddle_tpu.krylov import KSPResult
        if self._mode == "ir":
            res = self._slv.solve_ir(np.asarray(F), rtol=self._rtol_true)
            its = res["inner_its"]
            reason = ("CONVERGED_RTOL" if res["converged"]
                      else "DIVERGED_ITS")
            rnorm = res["rnorm"]
        else:
            res = self._slv.solve(np.asarray(F))
            its = res["its"]
            reason = (res["reason"] if "reason" in res
                      else _reason_from_state(res["state"]))
            rnorm = res["rnorm"]
        if self.cfg.monitor is not None:
            for i, rn in enumerate(res["history"]):
                self.cfg.monitor(i, rn)
        out = KSPResult(jnp.asarray(res["x"]), its, reason, rnorm)
        if self.cfg.converged_reason_log is not None:
            from exsaddle_tpu.krylov import converged_reason_message
            self.cfg.converged_reason_log(
                converged_reason_message(self.cfg.prefix, out))
        return out


def saddle_solve(opts, ndim, lame=False, log=print, nranks=1):
    """The reference's SaddleSolve_Q2Q1: returns a results dict."""
    mx = opts.get_int("mx", 4)
    my = opts.get_int("my", mx)
    mz = opts.get_int("mz", mx)
    size = [opts.get_real("size_x", 1.0), opts.get_real("size_y", 1.0)]
    if ndim == 3:
        size.append(opts.get_real("size_z", 1.0))
    fs = opts.get_bool("fs", False)
    mg = opts.get_bool("mg", False)
    fs_coarse = opts.get_bool("fs_coarse", False)
    opts.get_bool("set_ksp_dm", False)   # consumed; DM-attachment is implicit
    nlevels = opts.get_int("nlevels", 1)
    refinefactor = opts.get_int("refinefactor", 2)
    diagnostics = opts.get_bool("diagnostics", False)
    view_fields = opts.get_bool("view_fields", False)
    dump_solution = opts.get_bool("dump_solution", False)
    dump_operator = opts.get_bool("dump_operator", False)
    twosolves = opts.get_bool("twosolves", False)
    dump_pc = opts.get_bool("dump_preconditioner", False)
    dump_pc_op = opts.get_bool("dump_preconditioned_operator", False)
    dump_smoother = opts.get_bool("dump_smoother", False)
    dump_mpscaled = opts.get_bool("dump_scaled_mass_matrix", False)
    check_solution = opts.get_bool("check_solution", False)
    nullspace_flag = opts.get_bool("constant_pressure_nullspace", False)

    if fs and mg:
        raise ValueError("both -fs and -mg supplied")
    if nlevels < 1:
        raise ValueError("-nlevels < 1 supplied")
    if nlevels > 1 and fs:
        raise ValueError("-nlevels > 1 specified with -fs")
    if nlevels > 1 and not mg:
        raise ValueError("-nlevels > 1 specified without -mg")
    if nlevels < 2 and mg:
        raise ValueError("-nlevels < 2 specified with -mg")
    if fs_coarse and not mg:
        raise ValueError("-fs_coarse supplied without -mg")

    import time as _time
    log_view = opts.get_bool("log_view", False)
    stage_t = {}                  # PetscLogStage equivalent (SURVEY.md sec 5)
    _t0 = _time.perf_counter()

    m_el = (mx, my) if ndim == 2 else (mx, my, mz)
    ratio = refinefactor ** (nlevels - 1)
    if nlevels > 1:
        for m in m_el:
            if ratio > m or m % ratio:
                raise ValueError(
                    "Coarsening ratio incompatible with problem size")
    coarse_el = tuple(m // ratio for m in m_el)

    opts.nranks = nranks          # ambient comm size for parallel defaults
    ctx = emodels.ModelContext(opts, ndim, lame=lame, log=log)

    # --- levels, coarse -> fine (exSaddle.c:226-239) ---
    levels = []
    for k in range(nlevels):
        f = refinefactor ** k
        mesh = SaddleMesh(ndim, tuple(m * f for m in coarse_el), tuple(size))
        fes = FESpace(mesh)
        bc_idx, bc_vals = emodels.create_bc_list(ctx, mesh)
        # raw banner-order parity: model evaluation banner fires on the
        # coarsest level's qp evaluation
        emodels.evaluate_coefficients(
            ctx, fes.qp_coords.reshape(-1, ndim)[:1])
        lv = LevelData(mesh=mesh, fes=fes, coeff_qp=None)
        lv.bc_idx, lv.bc_vals = bc_idx, bc_vals
        levels.append(lv)

    _coefficient_pipeline(levels, ctx)
    fine = levels[-1]
    mesh = fine.mesh
    prefix = "saddle_"

    # --- one-binary dispatch (exSaddle.c:124-566 is ONE executable whose
    # options select the solver): when the options tree requests the
    # abf.opts ABF configuration and no host-KSP introspection flag is
    # set, run the fully-jitted ABFSolver -- on an accelerator by
    # default, anywhere with -jit 1, never with -jit 0. The jitted
    # p-block is the Chebyshev stand-in for serial bjacobi+ILU(0)
    # (abf.py module docstring), so residual histories are equivalent-
    # quality, not bit-identical to the host stack's. ---
    introspect = (opts.get_bool("ksp_view", False, prefix=prefix)
                  or dump_pc or dump_pc_op or dump_smoother
                  or dump_mpscaled or dump_operator or nullspace_flag
                  or nranks > 1)
    jit_flag = opts.get_bool("jit", None)
    ir_flag = opts.get_bool("ir", False)
    rtol_true = opts.get_real("rtol_true", 1e-8)
    ndev = len(jax.devices())
    use_jitted = (_abf_options_match(opts) and not introspect
                  and nlevels == 1)
    if jit_flag is None:
        # accelerators dispatch by default; on CPU the host stack stays
        # the default (a virtual multi-device CPU mesh drives the
        # distributed dispatch explicitly with -jit 1, as
        # __graft_entry__.dryrun_multichip does)
        use_jitted = use_jitted and jax.default_backend() != "cpu"
    else:
        use_jitted = use_jitted and bool(jit_flag)
    # multiple visible devices: solve on the full cartesian device mesh
    # (the mpiexec -n N leg of the reference's one executable,
    # Makefile:410-424) when the element grid factors over it
    cart_shape = (_choose_dev_shape(m_el, ndev)
                  if use_jitted and ndev > 1 else None)

    # --- assembly per level (exSaddle.c:265-270); the jitted path builds
    # its factored operator itself and never needs element batches ---
    if not use_jitted:
        for k, lv in enumerate(levels):
            elm = assemble_element_matrices(lv.fes, lv.coeff_qp, lame=lame)
            lv.op, lv.rhs_diri, _, _ = apply_dirichlet_elimination(
                lv.mesh, elm, lv.bc_idx, lv.bc_vals)

    ksp = None
    amat = None
    if use_jitted:
        from exsaddle_tpu.abf import ABFSolver
        from exsaddle_tpu.krylov import make_monitor_short
        cfg_common = abf_solver_kw(opts, prefix)
        mode = "direct"
        if cart_shape is not None:
            from exsaddle_tpu.parallel.cart import CartPartition
            from exsaddle_tpu.parallel.cart_abf import CartABFSolver
            if ir_flag:
                log("# -ir: distributed solve runs directly in float64 "
                    "(mixed-precision refinement is the single-device "
                    "path); -rtol_true ignored")
            part = CartPartition(mesh, cart_shape)
            # multi-PROCESS runtimes (mpiexec-style, one process per
            # host) get the HostComm so each process assembles only its
            # own boxes and sums the setup partials across processes --
            # the O(local) path of parallel/multihost.py
            comm = None
            if jax.process_count() > 1:
                from exsaddle_tpu.parallel.multihost import HostComm
                comm = HostComm()
            slv = CartABFSolver(part, ctx, fine.bc_idx, fine.bc_vals,
                                jax.devices(), lame=lame,
                                dtype=jnp.float64, multihost=comm,
                                **cfg_common)
            mode = "cart"
        elif ir_flag:
            # mixed-precision iterative refinement: float32 inner ABF
            # solve on the accelerator, float64 true-residual outer loop
            # to rtol_true (the bench.py flagship path)
            slv = ABFSolver(
                mesh, fine.fes, fine.coeff_qp, fine.bc_idx, fine.bc_vals,
                lame=lame, dtype=jnp.float32, ir=True, **cfg_common)
            mode = "ir"
        else:
            slv = ABFSolver(
                mesh, fine.fes, fine.coeff_qp, fine.bc_idx, fine.bc_vals,
                lame=lame, dtype=jnp.float64, **cfg_common)
        fine.rhs_diri = slv.setup["rhs_diri"]
        monitor = (make_monitor_short(prefix, log=log)
                   if opts.get_bool("ksp_monitor_short", False,
                                    prefix=prefix) else None)
        reason_log = (log if opts.get_bool("ksp_converged_reason", False,
                                           prefix=prefix) else None)
        ksp = _JittedKSPShim(slv, monitor, reason_log, prefix, mode=mode,
                             rtol_true=rtol_true)

    # --- RHS (exSaddle.c:273-282) ---
    f1, f2 = assemble_rhs(fine.fes, fine.coeff_qp["Fu"], fine.coeff_qp["Fp"])
    F = scatter_vector(mesh, f1, f2)
    F[: mesh.nu][fine.bc_idx] = fine.bc_vals
    F = F + fine.rhs_diri
    F = jnp.asarray(F)

    # --- nullspace (exSaddle.c:288-301) ---
    nullvec = None
    if nullspace_flag:
        nullvec = np.zeros(mesh.ndof)
        nullvec[mesh.nu:] = -1.0 / np.sqrt(mesh.np_)

    stage_t["Setup"] = _time.perf_counter() - _t0
    _t0 = _time.perf_counter()

    # --- solver tree (host path) ---
    if not use_jitted:
        dm_info = {"nranks": nranks,
                   "overlap": opts.get_int("dmdafe_overlap", 0)}
        amat = _make_saddle_matshell(fine, lame, dm_info=dm_info)
        pc_forced = None
        pc_default = "ilu"
        if fs:
            pc_default = "fieldsplit"
        if mg:
            if opts.get_string("pc_type", None, prefix=prefix) is None:
                pc_forced = _build_saddle_mg(opts, prefix, levels, lame,
                                             fs_coarse, log=log,
                                             dm_info=dm_info)
            # else: options select the top PC (none of the reference
            # tests do)

        ksp = sc.make_ksp(opts, prefix, amat,
                          ksp_defaults=KSPConfig(type="gmres"),
                          pc_default=pc_default, pc_forced=pc_forced,
                          nullspace=nullvec, log=log)
    stage_t["SolverSetup"] = _time.perf_counter() - _t0
    _t0 = _time.perf_counter()
    result = ksp.solve(F)
    stage_t["KSPSolve"] = _time.perf_counter() - _t0
    X = result.x

    if opts.get_bool("ksp_view", False, prefix=prefix):
        from exsaddle_tpu.ksp_view import view_ksp
        view_ksp(ksp, log=log, nranks=nranks)

    if twosolves:
        _t0 = _time.perf_counter()
        _extra_solves(ksp, F, log=log)
        stage_t["Extra Solves"] = _time.perf_counter() - _t0

    # --- check solution (exSaddle.c:431-474) ---
    if check_solution:
        Xref = emodels.compute_reference_solution(ctx, mesh)
        if Xref is not None:
            Xref = jnp.asarray(Xref)
            if nullvec is not None:
                nv = jnp.asarray(nullvec)
                Xref = Xref - jnp.dot(nv, Xref) * nv
            err = Xref - X
            abs_err = float(jnp.linalg.norm(err))
            rel_err = abs_err / float(jnp.linalg.norm(Xref))
            log("---------------------")
            log("Error in solution:")
            log(f"  abs {abs_err:g}")
            log(f"  rel {rel_err:g}")
            log("---------------------")
            erru = err[: mesh.nu]
            abs_erru = float(jnp.linalg.norm(erru))
            rel_erru = abs_erru / float(jnp.linalg.norm(Xref[: mesh.nu]))
            log("---------------------")
            log("Error in velocity solution:")
            log(f"  abs {abs_erru:g}")
            log(f"  rel {rel_erru:g}")
            log("---------------------")
        else:
            log("Warning: -check_solution supplied but no reference "
                "solution available")

    if diagnostics:
        esio.report_solution_diagnostics(mesh, X, log=log)
    if view_fields:
        esio.view_fields(mesh, X, log=log)
        if check_solution:
            Xr = emodels.compute_reference_solution(ctx, mesh)
            if Xr is not None:
                esio.view_fields(mesh, Xr, tag="ref_", log=log)
    if dump_solution:
        esio.dump_solution(X, "solution.npy", log=log)
    if dump_operator:
        for k, lv in enumerate(levels):
            esio.dump_operator(lv.op.to_csr(), f"operator_{k}.npz", log=log)
    if dump_pc:
        # explicit preconditioner M^-1 (DumpPreconditioner,
        # exSaddle_io.c:91-104)
        esio.dump_dense_operator(ksp.pc.apply, mesh.ndof,
                                 "preconditioner.npz", log=log)
    if dump_pc_op:
        # explicit M^-1 A (DumpPreconditionedOperator, exSaddle_io.c:106-126)
        esio.dump_dense_operator(lambda v: ksp.pc.apply(amat.apply(v)),
                                 mesh.ndof,
                                 "preconditioned_operator_out.npz", log=log)
    if dump_smoother:
        from exsaddle_tpu import precond_mg
        if not isinstance(ksp.pc, precond_mg.PCMG):
            raise ValueError("Smoother dump requires PC type PCMG")
        for k, lvl in enumerate(ksp.pc.levels):
            sm = lvl.smoother
            esio.dump_dense_operator(
                lambda v, s=sm: s.solve(v).x,
                levels[k + 1].mesh.ndof, f"smoother_{k + 1}.npz", log=log)
    if dump_mpscaled:
        esio.dump_operator(amat.Sp.csr(), "mpscaled.npz", log=log)

    if log_view:
        # lightweight -log_view: per-stage wall-clock summary (the
        # PetscLogStagePush/Pop separation of exSaddle.c:594-599)
        total = sum(stage_t.values())
        log("-" * 62)
        log("Stage summary (wall clock):")
        for name, t in stage_t.items():
            frac = 100.0 * t / total if total > 0 else 0.0
            log(f"  {name:<16s} {t:12.4e} s  {frac:5.1f}%")
        log(f"  {'Total':<16s} {total:12.4e} s")
        log("-" * 62)

    if opts.get_bool("options_left", False):
        log(opts.format_table().rstrip("\n"))

    return {"X": X, "result": result, "mesh": mesh, "levels": levels,
            "ksp": ksp, "F": F, "stages": stage_t}


def _build_saddle_mg(opts, prefix, levels, lame, fs_coarse, log=print,
                     dm_info=None):
    """Programmatic monolithic saddle PCMG with per-level re-assembled
    operators (PC_MG_GALERKIN_NONE) and composite interpolation
    (exSaddle.c:333-402)."""
    nlv = len(levels)
    mats = [_make_saddle_matshell(
        lv, lame, dm_info=dm_info,
        names=(("Asaddle", "Mpscaled") if k == nlv - 1
               else (None, "Mpscaled_coarse" if k == 0 else None)))
            for k, lv in enumerate(levels)]
    prolongs = []
    for k in range(len(levels) - 1):
        Pu = Prolongation(levels[k].mesh.nn_u, levels[k + 1].mesh.nn_u,
                          dof=levels[k].mesh.ndim)
        Pp = Prolongation(levels[k].mesh.nn_p, levels[k + 1].mesh.nn_p, dof=1)
        prolongs.append(BlockDiagProlongation(Pu, Pp))

    coarse_pc_forced = None
    if fs_coarse:
        coarse_pc_forced = sc.make_fieldsplit(
            opts, prefix + "mg_coarse_", mats[0], log=log)
    return sc.build_mg(opts, prefix, mats, prolongs,
                       coarse_pc_forced=coarse_pc_forced, log=log)


def _extra_solves(ksp, F, log=print):
    """-twosolves (exSaddle.c:569-618): re-solve with monitoring cancelled in
    a fresh stage."""
    from exsaddle_tpu.krylov import Reason
    num_extra = 1
    saved_monitor = ksp.cfg.monitor
    saved_reason = ksp.cfg.converged_reason_log
    ksp.cfg.monitor = None
    ksp.cfg.converged_reason_log = None
    log("")
    log("-" * 78)
    log(f"  Commencing with {num_extra} additional solves. This will cancel"
        " a KSP monitor set on\n   saddle_, but no nested output. You should"
        " ensure that there is no output between\n   this output and the"
        " output which indicates the extra solves are completed. That\n   "
        "is, you should not use any ksp_view, ksp_converged_reason, or "
        "nested ksp_monitor\n   options if you want the results in this "
        "test to be meaningful.")
    log("-" * 77)
    res = None
    for _ in range(num_extra):
        res = ksp.solve(F)
    if Reason.is_converged(res.reason):
        log("")
        log("-" * 78)
        log(f"  {num_extra} extra solve(s) succeeded with {res.its} "
            f"iterations and residual norm {res.rnorm:1.6e} ")
        log("-" * 77)
    else:
        log("")
        log("-" * 78)
        log("\n ERROR: EXTRA SOLVES(S) DIVERGED!")
        log("-" * 78)
    ksp.cfg.monitor = saved_monitor
    ksp.cfg.converged_reason_log = saved_reason
    return res


def main(argv=None, ndim=2, lame=False):
    """CLI entry point (exSaddle{2d,3d}[_lame] equivalents)."""
    import sys
    args = sys.argv[1:] if argv is None else argv
    opts = Options.from_args(args)
    jax.config.update("jax_enable_x64", True)
    from exsaddle_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()
    saddle_solve(opts, ndim, lame=lame)


if __name__ == "__main__":
    # `python -m exsaddle_tpu.driver ...`: one module stands in for the
    # reference's four compiled executables (Makefile:43-48); the
    # compile-time -DNSD/-DLAME matrix becomes the -ndim/-lame flags
    import sys as _sys
    _args = _sys.argv[1:]
    _ndim, _lame, _rest = 3, False, []
    _i = 0
    while _i < len(_args):
        if _args[_i] == "-ndim":
            _ndim = int(_args[_i + 1])
            _i += 2
        elif _args[_i] == "-lame":
            _lame = True
            _i += 1
        else:
            _rest.append(_args[_i])
            _i += 1
    main(_rest, ndim=_ndim, lame=_lame)
