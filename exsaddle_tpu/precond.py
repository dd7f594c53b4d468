"""Preconditioners with reference-matching semantics.

Capability parity with the PETSc PC subset the reference exercises
(SURVEY.md section 2.2): Jacobi, ILU(0), LU, block-Jacobi, fieldsplit with
Schur complement (UPPER factorization + user-provided Schur preconditioning
matrix), and geometric multigrid (precond_mg.py).

Setup (factorizations) runs host-side in numpy/scipy like PETSc's setup
phase; applies are jnp ops so they participate in the device compute path.
Factors of small systems are stored dense (triangular solves as dense
matrix products); a level-scheduled sparse path can replace this for large
blocks.

Design decision -- which PCs get fully-jitted device paths: the
production device solver is the ABF stack (abf.py / treeops.py /
parallel/*): Jacobi, Chebyshev, Galerkin MG, fieldsplit-Schur and the
replicated coarse all run inside one jitted while_loop, because their
applies are dense batched ops that suit a throughput accelerator.
PCBJacobi / PCASM / PCILDL applies are host-orchestrated BY DESIGN: their
kernels are sequential triangular solves over large sparse blocks
(ILU(0)/LDL^T pointer chasing) with little parallelism per step -- the
accelerator answer to "I want a strong cheap smoother" is the
Chebyshev/MG composition above, not a ported incomplete factorization
(whether a device realization pays is ROADMAP item R6). These PCs exist for regression parity with the
reference's configurations and run at host speed on host-sized cases.
"""

import numpy as np
import jax.numpy as jnp
import jax.scipy.linalg as jsla


class PCNone:
    def apply(self, x):
        return x


class PCJacobi:
    """PCJACOBI: y = x / diag(A); zero diagonal entries replaced by 1.0
    (PCSetUp_Jacobi's zero-pivot guard)."""

    def __init__(self, diag):
        d = jnp.asarray(diag)
        d = jnp.where(d == 0.0, 1.0, d)
        self.inv_diag = 1.0 / d

    def apply(self, x):
        return self.inv_diag * x


class PCILU:
    """PCILU: ILU(0), natural ordering (PETSc PCILU defaults: 0 levels of
    fill, no shifts). Factorization and triangular solves run in native
    C++ on the original CSR pattern (exsaddle_tpu/native/ilu0.cpp) --
    setup cost O(nnz * row-width), no dense blowup."""

    def __init__(self, A_csr):
        from exsaddle_tpu.native import ILU0Factor
        self.fact = ILU0Factor(A_csr)
        self.n = self.fact.n

    def apply(self, x):
        return jnp.asarray(self.fact.solve(np.asarray(x)))


class PCLU:
    """PCLU: exact (dense) LU with partial pivoting -- the stable direct
    solve standing in for UMFPACK (Makefile:176-178 notes PETSc's sparse LU
    is unstable for these saddle systems; dense LAPACK pivoting is)."""

    def __init__(self, A_dense):
        self.lu, self.piv = jsla.lu_factor(jnp.asarray(A_dense))

    def apply(self, x):
        return jsla.lu_solve((self.lu, self.piv), x)


class PCBJacobi:
    """PCBJACOBI with per-block sub-KSPs over arbitrary dof index blocks.
    Serial: one block over the whole space (sub default preonly+ILU(0),
    matching testref/exSaddle3d_pseudoice_1.ref's bjacobi section).
    Parallel emulation: one block per virtual rank, blocks = the DMDA
    ownership dof sets (decomp.bjacobi_block_ranges)."""

    def __init__(self, n, sub_solvers, blocks):
        self.n = n
        self.subs = sub_solvers
        self.blocks = blocks

    def apply(self, x):
        xnp = np.asarray(x)
        y = np.empty_like(xnp)
        for ksp, idx in zip(self.subs, self.blocks):
            y[idx] = np.asarray(ksp.solve(jnp.asarray(xnp[idx])).x)
        return jnp.asarray(y)


class PCKSP:
    """Adapter: use a KSP solve as a PC apply (used for fieldsplit splits
    and MG coarse solves)."""

    def __init__(self, ksp):
        self.ksp = ksp

    def apply(self, x):
        return self.ksp.solve(x).x


class SchurComplementApply:
    """MatSchurComplement: y = A11 x - A10 inv(A00) A01 x with inv(A00)
    applied by the fieldsplit's A00 KSP (fieldsplit.c Schur setup; view:
    'KSP of A00')."""

    def __init__(self, mult_p, mult_up, mult_pu, ksp_A00):
        self.mult_p = mult_p      # xp -> A11 xp
        self.mult_up = mult_up    # xp -> A01 xp (into u space)
        self.mult_pu = mult_pu    # xu -> A10 xu (into p space)
        self.ksp_A00 = ksp_A00

    def __call__(self, xp):
        t = self.mult_up(xp)
        w = self.ksp_A00.solve(t).x
        return self.mult_p(xp) - self.mult_pu(w)


class PCFieldSplitSchurUpper:
    """PCFIELDSPLIT, PC_COMPOSITE_SCHUR, PC_FIELDSPLIT_SCHUR_FACT_UPPER
    (exSaddle.c:313-318):

        y_p = kspschur^-1 b_p
        y_u = kspA^-1 (b_u - A01 y_p)

    kspschur has the true Schur complement as operator and a preconditioner
    built from the user matrix Mpscaled (PC_FIELDSPLIT_SCHUR_PRE_USER)."""

    def __init__(self, nu, ksp_A00, ksp_schur, mult_up):
        self.nu = nu
        self.ksp_A00 = ksp_A00
        self.ksp_schur = ksp_schur
        self.mult_up = mult_up

    def apply(self, x):
        bu = x[: self.nu]
        bp = x[self.nu:]
        yp = self.ksp_schur.solve(bp).x
        yu = self.ksp_A00.solve(bu - self.mult_up(yp)).x
        return jnp.concatenate([yu, yp])


class PCASM:
    """PCASM (type RESTRICT, the PETSc default) with DM-defined
    element-aligned overlapping patches (DMCreateDomainDecomposition_
    DMDAFEQ2Q1, femixedspace.c:746-837): restrict the residual to each
    overlapping patch, sub-solve, but add the correction back only on the
    rank's OWNED dofs (disjoint partition) -- validated digit-exact against
    testref/exSaddle2d_asm_1.ref.

    Patch solves are delegated to per-patch sub-KSPs (preonly+LU in every
    reference configuration, Makefile:298,411,418)."""

    def __init__(self, n, subksps, patches, restrict_masks):
        self.n = n
        self.subksps = subksps
        self.patches = patches
        self.restrict_masks = restrict_masks

    def apply(self, x):
        xnp = np.asarray(x)
        y = np.zeros_like(xnp)
        for ksp, idx, m in zip(self.subksps, self.patches,
                               self.restrict_masks):
            res = ksp.solve(jnp.asarray(xnp[idx]))
            y[idx[m]] += np.asarray(res.x)[m]
        return jnp.asarray(y)


def _ildl_prepare(A_csr, ordering, matching):
    """Shared ILDL/ILUPACK preprocessing mirroring ILUPACK's pipeline
    (pcildl.c:147-193): MC64 maximum-product matching SCALING (symmetrized
    sqrt(sr*sc), native/order.cpp) when matching is on, then a
    fill-reducing symmetric ordering of the scaled matrix:

      metisn / metise -> native nested dissection (METIS_NodeND class)
      amd             -> native Approximate Minimum Degree
      rcm             -> reverse Cuthill-McKee
      natural         -> identity

    Returns (perm, iperm, scale, upper_csr) with upper_csr the permuted
    scaled upper triangle."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    from exsaddle_tpu.native import amd_order, nd_order, mc64_scaling

    A = A_csr.tocsr()
    n = A.shape[0]
    if matching:
        sr, sc, _ = mc64_scaling(A)
        scale0 = np.sqrt(sr * sc)
    else:
        scale0 = np.ones(n)
    # scale in place so explicit zeros keep the stored pattern (the nz
    # count reported must match the reference's preallocated pattern)
    As = A.copy().sorted_indices()
    rows = np.repeat(np.arange(n), np.diff(As.indptr))
    As.data = As.data * scale0[rows] * scale0[As.indices]

    if ordering in ("metisn", "metise"):
        perm = np.asarray(nd_order(As))
    elif ordering == "amd":
        perm = np.asarray(amd_order(As))
    elif ordering == "rcm":
        perm = np.asarray(reverse_cuthill_mckee(As, True))
    else:                       # natural
        perm = np.arange(n)
    iperm = np.empty(n, dtype=np.int64)
    iperm[perm] = np.arange(n)
    Ps = As[perm][:, perm].tocsr().sorted_indices()
    Pu = sp.triu(Ps).tocsr()
    return perm, iperm, scale0[perm], Pu


class PCILDL:
    """PCILDL: incomplete LDL^T with drop tolerance -- the equivalent of
    the reference's ILUPACK-backed custom PC (pcildl.c:46-372: upper-CSR
    extraction, matching+ordering, DSYMiluc factorization, pilucsol
    triangular solves). The factorization runs in native C++
    (exsaddle_tpu/native/ildl.cpp): Crout LDL^T with inverse-based
    (growth-monitored) dropping, and -- standing in for DSYMiluc's internal
    delayed/blocked pivoting -- deferral of unstable pivots to a small
    Schur complement that is factored exactly.

    Orderings (all native, distinct implementations -- order.cpp):
    amd (Approximate Minimum Degree, the default here: reproduces the
    reference's 7-iteration exSaddle3d_ildl_1 behavior), metisn/metise
    (nested dissection via recursive level-set bisection; our separators
    are not METIS-quality, hence not the default), rcm, natural.
    matching applies MC64 maximum-product symmetrized scalings
    (native/order.cpp shortest-augmenting-path matching, the job=5
    semantics of pcildl.c:147-193). Prints the relative fill line in the
    reference's format (pcildl.c:267)."""

    def __init__(self, A_csr, droptol=1e-2, ordering="amd",
                 matching=True, log=print):
        from exsaddle_tpu.native import MultilevelILDLFactor

        n = A_csr.shape[0]
        self.perm, self.iperm, self.scale, Pu = _ildl_prepare(
            A_csr, ordering, matching)
        self.fact = MultilevelILDLFactor(
            Pu, droptol, condest=20.0, drop_cap=5.0,
            droptolS=max(droptol * 1e-2, 1e-14),
            nmin=max(500, n // 30))
        nzA = Pu.nnz
        log(f"relative fill ILDL/A: {self.fact.nnz / nzA:8.1e} "
            f"(wrt {nzA} nz)")

    def apply(self, x):
        xnp = np.asarray(x)
        y = self.scale * self.fact.solve(self.scale * xnp[self.perm])
        return jnp.asarray(y[self.iperm])


class PCILUPACK:
    """PCILUPACK: multilevel ILU (ILUPACK AMGfactor/AMGsol,
    pcilupack.c:29-245): condest-driven pivot rejection builds a genuine
    multilevel factorization -- each level eliminates the pivots whose
    inverse growth stays under the condest bound, the rejected unknowns
    form an approximate Schur complement (drop tolerance droptolS) that
    becomes the next level (exsaddle_tpu/native/ildl.cpp)."""

    def __init__(self, A_csr, droptol=1e-2, condest=100.0, droptolS=None,
                 log=print):
        from exsaddle_tpu.native import MultilevelILDLFactor

        self.droptol = droptol
        self.condest = condest
        self.droptolS = droptolS if droptolS is not None else droptol
        self.perm, self.iperm, self.scale, Pu = _ildl_prepare(
            A_csr, "metisn", True)
        self.fact = MultilevelILDLFactor(
            Pu, droptol, condest=condest, drop_cap=5.0,
            droptolS=droptolS if droptolS is not None else droptol)
        # banner in the reference's format (pcilupack.c AMGfactor report).
        # The elbow factor is the MEASURED memory held by the multilevel
        # preconditioner relative to the input matrix's CSR memory --
        # ILUPACK's own used-elbow semantics (pcilupack.c:169 prints
        # param.elbow as updated by AMGfactor, + its 0.005 rounding nudge)
        log(f"factorization successful with {self.fact.nlevels} levels "
            "completed")
        a_bytes = (Pu.data.nbytes + Pu.indices.nbytes + Pu.indptr.nbytes)
        elbow = self.fact.storage_bytes() / max(a_bytes, 1) + 0.005
        log(f"final elbow space factor={elbow:8.2f}")

    def apply(self, x):
        xnp = np.asarray(x)
        y = self.scale * self.fact.solve(self.scale * xnp[self.perm])
        return jnp.asarray(y[self.iperm])


class PCFieldSplitAdditive:
    """PCFIELDSPLIT, PC_COMPOSITE_ADDITIVE (the PETSc default used by
    ex42mod's field-based split, ex42mod.c:1561-1567):
    y = R_u^T ksp_u(x_u) + R_p^T ksp_p(x_p)."""

    def __init__(self, n, splits):
        self.n = n
        self.splits = splits        # list of (index_array, ksp)

    def apply(self, x):
        xnp = np.asarray(x)
        y = np.zeros_like(xnp)
        for idx, ksp in self.splits:
            y[idx] = np.asarray(ksp.solve(jnp.asarray(xnp[idx])).x)
        return jnp.asarray(y)
