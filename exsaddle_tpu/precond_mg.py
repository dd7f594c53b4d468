"""Geometric multigrid: structured prolongation/restriction + PCMG V-cycle.

Capability parity with the reference's two MG configurations:
  - monolithic saddle PCMG with per-level *re-assembled* operators
    (PC_MG_GALERKIN_NONE) and DMComposite interpolation = blockdiag of the
    Q2-velocity and Q1-pressure multilinear interpolations
    (exSaddle.c:333-402);
  - Galerkin MG inside the velocity block of the ABF fieldsplit
    (-saddle_fieldsplit_u_pc_mg_galerkin, abf.opts:13) with RAP coarse
    operators.

Interpolation between structured node grids is multilinear (DMDA's default
Q1 interpolation), expressed as a structured gather-with-weights so it runs
on an accelerator as dense vector ops; restriction is the exact transpose
(segment-sum scatter)."""

import numpy as np
import jax.numpy as jnp
from jax import lax


class Prolongation:
    """Multilinear interpolation between structured node grids.

    coarse_nn/fine_nn: node counts per dimension (x fastest linearization).
    dof: dofs per node (interleaved).
    Equivalent to DMDA's DMCreateInterpolation for uniform coordinates."""

    def __init__(self, coarse_nn, fine_nn, dof=1):
        ndim = len(coarse_nn)
        self.dof = dof
        self.coarse_n = int(np.prod(coarse_nn)) * dof
        self.fine_n = int(np.prod(fine_nn)) * dof

        # per-dimension: fine index -> (base coarse index, weight of base+1)
        base_1d, w_1d = [], []
        for d in range(ndim):
            nc, nf = coarse_nn[d], fine_nn[d]
            # fine node at parametric coarse coordinate t in [0, nc-1]
            t = np.arange(nf) * (nc - 1) / (nf - 1)
            b = np.floor(t + 1e-12).astype(np.int64)
            b = np.minimum(b, nc - 2) if nc > 1 else b * 0
            w = t - b
            base_1d.append(b)
            w_1d.append(w)

        # tensor-product stencil: 2^ndim coarse nodes per fine node
        fine_grid = np.indices(tuple(fine_nn[::-1])).reshape(ndim, -1)[::-1]
        # fine_grid[d] is the d-coordinate of each fine node, x fastest
        nfine_nodes = fine_grid.shape[1]
        ncorners = 2 ** ndim
        cidx = np.zeros((nfine_nodes, ncorners), dtype=np.int64)
        wts = np.ones((nfine_nodes, ncorners))
        for corner in range(ncorners):
            coord = np.zeros((ndim, nfine_nodes), dtype=np.int64)
            w = np.ones(nfine_nodes)
            for d in range(ndim):
                bit = (corner >> d) & 1
                fb = base_1d[d][fine_grid[d]]
                fw = w_1d[d][fine_grid[d]]
                coord[d] = np.minimum(fb + bit, coarse_nn[d] - 1)
                w = w * (fw if bit else (1.0 - fw))
            lin = coord[0]
            mult = coarse_nn[0]
            for d in range(1, ndim):
                lin = lin + coord[d] * mult
                mult *= coarse_nn[d]
            cidx[:, corner] = lin
            wts[:, corner] = w

        if dof > 1:
            # expand to interleaved dofs
            cidx = (dof * cidx[:, None, :]
                    + np.arange(dof)[None, :, None]).reshape(-1, ncorners)
            wts = np.repeat(wts, dof, axis=0)
        self.cidx = jnp.asarray(cidx)
        self.wts = jnp.asarray(wts)

    def apply(self, xc):
        """x_fine = P x_coarse."""
        return jnp.sum(xc[self.cidx] * self.wts, axis=1)

    def restrict(self, rf):
        """r_coarse = P^T r_fine (MatRestrict)."""
        contrib = rf[:, None] * self.wts
        return jnp.zeros(self.coarse_n, rf.dtype).at[self.cidx.ravel()].add(
            contrib.ravel())

    def restriction_scale(self):
        """DMCreateInterpolationScale: 1 / (P^T ones)."""
        ones = jnp.ones(self.fine_n)
        return 1.0 / self.restrict(ones)

    def to_scipy(self):
        """CSR form of P for setup-phase Galerkin RAP products."""
        import scipy.sparse as sp
        cidx = np.asarray(self.cidx)
        wts = np.asarray(self.wts)
        rows = np.repeat(np.arange(self.fine_n), cidx.shape[1])
        P = sp.coo_matrix((wts.ravel(), (rows, cidx.ravel())),
                          shape=(self.fine_n, self.coarse_n)).tocsr()
        P.sum_duplicates()
        return P


class BlockDiagProlongation:
    """DMComposite interpolation: blockdiag(P_u, P_p) on [u | p] vectors
    (exSaddle.c:348 via DMCreateInterpolation on the composite)."""

    def __init__(self, P_u, P_p):
        self.P_u = P_u
        self.P_p = P_p
        self.fine_nu = P_u.fine_n
        self.coarse_nu = P_u.coarse_n
        self.fine_n = P_u.fine_n + P_p.fine_n
        self.coarse_n = P_u.coarse_n + P_p.coarse_n

    def apply(self, xc):
        return jnp.concatenate([self.P_u.apply(xc[: self.coarse_nu]),
                                self.P_p.apply(xc[self.coarse_nu:])])

    def restrict(self, rf):
        return jnp.concatenate([self.P_u.restrict(rf[: self.fine_nu]),
                                self.P_p.restrict(rf[self.fine_nu:])])


class MGLevel:
    """One PCMG level: smoother KSP (pre==post, nonzero initial guess on the
    post sweep), operator apply, prolongation from the next-coarser level."""

    def __init__(self, apply_A, smoother, prolong):
        self.A = apply_A
        self.smoother = smoother
        self.P = prolong


class PCMG:
    """PCMG multiplicative V-cycle, 1 cycle per application (the reference's
    configuration; testref view: 'type is MULTIPLICATIVE, levels=N cycles=v,
    Cycles per PCApply=1')."""

    def __init__(self, levels, coarse_ksp):
        self.levels = levels      # levels[1..] from coarsest+1 to finest
        self.coarse_ksp = coarse_ksp
        self.nlevels = len(levels) + 1

    def apply(self, b):
        return self._cycle(self.nlevels - 1, b)

    def _cycle(self, k, b):
        if k == 0:
            return self.coarse_ksp.solve(b).x
        lv = self.levels[k - 1]
        x = lv.smoother.solve(b).x                 # pre-smooth from zero
        r = b - lv.A(x)
        xc = self._cycle(k - 1, lv.P.restrict(r))
        x = x + lv.P.apply(xc)
        return lv.smoother.solve(b, x0=x).x        # post-smooth, x warm


def galerkin_coarse_operators(A_fine_csr, prolongations, dof=1):
    """Compute the Galerkin hierarchy A_k = P_k^T A_{k+1} P_k (PCMG Galerkin,
    abf.opts:13). prolongations: list from coarsest->fine transfer, i.e.
    prolongations[k] maps level k to level k+1. Returns list of CSR coarse
    operators [A_0 ... A_{nlev-2}].

    dof > 1 inflates each coarse pattern to full dof x dof node blocks
    (explicit zeros), matching PETSc's MatPtAP result for a bs=dof
    interpolation (the reference's coarse operators report e.g.
    nonzeros=9000 = 9 * node-pairs, testref/exSaddle3d_pseudoice_1.ref)."""
    import scipy.sparse as sp
    ops = [None] * len(prolongations)
    A = A_fine_csr
    for k in range(len(prolongations) - 1, -1, -1):
        P = prolongations[k].to_scipy()
        A = (P.T @ (A @ P)).tocsr()
        A.sum_duplicates()
        if dof > 1:
            # inflate to the node-block pattern with EXPLICIT zeros (scipy
            # arithmetic would prune them): values of A scattered into the
            # block-union structure
            C = A.tocoo()
            nb = A.shape[0] // dof
            blk = sp.coo_matrix(
                (np.ones_like(C.data), (C.row // dof, C.col // dof)),
                shape=(nb, nb)).tocsr()
            blk.sum_duplicates()
            blk.data[:] = 1.0
            pat = sp.kron(blk, np.ones((dof, dof)), format="csr")
            pat.sort_indices()
            data = np.zeros(pat.nnz)
            Ac = A.tocsr().sorted_indices()
            rows = np.repeat(np.arange(A.shape[0]), np.diff(Ac.indptr))
            # locate each A entry inside pat's (superset) row structure
            row_start = pat.indptr[rows]
            row_end = pat.indptr[rows + 1]
            # per-entry binary search within its row slice
            pos = np.empty(Ac.nnz, dtype=np.int64)
            for r in range(A.shape[0]):
                a0, a1 = Ac.indptr[r], Ac.indptr[r + 1]
                p0, p1 = pat.indptr[r], pat.indptr[r + 1]
                pos[a0:a1] = p0 + np.searchsorted(
                    pat.indices[p0:p1], Ac.indices[a0:a1])
            data[pos] = Ac.data
            A = sp.csr_matrix((data, pat.indices, pat.indptr),
                              shape=A.shape)
        ops[k] = A
    return ops


def csr_apply(A_csr, max_dense=4096):
    """Return a jnp-compatible matvec closure for a scipy CSR operator:
    dense below max_dense rows (one matrix-vector product at full
    precision: a float32 product must not drop to TF32 on the GPU),
    padded-row ELL gather above.

    ELL keeps the apply as a static-shape gather + row-sum -- a
    regular-shape form for these bounded-stencil matrices (every row of a
    Q2/Q1 grid operator has <= a few hundred entries); no
    jax.experimental.sparse in any hot path."""
    n = A_csr.shape[0]
    if n <= max_dense:
        Ad = jnp.asarray(A_csr.toarray())
        return lambda x: jnp.matmul(Ad, x, precision=lax.Precision.HIGHEST)
    A = A_csr.tocsr().sorted_indices()
    counts = np.diff(A.indptr)
    k = int(counts.max())
    cols = np.zeros((n, k), dtype=np.int32)
    vals = np.zeros((n, k))
    rows = np.repeat(np.arange(n), counts)
    slot = np.arange(A.nnz) - np.repeat(A.indptr[:-1], counts)
    cols[rows, slot] = A.indices
    vals[rows, slot] = A.data
    colsj = jnp.asarray(cols)
    valsj = jnp.asarray(vals)
    return lambda x: jnp.sum(valsj * x[colsj], axis=1)
