"""Element-batched saddle-point operator with symmetric Dirichlet elimination.

The JAX replacement for PETSc's assembled AIJ matrix + MatMult +
MatZeroRowsColumns (femixedspace.c:2350-2645, SURVEY.md section 2.2): the
operator is stored as per-element dense blocks; y = A x is

    gather x -> batched (nel, ndof_el, ndof_el) matmuls -> segment-sum

Dirichlet elimination (MatZeroRowsColumns with diag=1.0) is applied to the
element blocks at setup: rows+columns of constrained dofs are zeroed in every
element block and an identity contribution is added at apply time. The
non-zero-Dirichlet RHS correction rhs_diri = -A_raw x_bc (femixedspace.c:
2634-2643) is computed from the raw blocks before masking.

The same object exposes dense / CSR conversions for preconditioner setup
(LU coarse solves, ILU(0), block extraction).
"""

from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp


@partial(jax.tree_util.register_dataclass,
         data_fields=["A11", "A12", "A21", "A22", "u_el_dofs", "p_el_nodes",
                      "bc_mask"],
         meta_fields=["nu", "np_"])
@dataclass(frozen=True)
class SaddleOperator:
    """Masked element-block saddle operator.

    A11: (nel, nud, nud); A12: (nel, nud, npb); A21: (nel, npb, nud);
    A22: (nel, npb, npb) (zeros for Stokes).
    bc_mask: (ndof,) 1.0 at constrained dofs else 0.0 (pressure rows never
    constrained)."""
    A11: jnp.ndarray
    A12: jnp.ndarray
    A21: jnp.ndarray
    A22: jnp.ndarray
    u_el_dofs: jnp.ndarray
    p_el_nodes: jnp.ndarray
    bc_mask: jnp.ndarray
    nu: int
    np_: int

    @property
    def ndof(self):
        return self.nu + self.np_

    def mult(self, x):
        """y = A x (matrix-free element apply)."""
        xu = x[: self.nu]
        xp = x[self.nu:]
        xue = xu[self.u_el_dofs]                     # (nel, nud)
        xpe = xp[self.p_el_nodes]                    # (nel, npb)
        yue = (jnp.einsum("eij,ej->ei", self.A11, xue)
               + jnp.einsum("eij,ej->ei", self.A12, xpe))
        ype = (jnp.einsum("eij,ej->ei", self.A21, xue)
               + jnp.einsum("eij,ej->ei", self.A22, xpe))
        yu = jnp.zeros(self.nu, x.dtype).at[self.u_el_dofs.ravel()].add(
            yue.ravel())
        yp = jnp.zeros(self.np_, x.dtype).at[self.p_el_nodes.ravel()].add(
            ype.ravel())
        y = jnp.concatenate([yu, yp])
        return y + self.bc_mask * x                  # unit diagonal on BC rows

    # --- block applies (for PCFIELDSPLIT sub-solves; the blocks of the
    # BC-eliminated matrix, as PETSc's MatCreateSubMatrix would extract) ----
    def mult_u(self, xu):
        """A00 xu (velocity block, unit diagonal on BC rows)."""
        xue = xu[self.u_el_dofs]
        yue = jnp.einsum("eij,ej->ei", self.A11, xue)
        yu = jnp.zeros(self.nu, xu.dtype).at[self.u_el_dofs.ravel()].add(
            yue.ravel())
        return yu + self.bc_mask[: self.nu] * xu

    def mult_up(self, xp):
        """A01 xp (gradient block, BC rows zeroed)."""
        xpe = xp[self.p_el_nodes]
        yue = jnp.einsum("eij,ej->ei", self.A12, xpe)
        return jnp.zeros(self.nu, xp.dtype).at[self.u_el_dofs.ravel()].add(
            yue.ravel())

    def mult_pu(self, xu):
        """A10 xu (divergence block, BC columns zeroed)."""
        xue = xu[self.u_el_dofs]
        ype = jnp.einsum("eij,ej->ei", self.A21, xue)
        return jnp.zeros(self.np_, xu.dtype).at[self.p_el_nodes.ravel()].add(
            ype.ravel())

    def mult_p(self, xp):
        """A11 (pressure-pressure) block: zero for Stokes, -1/lambda mass for
        Lame."""
        xpe = xp[self.p_el_nodes]
        ype = jnp.einsum("eij,ej->ei", self.A22, xpe)
        return jnp.zeros(self.np_, xp.dtype).at[self.p_el_nodes.ravel()].add(
            ype.ravel())

    def diagonal(self):
        """Assembled matrix diagonal (for PCJACOBI)."""
        d11 = jnp.einsum("eii->ei", self.A11)
        d22 = jnp.einsum("eii->ei", self.A22)
        du = jnp.zeros(self.nu, d11.dtype).at[self.u_el_dofs.ravel()].add(
            d11.ravel())
        dp = jnp.zeros(self.np_, d22.dtype).at[self.p_el_nodes.ravel()].add(
            d22.ravel())
        return jnp.concatenate([du, dp]) + self.bc_mask

    # --- host-side conversions (setup path) -------------------------------
    def to_dense(self):
        """Assembled dense (ndof, ndof) numpy array (setup/debug only)."""
        n = self.ndof
        A = np.zeros((n, n))
        ue = np.asarray(self.u_el_dofs)
        pe = np.asarray(self.p_el_nodes) + self.nu
        A11 = np.asarray(self.A11)
        A12 = np.asarray(self.A12)
        A21 = np.asarray(self.A21)
        A22 = np.asarray(self.A22)
        for e in range(ue.shape[0]):
            A[np.ix_(ue[e], ue[e])] += A11[e]
            A[np.ix_(ue[e], pe[e])] += A12[e]
            A[np.ix_(pe[e], ue[e])] += A21[e]
            A[np.ix_(pe[e], pe[e])] += A22[e]
        A[np.arange(n), np.arange(n)] += np.asarray(self.bc_mask)
        return A

    def to_csr(self):
        """Assembled scipy CSR (setup path for ILU/orderings)."""
        import scipy.sparse as sp
        ue = np.asarray(self.u_el_dofs)
        pe = np.asarray(self.p_el_nodes) + self.nu
        nel, nud = ue.shape
        npb = pe.shape[1]
        rows = []
        cols = []
        vals = []

        def add(r, c, v):
            rows.append(np.broadcast_to(r[:, :, None], v.shape).ravel())
            cols.append(np.broadcast_to(c[:, None, :], v.shape).ravel())
            vals.append(v.ravel())

        add(ue, ue, np.asarray(self.A11))
        add(ue, pe, np.asarray(self.A12))
        add(pe, ue, np.asarray(self.A21))
        add(pe, pe, np.asarray(self.A22))
        n = self.ndof
        diag = np.asarray(self.bc_mask)
        rows.append(np.arange(n))
        cols.append(np.arange(n))
        vals.append(diag)
        A = sp.coo_matrix((np.concatenate(vals),
                           (np.concatenate(rows), np.concatenate(cols))),
                          shape=(n, n)).tocsr()
        A.sum_duplicates()
        return A


def apply_dirichlet_elimination(mesh, elmats, bc_idx, bc_vals,
                                device=True):
    """Build a masked SaddleOperator + rhs_diri from raw element matrices.

    Mirrors MatAssemble_Saddle's BC handling (femixedspace.c:2634-2645):
      rhs_diri = -(A_raw x_bc) with BC rows zeroed;
      A <- zero BC rows+cols, 1.0 on BC diagonal.

    device=False keeps the element batches as host numpy (the jitted ABF
    build only reads them host-side; transferring the (nel, 81, 81) f64
    batch through the device link cost ~12 s at mx=20). jax converts on
    demand if the operator's jitted mult is ever called.

    Returns (op, rhs_diri (ndof,), bc_mask (ndof,), x_bc (ndof,)).
    """
    nu, np_ = mesh.nu, mesh.np_
    bc_mask_u = np.zeros(nu)
    bc_mask_u[bc_idx] = 1.0
    x_bc_u = np.zeros(nu)
    x_bc_u[bc_idx] = bc_vals

    A11 = np.asarray(elmats["A11"])
    A12 = np.asarray(elmats["A12"])
    A22 = elmats["A22"]
    if A22 is None:
        A22 = np.zeros((mesh.nel, mesh.p_basis, mesh.p_basis))
    else:
        A22 = np.asarray(A22)
    A21 = np.transpose(A12, (0, 2, 1)).copy()

    # rhs_diri = -(A_raw x_bc); x_bc is zero at pressure dofs.
    xbe = x_bc_u[mesh.u_el_dofs]
    yue = np.einsum("eij,ej->ei", A11, xbe)
    ype = np.einsum("eij,ej->ei", A21, xbe)
    rhs = np.zeros(mesh.ndof)
    np.add.at(rhs, mesh.u_el_dofs.ravel(), yue.ravel())
    np.add.at(rhs[nu:], mesh.p_el_nodes.ravel(), ype.ravel())
    rhs = -rhs
    rhs[:nu][bc_idx] = 0.0   # zero BC rows of the correction

    # mask element blocks (in-place second factor: the chained broadcast
    # `A * k[:,:,None] * k[:,None,:]` materializes a second full-size
    # temporary with strided access -- measured 24x slower on the
    # (nel, 81, 81) batch)
    keep = 1.0 - bc_mask_u[mesh.u_el_dofs]          # (nel, nud)
    A11m = A11 * keep[:, :, None]
    A11m *= keep[:, None, :]
    A12m = A12 * keep[:, :, None]
    A21m = A21 * keep[:, None, :]

    bc_mask = np.concatenate([bc_mask_u, np.zeros(np_)])
    put = jnp.asarray if device else (lambda a: a)
    op = SaddleOperator(
        A11=put(A11m), A12=put(A12m),
        A21=put(A21m), A22=put(A22),
        u_el_dofs=put(mesh.u_el_dofs),
        p_el_nodes=put(mesh.p_el_nodes),
        bc_mask=put(bc_mask), nu=nu, np_=np_)
    x_bc = np.concatenate([x_bc_u, np.zeros(np_)])
    return op, rhs, bc_mask, x_bc


@partial(jax.tree_util.register_dataclass,
         data_fields=["S", "p_el_nodes"], meta_fields=["n"])
@dataclass(frozen=True)
class PressureOperator:
    """Element-block operator on the pressure (Q1) space -- the scaled mass
    matrix Mpscaled used as the user Schur preconditioner matrix
    (exSaddle.c:315-318)."""
    S: jnp.ndarray            # (nel, npb, npb)
    p_el_nodes: jnp.ndarray
    n: int

    def mult(self, x):
        xe = x[self.p_el_nodes]
        ye = jnp.einsum("eij,ej->ei", self.S, xe)
        return jnp.zeros(self.n, x.dtype).at[self.p_el_nodes.ravel()].add(
            ye.ravel())

    def diagonal(self):
        d = jnp.einsum("eii->ei", self.S)
        return jnp.zeros(self.n, d.dtype).at[self.p_el_nodes.ravel()].add(
            d.ravel())

    def to_csr(self):
        import scipy.sparse as sp
        pe = np.asarray(self.p_el_nodes)
        S = np.asarray(self.S)
        rows = np.broadcast_to(pe[:, :, None], S.shape).ravel()
        cols = np.broadcast_to(pe[:, None, :], S.shape).ravel()
        A = sp.coo_matrix((S.ravel(), (rows, cols)),
                          shape=(self.n, self.n)).tocsr()
        A.sum_duplicates()
        return A

    def to_dense(self):
        return self.to_csr().toarray()
