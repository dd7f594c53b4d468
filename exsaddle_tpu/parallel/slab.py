"""Slab domain decomposition over a device mesh: the distributed runtime.

The JAX replacement for the reference's DMDA rank decomposition +
VecScatter halo exchange + MPI_Allreduce reductions (SURVEY.md section 5,
femixedspace.c:1136-1363). Design:

  - 1D slab partition along the slowest grid axis (z in 3D, y in 2D),
    element-aligned like the reference's macro-element ownership rule
    (femixedspace.c:1102-1124): m_el[-1] must divide by the device count,
    mirroring the reference's divisibility errors.
  - Interface node planes are stored REDUNDANTLY on both neighbors (the
    DMDA ghosted-local-vector pattern): every device holds the full node
    planes of its elements, so the operator gather needs no communication.
  - After the local apply, partial sums on the two interface planes are
    exchanged with `lax.ppermute` (device-to-device neighbor traffic --
    the analogue of DMLocalToGlobal ADD_VALUES) and added; both copies then
    hold the full
    assembled value, keeping the redundant storage consistent.
  - Dot products / norms mask the lower interface plane on all but the
    first device and reduce with `lax.psum` (the MPI_Allreduce of every
    VecDot/VecNorm in the Krylov loop, SURVEY.md section 3.2).

Everything here runs inside `shard_map` over a 1D device mesh axis "z";
vectors are pytrees of per-shard grids with a leading device axis outside
the shard_map."""

from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from exsaddle_tpu.grid_ops import (_gather_q2, _scatter_q2, _gather_q1,
                                   _scatter_q1)

AXIS = "z"


@dataclass(frozen=True)
class SlabPartition:
    """Host-side slab layout for a SaddleMesh over ndev devices."""
    mesh: object
    ndev: int

    def __post_init__(self):
        m_last = self.mesh.m_el[-1]
        if m_last % self.ndev:
            raise ValueError(
                f"element count {m_last} along the slab axis is not "
                f"divisible by {self.ndev} devices (macro-element "
                "alignment, femixedspace.c:1102-1124)")

    @property
    def mloc(self):
        """Elements per device along the slab axis."""
        return self.mesh.m_el[-1] // self.ndev

    @property
    def m_el_loc(self):
        return tuple(self.mesh.m_el[:-1]) + (self.mloc,)

    @property
    def nn_u_loc(self):
        return tuple(self.mesh.nn_u[:-1]) + (2 * self.mloc + 1,)

    @property
    def nn_p_loc(self):
        return tuple(self.mesh.nn_p[:-1]) + (self.mloc + 1,)

    @property
    def nel_loc(self):
        return int(np.prod(self.m_el_loc))

    # --- global <-> sharded conversions (host/setup path) -----------------
    def shard_vector(self, x):
        """Global (ndof,) -> dict of stacked shard grids
        u: (ndev, nzl_u, ..., d), p: (ndev, nzl_p, ...)."""
        mesh = self.mesh
        nd = mesh.ndim
        x = np.asarray(x)
        xu = x[: mesh.nu].reshape(tuple(reversed(mesh.nn_u)) + (nd,))
        xp = x[mesh.nu:].reshape(tuple(reversed(mesh.nn_p)))
        us, ps = [], []
        for d in range(self.ndev):
            z0u = 2 * d * self.mloc
            us.append(xu[z0u:z0u + 2 * self.mloc + 1])
            z0p = d * self.mloc
            ps.append(xp[z0p:z0p + self.mloc + 1])
        return {"u": np.stack(us), "p": np.stack(ps)}

    def unshard_vector(self, sh):
        """Inverse of shard_vector (interface planes taken from the lower
        owner; both copies are identical for consistent vectors)."""
        mesh = self.mesh
        nd = mesh.ndim
        u = np.asarray(sh["u"])
        p = np.asarray(sh["p"])
        xu = np.zeros(tuple(reversed(mesh.nn_u)) + (nd,))
        xp = np.zeros(tuple(reversed(mesh.nn_p)))
        for d in range(self.ndev):
            z0u = 2 * d * self.mloc
            xu[z0u:z0u + 2 * self.mloc + 1] = u[d]
            z0p = d * self.mloc
            xp[z0p:z0p + self.mloc + 1] = p[d]
        return np.concatenate([xu.reshape(-1), xp.reshape(-1)])

    def shard_elements(self, a):
        """(nel, ...) element array -> (ndev, nel_loc, ...). Elements are
        ordered x-fastest, slab axis slowest, so slabs are contiguous."""
        a = np.asarray(a)
        return a.reshape((self.ndev, self.nel_loc) + a.shape[1:])

    def device_put(self, dmesh, sh):
        """Place stacked shard arrays with the leading axis over `dmesh`."""
        spec = NamedSharding(dmesh, P(AXIS))
        return jax.tree.map(lambda a: jax.device_put(jnp.asarray(a), spec),
                            sh)


# --- per-shard kernels (run inside shard_map over axis AXIS) ---------------

def halo_add(grid):
    """Exchange-and-add interface-plane partial sums with both neighbors.
    grid: (nzl, ...) local node grid whose first/last plane are shared."""
    ndev = lax.axis_size(AXIS)
    if ndev == 1:
        return grid
    up = [(i, i + 1) for i in range(ndev - 1)]
    dn = [(i + 1, i) for i in range(ndev - 1)]
    from_left = lax.ppermute(grid[-1], AXIS, up)      # d-1's top partial
    from_right = lax.ppermute(grid[0], AXIS, dn)      # d+1's bottom partial
    grid = grid.at[0].add(from_left)
    return grid.at[-1].add(from_right)


def owned_mask_factor(nzl, dtype):
    """(nzl, 1, ..) weight: plane 0 counts only on device 0 (it is the
    redundant copy of the left neighbor's top plane elsewhere)."""
    idx = lax.axis_index(AXIS)
    w = jnp.ones((nzl,), dtype)
    return jnp.where((jnp.arange(nzl) == 0) & (idx > 0),
                     jnp.zeros((), dtype), w)


def dist_dot(a, b):
    """Global dot of two sharded vectors (dicts of local u/p grids)."""
    wu = owned_mask_factor(a["u"].shape[0], a["u"].dtype)
    wp = owned_mask_factor(a["p"].shape[0], a["p"].dtype)
    nd_u = a["u"].ndim
    s = (jnp.sum(a["u"] * b["u"] * wu.reshape((-1,) + (1,) * (nd_u - 1)))
         + jnp.sum(a["p"] * b["p"] * wp.reshape(
             (-1,) + (1,) * (a["p"].ndim - 1))))
    return lax.psum(s, AXIS)


def dist_norm(a):
    return jnp.sqrt(dist_dot(a, a))


@partial(jax.tree_util.register_dataclass,
         data_fields=["A11", "A12", "A21", "A22", "keep_u", "keep_p",
                      "mask_u", "mask_p"],
         meta_fields=["m_el_loc", "nn_u_loc", "nn_p_loc"])
@dataclass(frozen=True)
class SlabOperator:
    """Per-shard element blocks + BC masks (leading axis = device)."""
    A11: jnp.ndarray
    A12: jnp.ndarray
    A21: jnp.ndarray
    A22: jnp.ndarray
    keep_u: jnp.ndarray       # local u grid, 1-bc
    keep_p: jnp.ndarray
    mask_u: jnp.ndarray
    mask_p: jnp.ndarray
    m_el_loc: tuple
    nn_u_loc: tuple
    nn_p_loc: tuple

    @classmethod
    def build(cls, part, op, dtype=jnp.float64):
        """From a (BC-masked) element-batched SaddleOperator."""
        bc = np.asarray(op.bc_mask)
        sh_mask = part.shard_vector(bc)
        sh_keep = part.shard_vector(1.0 - bc)
        cast = lambda a: jnp.asarray(np.asarray(a), dtype)
        return cls(
            A11=cast(part.shard_elements(op.A11)),
            A12=cast(part.shard_elements(op.A12)),
            A21=cast(part.shard_elements(op.A21)),
            A22=cast(part.shard_elements(op.A22)),
            keep_u=cast(sh_keep["u"]), keep_p=cast(sh_keep["p"]),
            mask_u=cast(sh_mask["u"]), mask_p=cast(sh_mask["p"]),
            m_el_loc=part.m_el_loc, nn_u_loc=part.nn_u_loc,
            nn_p_loc=part.nn_p_loc)

    def mult_local(self, x):
        """Per-shard y = A x on local grids; call inside shard_map.
        x/result: {"u": (nzl_u, .., d), "p": (nzl_p, ..)} WITHOUT the
        device axis. Element blocks arrive with their device axis already
        sliced off by shard_map."""
        m_el = self.m_el_loc
        xe = _gather_q2(x["u"], m_el)
        pe = _gather_q1(x["p"], m_el)
        yue = (jnp.einsum("eij,ej->ei", self.A11, xe)
               + jnp.einsum("eij,ej->ei", self.A12, pe))
        ype = (jnp.einsum("eij,ej->ei", self.A21, xe)
               + jnp.einsum("eij,ej->ei", self.A22, pe))
        nd = len(m_el)
        yu = _scatter_q2(yue, m_el, self.nn_u_loc, nd)
        yp = _scatter_q1(ype, m_el, self.nn_p_loc)
        # interface-plane accumulation between neighbor devices
        yu = halo_add(yu)
        yp = halo_add(yp)
        return {"u": yu + self.mask_u * x["u"],
                "p": yp + self.mask_p * x["p"]}


def _squeeze_dev(t):
    """shard_map keeps the sharded leading axis with local size 1; strip it."""
    return jax.tree.map(lambda a: a[0], t)


def _unsqueeze_dev(t):
    return jax.tree.map(lambda a: a[None], t)


def make_dist_mult(dmesh):
    """jit-able distributed y = A x on stacked shard pytrees."""
    from jax import shard_map
    spec = P(AXIS)
    vec_specs = {"u": spec, "p": spec}

    def local(op, v):
        y = _squeeze_dev(op).mult_local(_squeeze_dev(v))
        return _unsqueeze_dev(y)

    @jax.jit
    def mult(op, x):
        f = shard_map(local, mesh=dmesh,
                      in_specs=(jax.tree.map(lambda _: spec, op), vec_specs),
                      out_specs=vec_specs)
        return f(op, x)

    return mult


def make_dist_fgmres(dmesh, k):
    """Fully-jitted distributed FGMRES(k) cycle with diagonal (Jacobi)
    preconditioning: solve(op, inv_diag, F, x0) -> (x, rnorm).

    The whole cycle -- applies, halo exchanges, Gram-Schmidt dot products
    (psum), norm checks -- is one traced computation over the device mesh:
    no host round-trips inside the cycle (SURVEY.md section 3.2 hot loop).
    inv_diag: sharded vector pytree (pass ones for the identity PC)."""
    from jax import shard_map
    spec = P(AXIS)
    vec_specs = {"u": spec, "p": spec}

    def cycle_local(op, inv_diag, F, x0):
        op = _squeeze_dev(op)
        inv_diag = _squeeze_dev(inv_diag)
        F = _squeeze_dev(F)
        x0 = _squeeze_dev(x0)

        def mult(v):
            return op.mult_local(v)

        def pc(v):
            return jax.tree.map(jnp.multiply, inv_diag, v)

        def axpy(a, x, y):
            return jax.tree.map(lambda u, v: a * u + v, x, y)

        r0 = jax.tree.map(jnp.subtract, F, mult(x0))
        beta = dist_norm(r0)
        safe = jnp.where(beta == 0.0, 1.0, beta)
        V = [jax.tree.map(lambda a: a / safe, r0)]
        Z = []
        H = jnp.zeros((k + 1, k), F["u"].dtype)
        for j in range(k):                     # static unroll (small k)
            z = pc(V[j])
            w = mult(z)
            hs = []
            for i in range(j + 1):
                hs.append(dist_dot(V[i], w))
            for i in range(j + 1):
                w = axpy(-hs[i], V[i], w)
            hj1 = dist_norm(w)
            H = H.at[: j + 1, j].set(jnp.stack(hs))
            H = H.at[j + 1, j].set(hj1)
            safe1 = jnp.where(hj1 == 0.0, 1.0, hj1)
            V.append(jax.tree.map(lambda a: a / safe1, w))
            Z.append(z)
        e1 = jnp.zeros(k + 1, F["u"].dtype).at[0].set(beta)
        y = jnp.linalg.lstsq(H, e1)[0]
        x = x0
        for j in range(k):
            x = axpy(y[j], Z[j], x)
        rnorm = dist_norm(jax.tree.map(jnp.subtract, F, mult(x)))
        return _unsqueeze_dev(x), rnorm

    @jax.jit
    def solve(op, inv_diag, F, x0):
        f = shard_map(
            cycle_local, mesh=dmesh,
            in_specs=(jax.tree.map(lambda _: spec, op), vec_specs,
                      vec_specs, vec_specs),
            out_specs=(vec_specs, P()))
        return f(op, inv_diag, F, x0)

    return solve
