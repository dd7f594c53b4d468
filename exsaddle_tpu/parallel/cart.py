"""Cartesian N-D domain decomposition over a multi-axis device mesh, with
PER-SHARD assembly.

Generalizes the 1D slab runtime (parallel/slab.py) to the reference's full
DMDA decomposition: PETSc splits the node grid along EVERY dimension into a
cartesian rank grid (femixedspace.c:1154-1161, PETSC_DECIDE 2D/3D layouts),
with macro-element-aligned ownership (femixedspace.c:1102-1124). Here:

  - the device mesh has one named axis per decomposed grid dimension
    ("dx", "dy", "dz"); element boxes are mloc[d] = m_el[d] / dev[d] per
    device (divisibility enforced like the reference's errors);
  - interface node planes are stored redundantly on both neighbors along
    every decomposed axis (the DMDA ghosted-local pattern), so element
    gathers are communication-free;
  - after each element scatter, interface partial sums are exchanged with
    `lax.ppermute` ONE AXIS AT A TIME -- sequential per-axis halo-adds
    propagate edge/corner contributions correctly because the accumulation
    is additive (the y-exchange carries the already-added x-interface
    values, etc.);
  - dot products weight each plane by the product of per-axis ownership
    masks and reduce with a single `lax.psum` over all mesh axes;
  - setup is PER-SHARD (the reference's per-rank assembly,
    femixedspace.c:2306-2647): each device's element blocks are assembled
    from ITS OWN local element box -- a local FESpace whose quadrature
    points are shifted to global coordinates for coefficient evaluation --
    so the dominant setup memory (nel x 81 x 81 element blocks) scales
    with 1/ndev. Only O(ndof) boundary-condition masks are global.
"""

from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from exsaddle_tpu.grid_ops import (_gather_q2, _scatter_q2, _gather_q1,
                                   _scatter_q1)

AXES = ("dx", "dy", "dz")     # device-mesh axis names, grid dim d -> AXES[d]


class CartPartition:
    """Host-side cartesian layout of a SaddleMesh over a device grid.

    dev_shape: devices per grid dimension, (px, py[, pz]); every
    m_el[d] must divide by dev_shape[d]."""

    def __init__(self, mesh, dev_shape):
        self.mesh = mesh
        self.dev_shape = tuple(dev_shape)
        assert len(self.dev_shape) == mesh.ndim
        for m, p in zip(mesh.m_el, self.dev_shape):
            if m % p:
                raise ValueError(
                    f"element count {m} not divisible by {p} devices "
                    "(macro-element alignment, femixedspace.c:1102-1124)")
        self.mloc = tuple(m // p for m, p in zip(mesh.m_el, self.dev_shape))
        self.nn_u_loc = tuple(2 * m + 1 for m in self.mloc)
        self.nn_p_loc = tuple(m + 1 for m in self.mloc)
        self.nel_loc = int(np.prod(self.mloc))
        self.ndev = int(np.prod(self.dev_shape))
        self.axes = AXES[: mesh.ndim]

    # device grid iteration: index tuples (ix, iy[, iz])
    def dev_boxes(self):
        import itertools
        return list(itertools.product(*[range(p) for p in self.dev_shape]))

    def _stack_shape(self):
        """Leading device axes of stacked arrays: reversed (z-major) so
        array dim k maps to mesh axis AXES[ndim-1-k]."""
        return tuple(reversed(self.dev_shape))

    def device_mesh(self, devices):
        """jax Mesh with named axes matching the stacked leading dims."""
        nd = self.mesh.ndim
        devs = np.asarray(devices[: self.ndev]).reshape(self._stack_shape())
        return Mesh(devs, tuple(reversed(self.axes)))

    def specs(self):
        """PartitionSpec sharding the leading device axes."""
        return P(*tuple(reversed(self.axes)))

    # --- global <-> stacked-shard conversions (setup/check path) ----------
    def _grid_slices(self, box, nodes_per_el, extra):
        """Per-dimension slices of a device's local node box inside the
        global grid (array layout: reversed dims)."""
        sl = []
        for d in reversed(range(self.mesh.ndim)):
            start = nodes_per_el * box[d] * self.mloc[d]
            count = nodes_per_el * self.mloc[d] + 1
            sl.append(slice(start, start + count))
        return tuple(sl) + extra

    def shard_vector(self, x):
        """Global (ndof,) -> {"u": (devz, devy, devx, nzl, nyl, nxl, d),
        "p": (...)} stacked shard grids (interface planes duplicated)."""
        mesh = self.mesh
        nd = mesh.ndim
        x = np.asarray(x)
        xu = x[: mesh.nu].reshape(tuple(reversed(mesh.nn_u)) + (nd,))
        xp = x[mesh.nu:].reshape(tuple(reversed(mesh.nn_p)))
        su = np.empty(self._stack_shape()
                      + tuple(reversed(self.nn_u_loc)) + (nd,), x.dtype)
        sp_ = np.empty(self._stack_shape()
                       + tuple(reversed(self.nn_p_loc)), x.dtype)
        for box in self.dev_boxes():
            dev_idx = tuple(reversed(box))
            su[dev_idx] = xu[self._grid_slices(box, 2, (slice(None),))]
            sp_[dev_idx] = xp[self._grid_slices(box, 1, ())]
        return {"u": su, "p": sp_}

    def unshard_vector(self, sh):
        mesh = self.mesh
        nd = mesh.ndim
        u = np.asarray(sh["u"])
        p = np.asarray(sh["p"])
        xu = np.zeros(tuple(reversed(mesh.nn_u)) + (nd,), u.dtype)
        xp = np.zeros(tuple(reversed(mesh.nn_p)), p.dtype)
        for box in self.dev_boxes():
            dev_idx = tuple(reversed(box))
            xu[self._grid_slices(box, 2, (slice(None),))] = u[dev_idx]
            xp[self._grid_slices(box, 1, ())] = p[dev_idx]
        return np.concatenate([xu.reshape(-1), xp.reshape(-1)])

    def device_put(self, dmesh, sh):
        spec = NamedSharding(dmesh, self.specs())
        return jax.tree.map(lambda a: jax.device_put(jnp.asarray(a), spec),
                            sh)


# --- per-shard collectives (inside shard_map) -------------------------------

def halo_add_axis(grid, ax, dim):
    """Exchange-and-add the two interface planes along array dim `dim`
    with the neighbors on device-mesh axis `ax`."""
    ndev = lax.axis_size(ax)
    if ndev == 1:
        return grid
    up = [(i, i + 1) for i in range(ndev - 1)]
    dn = [(i + 1, i) for i in range(ndev - 1)]
    idx_lo = (slice(None),) * dim + (0,)
    idx_hi = (slice(None),) * dim + (grid.shape[dim] - 1,)
    from_left = lax.ppermute(grid[idx_hi], ax, up)
    from_right = lax.ppermute(grid[idx_lo], ax, dn)
    grid = grid.at[idx_lo].add(from_left)
    return grid.at[idx_hi].add(from_right)


def ghost_extend_axis(grid, ax, dim):
    """Extend a redundant-interface local grid by ONE ghost plane on each
    side of array dim `dim` via ppermute on device-mesh axis `ax`.

    Local planes 0..m along `dim` span global [b*m, b*m + m]; the left
    ghost (global b*m - 1) is the left neighbor's plane m-1 (its [-2]),
    the right ghost (global b*m + m + 1) is the right neighbor's plane 1.
    Unpaired boundary devices receive ppermute zeros -- exactly the
    zero-padding a domain-boundary stencil apply needs."""
    ndev = lax.axis_size(ax)
    zero = jnp.zeros_like(lax.index_in_dim(grid, 0, axis=dim))
    if ndev == 1:
        return jnp.concatenate([zero, grid, zero], axis=dim)
    up = [(i, i + 1) for i in range(ndev - 1)]
    dn = [(i + 1, i) for i in range(ndev - 1)]
    from_left = lax.ppermute(
        lax.index_in_dim(grid, grid.shape[dim] - 2, axis=dim), ax, up)
    from_right = lax.ppermute(lax.index_in_dim(grid, 1, axis=dim), ax, dn)
    return jnp.concatenate([from_left, grid, from_right], axis=dim)


def halo_add_all(grid, nd):
    """Sequential per-axis halo-add: array dim k corresponds to mesh axis
    AXES[nd-1-k] (x fastest in memory, z slowest). Sequential exchanges
    propagate corner/edge sums correctly (additivity)."""
    for k in range(nd):
        grid = halo_add_axis(grid, AXES[nd - 1 - k], k)
    return grid


def owned_weight(shape_loc, nd, dtype):
    """Product of per-axis ownership weights: the low interface plane
    along each decomposed axis counts only on the first device of that
    axis."""
    w = jnp.ones(shape_loc[:nd], dtype)
    for k in range(nd):
        ax = AXES[nd - 1 - k]
        idx = lax.axis_index(ax)
        wk = jnp.ones((shape_loc[k],), dtype).at[0].set(
            jnp.where(idx > 0, 0.0, 1.0).astype(dtype))
        w = w * wk.reshape((-1,) + (1,) * (nd - 1 - k))
    return w


def cart_dot(a, b, nd):
    wu = owned_weight(a["u"].shape, nd, a["u"].dtype)
    wp = owned_weight(a["p"].shape, nd, a["p"].dtype)
    s = (jnp.sum(a["u"] * b["u"] * wu[..., None])
         + jnp.sum(a["p"] * b["p"] * wp))
    return lax.psum(s, tuple(reversed(AXES[:nd])))


def cart_norm(a, nd):
    return jnp.sqrt(cart_dot(a, a, nd))


# --- per-shard assembly ------------------------------------------------------

def assemble_local_blocks(part, ctx, lame=False):
    """PER-SHARD assembly (femixedspace.c:2306-2647's per-rank loop): for
    every device box, build a LOCAL FESpace on the box's element range
    EXTENDED by one ghost-element ring (clipped at the domain boundary),
    shift its quadrature points to global coordinates, evaluate the model
    coefficients there, Q1-project locally, assemble, and keep the owned
    elements' blocks. The lumped qp->Q1 projection only couples a node to
    its adjacent elements, so one ghost ring reproduces the GLOBAL
    projection exactly -- local and global assembly agree to roundoff.
    Returns stacked (dev..., nel_loc, ...) arrays.

    On a real multi-host run each host runs only its own boxes; this
    in-process loop emulates that -- the assembly code path touches one
    box (plus its ghost ring) at a time and never materializes a global
    element batch."""
    from exsaddle_tpu import models as emodels, driver
    from exsaddle_tpu.assembly import (FESpace, assemble_element_matrices,
                                       project_qp_to_q1, interp_q1_to_qp)
    from exsaddle_tpu.mesh import SaddleMesh

    mesh = part.mesh
    nd = mesh.ndim
    cell = [s / m for s, m in zip(mesh.size, mesh.m_el)]
    blocks = {}
    for box in part.dev_boxes():
        e0 = [box[d] * part.mloc[d] for d in range(nd)]
        lo = [1 if e0[d] > 0 else 0 for d in range(nd)]
        hi = [1 if e0[d] + part.mloc[d] < mesh.m_el[d] else 0
              for d in range(nd)]
        m_ext = tuple(part.mloc[d] + lo[d] + hi[d] for d in range(nd))
        origin = np.array([cell[d] * (e0[d] - lo[d]) for d in range(nd)])
        lmesh = SaddleMesh(nd, m_ext,
                           tuple(cell[d] * m_ext[d] for d in range(nd)))
        lfes = FESpace(lmesh)
        pts = lfes.qp_coords.reshape(-1, nd) + origin[None, :]
        c = emodels.evaluate_coefficients(ctx, pts).reshape(
            lmesh.nel, lfes.nqp, -1)
        nodal = project_qp_to_q1(lfes, c)
        coeff = driver._qp_dict(ctx, interp_q1_to_qp(lfes, nodal))
        elm = assemble_element_matrices(lfes, coeff, lame=lame)
        # slice out the owned elements (x-fastest layout on the extended
        # box: reshape to the reversed element grid, drop the ghost ring)
        sl = tuple(slice(lo[d], lo[d] + part.mloc[d])
                   for d in reversed(range(nd)))
        owned = {}
        for name in ("A11", "A12", "A22"):
            a = elm[name]
            if a is None:                       # Stokes: A22 = 0
                npb = lmesh.p_basis
                owned[name] = np.zeros((part.nel_loc, npb, npb))
                continue
            a = np.asarray(a)
            g = a.reshape(tuple(reversed(m_ext)) + a.shape[1:])
            owned[name] = g[sl].reshape((-1,) + a.shape[1:])
        blocks[tuple(reversed(box))] = owned
    stack_shape = part._stack_shape()
    out = {}
    for name in ("A11", "A12", "A22"):
        first = blocks[next(iter(blocks))][name]
        arr = np.empty(stack_shape + first.shape, first.dtype)
        for dev_idx, elm in blocks.items():
            arr[dev_idx] = elm[name]
        out[name] = arr
    return out


@partial(jax.tree_util.register_dataclass,
         data_fields=["A11", "A12", "A21", "A22", "keep_u", "keep_p",
                      "mask_u", "mask_p"],
         meta_fields=["m_el_loc", "nn_u_loc", "nn_p_loc"])
@dataclass(frozen=True)
class CartOperator:
    """Per-shard element blocks + BC masks (leading device axes)."""
    A11: jnp.ndarray
    A12: jnp.ndarray
    A21: jnp.ndarray
    A22: jnp.ndarray
    keep_u: jnp.ndarray
    keep_p: jnp.ndarray
    mask_u: jnp.ndarray
    mask_p: jnp.ndarray
    m_el_loc: tuple
    nn_u_loc: tuple
    nn_p_loc: tuple

    @classmethod
    def build(cls, part, ctx, bc_idx, lame=False, dtype=jnp.float64):
        """Per-shard assembly + symmetric Dirichlet elimination applied to
        the LOCAL element blocks (rows and columns of constrained dofs
        zeroed elementwise; the unit diagonal rides on mask_u/mask_p in
        mult_local)."""
        mesh = part.mesh
        blocks = assemble_local_blocks(part, ctx, lame=lame)
        bc = np.zeros(mesh.ndof)
        bc[np.asarray(bc_idx)] = 1.0
        sh_mask = part.shard_vector(bc)
        sh_keep = part.shard_vector(1.0 - bc)
        # per-element keep factors from the local grids
        nd = mesh.ndim
        stack = part._stack_shape()
        keep_u = sh_keep["u"]
        keep_p = sh_keep["p"]
        A11 = np.asarray(blocks["A11"])
        A12 = np.asarray(blocks["A12"])
        A21 = A12.swapaxes(-1, -2).copy()       # raw A21 = A12^T
        A22 = np.asarray(blocks["A22"])
        for box in part.dev_boxes():
            di = tuple(reversed(box))
            ku = np.asarray(_gather_q2(jnp.asarray(keep_u[di]),
                                       part.mloc))    # (nel_loc, nud)
            kp = np.asarray(_gather_q1(jnp.asarray(keep_p[di]),
                                       part.mloc))
            m = A11[di] * ku[:, :, None]
            m *= ku[:, None, :]
            A11[di] = m
            A12[di] = A12[di] * ku[:, :, None] * kp[:, None, :]
            A21[di] = A21[di] * kp[:, :, None] * ku[:, None, :]
            A22[di] = A22[di] * kp[:, :, None] * kp[:, None, :]
        cast = lambda a: jnp.asarray(np.asarray(a), dtype)
        return cls(A11=cast(A11), A12=cast(A12), A21=cast(A21),
                   A22=cast(A22),
                   keep_u=cast(keep_u), keep_p=cast(keep_p),
                   mask_u=cast(sh_mask["u"]), mask_p=cast(sh_mask["p"]),
                   m_el_loc=part.mloc, nn_u_loc=part.nn_u_loc,
                   nn_p_loc=part.nn_p_loc)

    def mult_local(self, x):
        """Per-shard y = A x; call inside shard_map (device axes already
        stripped)."""
        m_el = self.m_el_loc
        nd = len(m_el)
        xe = _gather_q2(x["u"], m_el)
        pe = _gather_q1(x["p"], m_el)
        yue = (jnp.einsum("eij,ej->ei", self.A11, xe)
               + jnp.einsum("eij,ej->ei", self.A12, pe))
        ype = (jnp.einsum("eij,ej->ei", self.A21, xe)
               + jnp.einsum("eij,ej->ei", self.A22, pe))
        yu = _scatter_q2(yue, m_el, self.nn_u_loc, nd)
        yp = _scatter_q1(ype, m_el, self.nn_p_loc)
        yu = halo_add_all(yu, nd)
        yp = halo_add_all(yp, nd)
        return {"u": yu + self.mask_u * x["u"],
                "p": yp + self.mask_p * x["p"]}


def _strip_dev(t, nd):
    return jax.tree.map(lambda a: a.reshape(a.shape[nd:]), t)


def _add_dev(t, nd):
    return jax.tree.map(lambda a: a.reshape((1,) * nd + a.shape), t)


def make_cart_mult(dmesh, nd):
    """jit-able distributed y = A x on stacked shard pytrees."""
    from jax import shard_map
    spec = P(*tuple(reversed(AXES[:nd])))
    vec_specs = {"u": spec, "p": spec}

    def local(op, v):
        return _add_dev(_strip_dev(op, nd).mult_local(_strip_dev(v, nd)),
                        nd)

    @jax.jit
    def mult(op, x):
        f = shard_map(local, mesh=dmesh,
                      in_specs=(jax.tree.map(lambda _: spec, op), vec_specs),
                      out_specs=vec_specs)
        return f(op, x)

    return mult


def make_cart_fgmres(dmesh, nd, k):
    """Fully-jitted distributed FGMRES(k) cycle with Jacobi preconditioning
    over the cartesian device mesh: psum Gram-Schmidt, per-axis ppermute
    halos, no host round-trips (SURVEY.md section 3.2 hot loop)."""
    from jax import shard_map
    spec = P(*tuple(reversed(AXES[:nd])))
    vec_specs = {"u": spec, "p": spec}

    def cycle_local(op, inv_diag, F, x0):
        op = _strip_dev(op, nd)
        inv_diag = _strip_dev(inv_diag, nd)
        F = _strip_dev(F, nd)
        x0 = _strip_dev(x0, nd)

        mult = op.mult_local
        pc = lambda v: jax.tree.map(jnp.multiply, inv_diag, v)
        axpy = lambda a, x, y: jax.tree.map(lambda u, v: a * u + v, x, y)

        r0 = jax.tree.map(jnp.subtract, F, mult(x0))
        beta = cart_norm(r0, nd)
        safe = jnp.where(beta == 0.0, 1.0, beta)
        V = [jax.tree.map(lambda a: a / safe, r0)]
        Z = []
        H = jnp.zeros((k + 1, k), F["u"].dtype)
        for j in range(k):
            z = pc(V[j])
            w = mult(z)
            hs = [cart_dot(V[i], w, nd) for i in range(j + 1)]
            for i in range(j + 1):
                w = axpy(-hs[i], V[i], w)
            hj1 = cart_norm(w, nd)
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
        rnorm = cart_norm(jax.tree.map(jnp.subtract, F, mult(x)), nd)
        return _add_dev(x, nd), rnorm

    @jax.jit
    def solve(op, inv_diag, F, x0):
        f = shard_map(
            cycle_local, mesh=dmesh,
            in_specs=(jax.tree.map(lambda _: spec, op), vec_specs,
                      vec_specs, vec_specs),
            out_specs=(vec_specs, P()))
        return f(op, inv_diag, F, x0)

    return solve
