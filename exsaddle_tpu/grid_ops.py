"""Structured-grid saddle operator apply (the accelerator fast path).

The element-batched apply in operator.py uses generic gather/scatter-add,
which lowers to indexed scatters with atomic or sorted updates on an
accelerator. On a structured Q2-Q1 box mesh
the element->node map is a tensor-product stencil, so both directions can
be expressed with static strided slices:

  gather:  element-local node (la,lb,lc) of all elements = the strided
           slice x_grid[lc : lc+2*mz-1 : 2, lb : ..., la : ...]
           (Q2 element origins stride 2 in node space; Q1 stride 1).
  scatter: the transpose -- implemented as `lax.pad` with interior padding
           1 (Q2) / 0 (Q1) plus an elementwise add, i.e. pure pad+add
           fusions with no scatter at all.

This is the same operator as SaddleOperator.mult (femixedspace.c:2373-2647
semantics incl. Dirichlet masking), verified bit-comparable in tests; only
the data movement differs.
"""

from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax


def _gather_q2(x_grid, m_el):
    """x_grid: (*rev(nn_u), d) -> (nel, 3^nd * d) element dof values,
    local node x-fastest, component fastest within node."""
    nd = len(m_el)
    slabs = []
    if nd == 2:
        mx, my = m_el
        for lb in range(3):
            for la in range(3):
                slabs.append(x_grid[lb:lb + 2 * my - 1:2,
                                    la:la + 2 * mx - 1:2, :])
        xe = jnp.stack(slabs, axis=2)              # (my, mx, 9, d)
        return xe.reshape(mx * my, 9 * x_grid.shape[-1])
    mx, my, mz = m_el
    for lc in range(3):
        for lb in range(3):
            for la in range(3):
                slabs.append(x_grid[lc:lc + 2 * mz - 1:2,
                                    lb:lb + 2 * my - 1:2,
                                    la:la + 2 * mx - 1:2, :])
    xe = jnp.stack(slabs, axis=3)                  # (mz, my, mx, 27, d)
    return xe.reshape(mx * my * mz, 27 * x_grid.shape[-1])


def _scatter_q2(ye, m_el, nn, d):
    """(nel, 3^nd * d) element contributions -> (*rev(nn), d) grid via
    interior-padding adds (conflict-free per local offset)."""
    nd = len(m_el)
    if nd == 2:
        mx, my = m_el
        yel = ye.reshape(my, mx, 9, d)
        out = jnp.zeros((nn[1], nn[0], d), ye.dtype)
        for lb in range(3):
            for la in range(3):
                c = yel[:, :, la + 3 * lb, :]
                out = out + lax.pad(
                    c, jnp.array(0.0, ye.dtype),
                    [(lb, nn[1] - lb - (2 * my - 1), 1),
                     (la, nn[0] - la - (2 * mx - 1), 1),
                     (0, 0, 0)])
        return out
    mx, my, mz = m_el
    yel = ye.reshape(mz, my, mx, 27, d)
    out = jnp.zeros((nn[2], nn[1], nn[0], d), ye.dtype)
    for lc in range(3):
        for lb in range(3):
            for la in range(3):
                c = yel[:, :, :, la + 3 * lb + 9 * lc, :]
                out = out + lax.pad(
                    c, jnp.array(0.0, ye.dtype),
                    [(lc, nn[2] - lc - (2 * mz - 1), 1),
                     (lb, nn[1] - lb - (2 * my - 1), 1),
                     (la, nn[0] - la - (2 * mx - 1), 1),
                     (0, 0, 0)])
    return out


def _gather_q1(p_grid, m_el):
    """p_grid: (*rev(nn_p),) -> (nel, 2^nd)."""
    nd = len(m_el)
    slabs = []
    if nd == 2:
        mx, my = m_el
        for lb in range(2):
            for la in range(2):
                slabs.append(p_grid[lb:lb + my, la:la + mx])
        return jnp.stack(slabs, axis=2).reshape(mx * my, 4)
    mx, my, mz = m_el
    for lc in range(2):
        for lb in range(2):
            for la in range(2):
                slabs.append(p_grid[lc:lc + mz, lb:lb + my, la:la + mx])
    return jnp.stack(slabs, axis=3).reshape(mx * my * mz, 8)


def _scatter_q1(ye, m_el, nn):
    nd = len(m_el)
    if nd == 2:
        mx, my = m_el
        yel = ye.reshape(my, mx, 4)
        out = jnp.zeros((nn[1], nn[0]), ye.dtype)
        for lb in range(2):
            for la in range(2):
                out = out + lax.pad(
                    yel[:, :, la + 2 * lb], jnp.array(0.0, ye.dtype),
                    [(lb, nn[1] - lb - my, 0), (la, nn[0] - la - mx, 0)])
        return out
    mx, my, mz = m_el
    yel = ye.reshape(mz, my, mx, 8)
    out = jnp.zeros((nn[2], nn[1], nn[0]), ye.dtype)
    for lc in range(2):
        for lb in range(2):
            for la in range(2):
                out = out + lax.pad(
                    yel[:, :, :, la + 2 * lb + 4 * lc],
                    jnp.array(0.0, ye.dtype),
                    [(lc, nn[2] - lc - mz, 0),
                     (lb, nn[1] - lb - my, 0),
                     (la, nn[0] - la - mx, 0)])
    return out


@partial(jax.tree_util.register_dataclass,
         data_fields=["A11", "A12", "A21", "A22", "bc_mask"],
         meta_fields=["m_el", "nn_u", "nn_p", "nu", "np_"])
@dataclass(frozen=True)
class GridSaddleOperator:
    """Stencil-structured saddle operator: same blocks as SaddleOperator
    but applied via strided slices + pad-adds (no gather/scatter)."""
    A11: jnp.ndarray          # (nel, nud, nud)
    A12: jnp.ndarray          # (nel, nud, npb)
    A21: jnp.ndarray          # (nel, npb, nud)
    A22: jnp.ndarray          # (nel, npb, npb)
    bc_mask: jnp.ndarray      # (ndof,)
    m_el: tuple
    nn_u: tuple
    nn_p: tuple
    nu: int
    np_: int

    @classmethod
    def from_operator(cls, mesh, op, dtype=None):
        cast = (lambda a: jnp.asarray(a, dtype)) if dtype else jnp.asarray
        return cls(A11=cast(op.A11), A12=cast(op.A12), A21=cast(op.A21),
                   A22=cast(op.A22), bc_mask=cast(op.bc_mask),
                   m_el=tuple(mesh.m_el), nn_u=tuple(mesh.nn_u),
                   nn_p=tuple(mesh.nn_p), nu=mesh.nu, np_=mesh.np_)

    @property
    def ndof(self):
        return self.nu + self.np_

    def mult(self, x):
        nd = len(self.m_el)
        xu = x[: self.nu]
        xp = x[self.nu:]
        x_grid = xu.reshape(tuple(reversed(self.nn_u)) + (nd,))
        p_grid = xp.reshape(tuple(reversed(self.nn_p)))

        xe = _gather_q2(x_grid, self.m_el)          # (nel, nud)
        pe = _gather_q1(p_grid, self.m_el)          # (nel, npb)

        yue = (jnp.einsum("eij,ej->ei", self.A11, xe)
               + jnp.einsum("eij,ej->ei", self.A12, pe))
        ype = (jnp.einsum("eij,ej->ei", self.A21, xe)
               + jnp.einsum("eij,ej->ei", self.A22, pe))

        yu = _scatter_q2(yue, self.m_el, self.nn_u, nd).reshape(-1)
        yp = _scatter_q1(ype, self.m_el, self.nn_p).reshape(-1)
        y = jnp.concatenate([yu, yp])
        return y + self.bc_mask * x
