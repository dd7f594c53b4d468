"""Fully-jitted ABF (Approximate Block Factorization) saddle solver.

The flagship solver configuration (abf.opts:1-16 wired by exSaddle.c:303-422)
as ONE traced computation: FGMRES(30, right PC, unpreconditioned norm) over
fieldsplit-Schur-UPPER, whose u-block is GCR(rtol 1e-2) preconditioned by a
Galerkin-MG V-cycle with Chebyshev(8)/Jacobi smoothers and a dense coarse
solve, and whose p-block is a fixed Chebyshev polynomial in the
Jacobi-preconditioned viscosity-scaled pressure mass matrix (the
spectrally-equivalent, device-friendly stand-in for PETSc's serial
bjacobi+ILU(0) on Mpscaled, abf.opts:14-15).

Everything below `ABFSolver.solve` runs on device inside `lax.while_loop`s
with on-device convergence tests -- no host scalar pulls in the iteration
(the hot loop of SURVEY.md section 3.2). Vectors live in the parity-permuted
tree layout of matfree.ParityMatFreeOperator: a list of 2^nd velocity parity
subgrids plus the Q1 pressure grid, so every element gather/scatter and
every MG transfer is a unit-stride slice / pad-add.

Multigrid structure (match: -saddle_fieldsplit_u_pc_mg_galerkin, abf.opts:13):
  - fine level: the factored matrix-free A00 apply (matfree.py);
  - level fine-1: EXACT Galerkin apply in factored form
        A_1 = P^T A_fine P  applied as  restrict . A_fine . prolong
    (P = DMDA multilinear interpolation, which in the parity layout is a
    pure slice-average: coarse nodes ARE parity class 0);
  - deeper levels: 3^nd-point block stencils extracted from the host
    Galerkin RAP products (no jax.experimental.sparse anywhere);
  - coarsest: replicated dense solve with a precomputed inverse
    (PCREDUNDANT + LU equivalent; Makefile:276).
"""

import contextlib
import itertools
import os
import sys
import time
from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from exsaddle_tpu import treeops
from exsaddle_tpu.grid_ops import _gather_q1, _scatter_q1
from exsaddle_tpu.matfree import (ParityMatFreeOperator, parity_permutation,
                                  mult_tree, tree_aux, to_tree, from_tree)
from jax.lax import optimization_barrier as _ob


# --------------------------------------------------------------------------
# Block applies on the parity operator (the fieldsplit blocks of the
# BC-eliminated saddle matrix, as PETSc's MatCreateSubMatrix extracts them)
# --------------------------------------------------------------------------

def mult_u_tree(op, aux, subs, halo_u=None):
    """A00 x_u: velocity block with keep/mask Dirichlet elimination
    (unit diagonal on BC rows). halo_u: optional post-scatter
    interface-plane exchange (distributed slabs, parallel/dist_abf.py)."""
    ks, ms, _, _ = aux
    xe = _ob(op._gather_u([s * k for s, k in zip(subs, ks)]))
    strain = _ob(xe @ op.Bs.T) * op.scale_visc
    yue = _ob(strain @ op.Bs)
    outs = op._scatter_u(yue)
    if halo_u is not None:
        outs = halo_u(outs)
    return [o * k + m * s for o, k, m, s in zip(outs, ks, ms, subs)]


def mult_up_tree(op, aux, pg, halo_u=None):
    """A01 x_p: pressure-gradient block into u space (BC rows zeroed)."""
    ks, _, _, _ = aux
    pe = _ob(_gather_q1(pg, op.m_el))
    ptmp = _ob(pe @ op.Np.T)
    yue = -_ob((ptmp * op.fac[None, :]) @ op.Dm)
    outs = op._scatter_u(yue)
    if halo_u is not None:
        outs = halo_u(outs)
    return [o * k for o, k in zip(outs, ks)]


def mult_pu_tree(op, aux, subs, halo_p=None):
    """A10 x_u: divergence block into p space (BC columns zeroed)."""
    ks, _, _, _ = aux
    xe = _ob(op._gather_u([s * k for s, k in zip(subs, ks)]))
    div = _ob(xe @ op.Dm.T)
    ype = -(div * op.fac[None, :]) @ op.Np
    yp = _scatter_q1(ype, op.m_el, op.nn_p)
    return yp if halo_p is None else halo_p(yp)


def mp_apply(op, pscale, pg, halo_p=None):
    """Mpscaled x_p: viscosity-scaled pressure mass matrix in factored form
    (MatAssemble_Schur weights, femixedspace.c:2837-2948).
    pscale: (nel, nqp) = -w_q detJp (1/eta) [Lame: (1/lambda + 1/mu)]."""
    pe = _ob(_gather_q1(pg, op.m_el))
    ptmp = (pe @ op.Np.T) * pscale
    yp = _scatter_q1(ptmp @ op.Np, op.m_el, op.nn_p)
    return yp if halo_p is None else halo_p(yp)


# --------------------------------------------------------------------------
# MG transfers
# --------------------------------------------------------------------------

def _class_bits(p, nd):
    return [(p >> a) & 1 for a in range(nd)]


def prolong_parity(xc, cls_shapes, m_el):
    """Multilinear interpolation coarse grid -> fine parity subgrids.

    xc: (*rev(m+1 per axis), nd). Coarse nodes coincide with fine parity
    class 0; a fine node with parity bits b averages its 2^{popcount(b)}
    coarse neighbors -- every term a unit-stride slice."""
    nd = len(m_el)
    subs = []
    for p, shp in enumerate(cls_shapes):
        bits = _class_bits(p, nd)
        w = 0.5 ** sum(bits)
        acc = None
        for deltas in itertools.product(*[range(b + 1) for b in bits]):
            idx = tuple(
                slice(deltas[nd - 1 - dim], deltas[nd - 1 - dim]
                      + shp[dim]) for dim in range(nd)) + (slice(None),)
            piece = xc[idx]
            acc = piece if acc is None else acc + piece
        subs.append(w * acc)
    return subs


def restrict_parity(subs, cls_shapes, m_el):
    """Transpose of prolong_parity: fine parity subgrids -> coarse grid."""
    nd = len(m_el)
    cshape = tuple(m_el[nd - 1 - dim] + 1 for dim in range(nd))
    dt = subs[0].dtype
    out = jnp.zeros(cshape + (subs[0].shape[-1],), dt)
    zero = jnp.array(0.0, dt)
    for p, shp in enumerate(cls_shapes):
        bits = _class_bits(p, nd)
        w = 0.5 ** sum(bits)
        for deltas in itertools.product(*[range(b + 1) for b in bits]):
            pads = [(deltas[nd - 1 - dim],
                     cshape[dim] - shp[dim] - deltas[nd - 1 - dim], 0)
                    for dim in range(nd)] + [(0, 0, 0)]
            out = out + w * lax.pad(subs[p], zero, pads)
    return out


def prolong_grid(xc, fine_shape):
    """Separable multilinear interpolation between plain node grids
    (spatial dims leading, dof trailing). fine_shape: spatial shape of the
    output. Matches precond_mg.Prolongation for (M+1)/2-coarsened grids."""
    x = xc
    nd = len(fine_shape)
    for dim in range(nd):
        x = _prolong_axis(x, dim, fine_shape[dim])
    return x


def _prolong_axis(x, axis, nf):
    x = jnp.moveaxis(x, axis, 0)
    a = x                                     # even fine slots
    b = 0.5 * (x[:-1] + x[1:])                # odd fine slots
    inter = jnp.stack([a[:-1], b], axis=1).reshape((-1,) + x.shape[1:])
    out = jnp.concatenate([inter, a[-1:]], axis=0)
    assert out.shape[0] == nf
    return jnp.moveaxis(out, 0, axis)


def restrict_grid(rf, coarse_shape):
    """Transpose of prolong_grid."""
    x = rf
    nd = len(coarse_shape)
    for dim in range(nd):
        x = _restrict_axis(x, dim, coarse_shape[dim])
    return x


def _restrict_axis(x, axis, nc):
    x = jnp.moveaxis(x, axis, 0)
    r = x[::2]
    odd = 0.5 * x[1::2]
    zero = jnp.array(0.0, x.dtype)
    pads = [(0, 0, 0)] * x.ndim
    lo = list(pads); lo[0] = (0, 1, 0)
    hi = list(pads); hi[0] = (1, 0, 0)
    r = r + lax.pad(odd, zero, lo) + lax.pad(odd, zero, hi)
    assert r.shape[0] == nc
    return jnp.moveaxis(r, 0, axis)


# --------------------------------------------------------------------------
# Block stencil operator (deep Galerkin levels)
# --------------------------------------------------------------------------

def stencil_from_csr(A_csr, grid_shape, nd):
    """Extract a 3^ndim-point block stencil from an assembled operator on a
    structured node grid with nd dofs per node (Galerkin RAP of a Q1-type
    operator stays within the 3^ndim-point pattern).

    grid_shape: spatial (reversed: z,y,x) node counts.
    Returns W: (*grid_shape, 3^ndim, nd, nd) with W[..., s, i, j] the
    coupling to the neighbor at offset s (offsets x-fastest, -1..1).

    Vectorized via a BSR view: every (node, neighbor) block maps to a
    stencil slot by coordinate difference -- no per-entry CSR indexing
    (the previous per-slot fancy-indexing path cost seconds at mx=32)."""
    import scipy.sparse as sp
    ndim = len(grid_shape)
    nn = tuple(reversed(grid_shape))          # per-axis counts, x first
    nnod = int(np.prod(nn))
    A = sp.bsr_matrix(A_csr.tocsr(), blocksize=(nd, nd))
    indptr, indices, data = A.indptr, A.indices, A.data
    rows = np.repeat(np.arange(nnod, dtype=np.int64), np.diff(indptr))
    cols = indices.astype(np.int64)

    def decode(lin):
        out = []
        for d in range(ndim):
            out.append(lin % nn[d])
            lin = lin // nn[d]
        return out                            # per-axis coords, x first

    rc = decode(rows.copy())
    cc = decode(cols.copy())
    slot = np.zeros(rows.shape, dtype=np.int64)
    mult = 1
    for d in range(ndim):
        off = cc[d] - rc[d]
        assert np.abs(off).max(initial=0) <= 1, \
            "operator exceeds the 3^ndim-point stencil pattern"
        slot += (off + 1) * mult
        mult *= 3
    W = np.zeros((nnod, 3 ** ndim, nd, nd))
    W[rows, slot] = data
    return W.reshape(grid_shape + (3 ** ndim, nd, nd))


def stencil_accum(W, xp):
    """y = A x for a block stencil operator, with xp ALREADY carrying one
    ghost layer on each side of every spatial dim (zeros at domain
    boundaries; distributed callers fill decomposed-axis ghosts from
    neighbors via ppermute). W: (*grid_shape, 3^nd, nd, nd)."""
    ndim = xp.ndim - 1
    shape = tuple(W.shape[:ndim])
    offs = [tuple(reversed(o))
            for o in itertools.product(*[(-1, 0, 1)] * ndim)]
    y = jnp.zeros(shape + (xp.shape[-1],), xp.dtype)
    for s, off in enumerate(offs):
        # off is x-fastest (axis order x,y,z); array dims are reversed
        idx = tuple(slice(1 + off[ndim - 1 - dim],
                          1 + off[ndim - 1 - dim] + shape[dim])
                    for dim in range(ndim))
        y = y + jnp.einsum("...ij,...j->...i", W[..., s, :, :], xp[idx])
    return y


def stencil_apply(W, x):
    """y = A x for a block stencil operator. x: (*grid_shape, nd)."""
    ndim = x.ndim - 1
    zero = jnp.array(0.0, x.dtype)
    xp = lax.pad(x, zero, [(1, 1, 0)] * ndim + [(0, 0, 0)])
    return stencil_accum(W, xp)


def stencil_to_merged(W):
    """Lane-friendly form of a block stencil: the trailing (x, dof) dims
    fuse into one length-(nx*nd) dim (m = nd*ix + a), and the dof-coupling
    offsets delta = j - a become extra shifted terms along it:

        y[.., m] = sum_{s, delta} V[s, delta, .., m] * x[.., m + off_x(s)*nd + delta]

    A block stencil with trailing dim nd=3 gives every elementwise
    operation a minor dimension of only 3; the merged layout runs the same
    multiply-adds along a minor dimension of nx*nd, which vectorizes
    without padding the short dof axis.

    Returns V: (3^ndim, 2*nd-1, *grid[:-1], nx*nd)."""
    grid = W.shape[:-3]
    ns = W.shape[-3]
    nd = W.shape[-1]
    nx = grid[-1]
    ndelta = 2 * nd - 1
    V = np.zeros((ns, ndelta) + grid[:-1] + (nx * nd,), W.dtype)
    for s in range(ns):
        for a in range(nd):
            for j in range(nd):
                di = (j - a) + nd - 1
                V[(s, di) + (Ellipsis, slice(a, None, nd))] = \
                    W[..., s, a, j]
    return V


def stencil_apply_merged(V, x):
    """y = A x in the merged (x, dof) lane layout. x: (*grid[:-1], nx*nd).
    Transposes stencil_to_merged; identical matrix, summation order over
    (s, delta) instead of (s, j)."""
    ns, ndelta = V.shape[0], V.shape[1]
    nd = (ndelta + 1) // 2
    ndim = x.ndim                     # spatial dims, merged last
    pad_m = 2 * nd - 1
    zero = jnp.array(0.0, x.dtype)
    xp = lax.pad(x, zero, [(1, 1, 0)] * (ndim - 1) + [(pad_m, pad_m, 0)])
    shape = x.shape
    offs = [tuple(reversed(o))
            for o in itertools.product(*[(-1, 0, 1)] * ndim)]
    y = jnp.zeros_like(x)
    for s, off in enumerate(offs):
        lead = tuple(slice(1 + off[ndim - 1 - d],
                           1 + off[ndim - 1 - d] + shape[d])
                     for d in range(ndim - 1))
        for di in range(ndelta):
            sh = pad_m + off[0] * nd + (di - (nd - 1))
            y = y + V[s, di] * xp[lead + (slice(sh, sh + shape[-1]),)]
    return y


# --------------------------------------------------------------------------
# Setup
# --------------------------------------------------------------------------

@contextlib.contextmanager
def _stage(name):
    """Setup-phase stage timer: prints per-stage wall time to stderr when
    EXSADDLE_SETUP_PROFILE=1 (the observability hook behind the bench's
    solve_setup_seconds budget)."""
    if os.environ.get("EXSADDLE_SETUP_PROFILE") != "1":
        yield
        return
    t0 = time.perf_counter()
    yield
    print(f"[setup] {name}: {time.perf_counter() - t0:.2f} s",
          file=sys.stderr, flush=True)


@dataclass(frozen=True)
class ABFConfig:
    """Static solver configuration (baked into the trace)."""
    ndim: int
    nlevels: int = 3
    restart: int = 30
    rtol: float = 1e-5
    atol: float = 1e-50
    dtol: float = 1e4
    max_it: int = 10000
    hist_len: int = 256
    gcr_rtol: float = 1e-2
    gcr_restart: int = 30
    gcr_max_it: int = 200
    # >0: replace the u-block GCR solve by this many MG-preconditioned
    # Richardson steps (n V-cycles + n-1 operator applies, no Krylov
    # window bookkeeping). The outer FGMRES is flexible, so a fixed-cycle
    # inner solve is admissible; the abf.opts-matching configuration keeps
    # 0 (= GCR at rtol 1e-2, abf.opts:5-6).
    u_fixed_vcycles: int = 0
    cheb_its: int = 8
    # pre-smoothing iteration count; 0 means "same as cheb_its" (the
    # symmetric abf.opts:8-12 default). The IR bench path may run an
    # asymmetric V-cycle (fewer pre- than post-smooths): the outer
    # flexible Krylov methods tolerate the weaker-but-cheaper cycle.
    cheb_pre_its: int = 0
    p_cheb_its: int = 12
    # Matmul precision for every dot_general in the solve trace. A
    # reduced-precision product (bfloat16, or TF32's 10-bit mantissa)
    # perturbs the operator and the Gram-Schmidt dots by ~1e-3 relative,
    # which raises the outer FGMRES iteration count well above the
    # reference's; "float32" keeps float32-accurate products. On the GPU,
    # "float32" means full FP32 arithmetic with no TF32.
    matmul_precision: str = "float32"
    # Matmul precision INSIDE the MG V-cycle and the Schur p-polynomial
    # (the preconditioner only -- FGMRES/GCR residuals, Gram-Schmidt and
    # the operator applies they see stay at matmul_precision). A flexible
    # outer Krylov method tolerates a perturbed preconditioner, so the
    # smoothing matmuls could run at reduced precision ("tensorfloat32"
    # or "bfloat16"); kept "float32" by default for bit-stable regression
    # behavior.
    pc_matmul_precision: str = "float32"
    # grid metadata (filled by build)
    cls_shapes: tuple = ()
    m_el: tuple = ()
    level_grids: tuple = ()     # reversed spatial node shapes, coarse->fine


def _esteig_bounds(apply_fn, diag, n, transform=(0.0, 0.2, 0.0, 1.1),
                   return_hes=False):
    """Setup-phase Chebyshev eigenvalue estimation: GMRES(10) Hessenberg
    eigenvalues with left Jacobi preconditioning on the noisy RHS, then
    PETSc's esteig transform (abf.opts:10) -- the same algorithm as the
    host KSP path (krylov.KSP._solve_gmres: classical Gram-Schmidt,
    Givens recurrence, preconditioned-norm test at rtol 1e-12), in pure
    numpy: the jnp host-KSP variant dispatched hundreds of tiny eager XLA
    ops whose cold-process compiles cost ~5 s of every setup."""
    invd = 1.0 / np.asarray(diag)

    def Aop(v):
        return np.asarray(apply_fn(v))

    from exsaddle_tpu.krylov import noisy_vector
    b = noisy_vector(n)
    max_it = 10
    rtol = 1e-12
    haptol = 1e-30
    V = np.zeros((max_it + 1, n))
    Hes = np.zeros((max_it + 1, max_it))       # unrotated (for eig)
    H = np.zeros((max_it + 1, max_it))         # rotated (residual recurrence)
    cs = np.zeros(max_it)
    sn = np.zeros(max_it)
    g = np.zeros(max_it + 1)
    v0 = invd * b
    res0 = float(np.linalg.norm(v0))
    V[0] = v0 / res0
    g[0] = res0
    it = 0
    while it < max_it:
        w = invd * Aop(V[it])
        h = V[: it + 1] @ w
        w = w - h @ V[: it + 1]
        tt = float(np.linalg.norm(w))
        Hes[: it + 1, it] = h
        Hes[it + 1, it] = tt
        H[: it + 1, it] = h
        H[it + 1, it] = tt
        hapbnd = min(abs(tt / g[it]) if g[it] != 0 else 0.0, haptol)
        hapend = tt <= hapbnd
        if not hapend:
            V[it + 1] = w / tt
        for i in range(it):
            t1, t2 = H[i, it], H[i + 1, it]
            H[i, it] = cs[i] * t1 + sn[i] * t2
            H[i + 1, it] = -sn[i] * t1 + cs[i] * t2
        delta = np.hypot(H[it, it], H[it + 1, it])
        if delta == 0.0:
            break
        cs[it] = H[it, it] / delta
        sn[it] = H[it + 1, it] / delta
        g[it + 1] = -sn[it] * g[it]
        g[it] = cs[it] * g[it]
        it += 1
        if hapend or abs(g[it]) <= rtol * res0:
            break
    ev = np.linalg.eigvals(Hes[:it, :it])
    emin_est, emax_est = float(ev.real.min()), float(ev.real.max())
    a, b_, c, d = transform
    out = (a * emin_est + b_ * emax_est, c * emin_est + d * emax_est)
    if return_hes:
        # unrotated (it+1, it) Hessenberg, for the krylov.KSP recurrence
        # parity test (ADVICE r4: the two Arnoldi implementations must
        # agree column for column)
        return out + (Hes[: it + 1, :it],)
    return out


def p_spectrum_bounds(Sel):
    """Spectrum bracket of D^-1 Mpscaled from the ELEMENT matrices alone.

    D is the assembled diagonal of -Mpscaled, so for any x
        x^T (-Mp) x / x^T D x = (sum_e x_e^T Se x_e) / (sum_e x_e^T diag(Se) x_e)
    which is bracketed by the extreme eigenvalues of the diagonally scaled
    element blocks Be = diag(Se)^{-1/2} Se diag(Se)^{-1/2} (the classical
    element-eigenvalue bound for assembled SPD forms). One batched 8x8 /
    4x4 eigvalsh, measured slack < 0.4% on the pseudoice coefficients
    (mx=16: [0.125005, 3.374956] vs ARPACK's [0.125467, 3.370794]); the
    bracket is one-sided SAFE (it can only widen the interval).

    Sel: (nel, npb, npb) negative-definite Schur-pre element matrices
    (assemble_schur_pre; femixedspace.c:2837-2948 weights)."""
    Se = -np.asarray(Sel)
    d = np.einsum("eii->ei", Se)
    s = 1.0 / np.sqrt(d)
    B = Se * s[:, :, None] * s[:, None, :]
    ew = np.linalg.eigvalsh(B)
    return float(ew[:, 0].min()), float(ew[:, -1].max())


def _lanczos_extremes(Msym, m=48):
    """Deterministic fixed-step Lanczos (full reorthogonalization, ones
    start vector) extreme Ritz values of a symmetric CSR matrix. At these
    mass-matrix spectra 48 steps reproduce ARPACK's lambda_max to ~1e-9
    relative in ~0.05 s where ARPACK's tol=1e-8 iteration took ~2 s at
    mx=32 (the bottom of the spectrum clusters, so lambda_min converges
    slowly -- callers combine with the element bracket's lower end)."""
    n = Msym.shape[0]
    m = min(m, n)
    V = np.zeros((m + 1, n))
    alph = np.zeros(m)
    beta = np.zeros(m)
    V[0] = 1.0 / np.sqrt(n)
    k = m
    for j in range(m):
        w = Msym @ V[j]
        alph[j] = V[j] @ w
        w -= alph[j] * V[j]
        if j > 0:
            w -= beta[j - 1] * V[j - 1]
        w -= V[: j + 1].T @ (V[: j + 1] @ w)
        beta[j] = np.linalg.norm(w)
        if beta[j] == 0.0:
            k = j + 1
            break
        V[j + 1] = w / beta[j]
    T = (np.diag(alph[:k]) + np.diag(beta[:k - 1], 1)
         + np.diag(beta[:k - 1], -1))
    ew = np.linalg.eigvalsh(T)
    return float(ew[0]), float(ew[-1])


def p_spectrum_bounds_assembled(Mp, dmp, el_bounds):
    """Chebyshev interval for the Schur p-block: spectrum of D^-1 Mpscaled
    (both negative definite -> positive spectrum).

    Small problems (np <= 600) keep the exact dense eigenvalues (bit-
    identical to the pre-round-5 behavior on every reference-parity case).
    Larger ones combine a 48-step deterministic Lanczos (lambda_max to
    ~1e-9 of the ARPACK value) with the element bracket's SAFE lower end
    (el_bounds, p_spectrum_bounds) -- together within 0.2% of the ARPACK
    interval at ~20x less setup cost, and identical between the
    single-device and cartesian builds (same assembled matrix, same
    deterministic iteration)."""
    import scipy.sparse as sp
    Dm_s = sp.diags(1.0 / np.sqrt(np.abs(dmp)))
    Msym = (Dm_s @ (-Mp) @ Dm_s).tocsr()
    if Msym.shape[0] <= 600:
        ew = np.linalg.eigvalsh(Msym.toarray())
        return float(ew[0]), float(ew[-1])
    lo_l, hi_l = _lanczos_extremes(Msym)
    return min(float(el_bounds[0]), lo_l), hi_l


def _p_loc_l2(nd):
    """Element-local block of the fine <- L-2 multilinear interpolation:
    P_loc[(l, a), (c, a)] for one element (identical for every element on
    the uniform grid). Rows: Q2-local nodes x-fastest, dof interleaved;
    cols: corners x-fastest, dof interleaved. The tensor-product closed
    form of precond_mg.Prolongation restricted to one element -- building
    the full fine-grid CSR (6.6M entries at mx=32) just to slice this
    (nud, ncd) block cost ~3 s of every setup."""
    w1 = np.array([[1.0, 0.0], [0.5, 0.5], [0.0, 1.0]])
    P = w1
    for _ in range(nd - 1):
        P = np.kron(w1, P)          # slowest axis outermost: l = la + 3 lb + ...
    return np.kron(P, np.eye(nd))


def _galerkin_l2_elements(mesh, P_loc, Bs, s_flat, keep_e, bc_u):
    """Per-element Galerkin L-2 contributions of the BC-eliminated fine
    velocity block A00 = K (Bs^T diag(s) Bs) K + diag(bc).

    Returns A1e (nel, ncd, ncd), corner-ordered x-fastest, with
    sum_e scatter(A1e) == P^T A00 P exactly: the interpolation row of
    any fine node inside an element is supported entirely on that
    element's corners (trilinear weights vanish on the others), and the
    diag(bc) term is folded in per element with 1/multiplicity weights on
    element-shared fine nodes.

    The (nel, nud, nud) element-matrix batch is NEVER built: interior
    elements share C0 = Bs P_loc (only the viscosity scale varies), and
    only boundary elements (O(surface)) get a per-element masked C."""
    nd = mesh.ndim
    nel = mesh.nel
    ue = np.asarray(mesh.u_el_dofs)
    mels = np.asarray(mesh.m_el)

    # P restricted to one element (identical for every element on the
    # uniform grid): passed in analytically (_p_loc_l2)
    C0 = Bs @ P_loc                                           # (nqpc, ncd)
    ncd = P_loc.shape[1]

    A1e = np.empty((nel, ncd, ncd))
    interior = np.all(keep_e == 1.0, axis=1)
    bidx = np.nonzero(~interior)[0]

    # 1/multiplicity ownership weight of each local fine node (a Q2 node
    # on an interior element face belongs to 2 elements per shared axis)
    # -- needed only for the O(surface) BC-touching elements, so the
    # (nel, nbu, nd) coordinate temporaries are never built (~0.6 s at
    # mx=32 for rows the interior dgemm ignores)
    egrid = np.stack(np.meshgrid(
        *[np.arange(m) for m in reversed(mels)], indexing="ij"),
        -1)[..., ::-1].reshape(-1, nd)[bidx]    # element x-fastest
    loff = np.stack(np.meshgrid(*[np.arange(3)] * nd, indexing="ij"),
                    -1)[..., ::-1].reshape(-1, nd)            # x-fastest
    gco = 2 * egrid[:, None, :] + loff[None, :, :]            # (nb,nbu,nd)
    shared = ((loff[None, :, :] % 2 == 0) & (gco > 0)
              & (gco < (2 * mels)[None, None, :]))
    multipl = np.prod(np.where(shared, 2.0, 1.0), axis=2)     # (nb, nbu)
    wbc_b = np.repeat(1.0 / multipl, nd, axis=1) * bc_u[ue[bidx]]
    # interior elements in ONE dgemm: A1e[e] = sum_q s[e,q] C0[q,:]C0[q,:]^T
    # = (s @ K) with K[q, ab] = C0[q,a] C0[q,b] (a batched-tiny-matmul
    # formulation here cost 13 s at mx=32 in temporaries + dispatch)
    K = (C0[:, :, None] * C0[:, None, :]).reshape(C0.shape[0], ncd * ncd)
    A1e[interior] = (s_flat[interior] @ K).reshape(-1, ncd, ncd)
    for c0 in range(0, len(bidx), 4096):
        sel = bidx[c0:c0 + 4096]
        wsel = wbc_b[c0:c0 + 4096]
        b = len(sel)
        T = keep_e[sel][:, :, None] * P_loc[None]             # (b,nud,ncd)
        # one dgemm for every masked C: Bs @ [T_e | T_e | ...]
        C = (Bs @ T.transpose(1, 0, 2).reshape(T.shape[1], b * ncd))
        C = C.reshape(-1, b, ncd).transpose(1, 0, 2)          # (b,nqpc,ncd)
        blk = np.matmul(C.transpose(0, 2, 1) * s_flat[sel][:, None, :], C)
        blk += np.matmul(P_loc.T[None] * wsel[:, None, :], P_loc[None])
        A1e[sel] = blk
    return A1e


def _stencil_from_l2_elements(A1e, m_el, nd):
    """Scatter per-element L-2 Galerkin blocks (corner ordering x-fastest)
    straight into the 3^nd-point block stencil via 4^nd slice-adds -- no
    COO intermediate (the 18.9M-entry coo->csr sort cost ~3 s at mx=32)."""
    grid = tuple(reversed([m + 1 for m in m_el]))
    W = np.zeros(grid + (3 ** nd, nd, nd))
    A1g = A1e.reshape(tuple(reversed(m_el)) + A1e.shape[1:])
    for ca in range(2 ** nd):
        abits = [(ca >> d) & 1 for d in range(nd)]
        idx = tuple(slice(abits[nd - 1 - k],
                          abits[nd - 1 - k] + m_el[nd - 1 - k])
                    for k in range(nd))
        for cb in range(2 ** nd):
            slot = sum((((cb >> d) & 1) - abits[d] + 1) * 3 ** d
                       for d in range(nd))
            W[idx + (slot,)] += A1g[..., ca * nd:(ca + 1) * nd,
                                    cb * nd:(cb + 1) * nd]
    return W


def csr_from_stencil(W, grid_shape, nd):
    """Inverse of stencil_from_csr: assemble the scipy CSR directly from a
    block stencil. Within each row, ascending slot index IS ascending
    column index (both are x-fastest lexicographic), so indices come out
    sorted with no COO sort."""
    import scipy.sparse as sp
    ndim = len(grid_shape)
    nn = tuple(reversed(grid_shape))          # per-axis counts, x first
    nnod = int(np.prod(nn))
    ns = 3 ** ndim
    coords = []
    lin = np.arange(nnod, dtype=np.int64)
    for d in range(ndim):
        coords.append(lin % nn[d])
        lin = lin // nn[d]
    offs = [tuple(reversed(o))
            for o in itertools.product(*[(-1, 0, 1)] * ndim)]
    valid = np.ones((nnod, ns), dtype=bool)
    cols_nb = np.zeros((nnod, ns), dtype=np.int64)
    for s, off in enumerate(offs):
        col = np.zeros(nnod, dtype=np.int64)
        mult = 1
        ok = np.ones(nnod, dtype=bool)
        for d in range(ndim):
            c = coords[d] + off[d]
            ok &= (c >= 0) & (c < nn[d])
            col += np.clip(c, 0, nn[d] - 1) * mult
            mult *= nn[d]
        valid[:, s] = ok
        cols_nb[:, s] = col
    # rows ordered (node, i); entries within a row ordered (s, j)
    Wl = W.reshape(nnod, ns, nd, nd).transpose(0, 2, 1, 3)  # (nnod,i,s,j)
    vmask = np.broadcast_to(valid[:, None, :, None], Wl.shape)
    data = Wl[vmask]
    cols = np.broadcast_to(
        (cols_nb[:, :, None] * nd + np.arange(nd))[:, None, :, :],
        Wl.shape)[vmask]
    counts = (valid.sum(axis=1, dtype=np.int64) * nd)
    counts = np.repeat(counts, nd)
    indptr = np.zeros(nnod * nd + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    n = nnod * nd
    return sp.csr_matrix((data, cols.astype(np.int32), indptr),
                         shape=(n, n))


def build_abf(mesh, fes, coeff_qp, bc_idx, bc_vals, lame=False,
              dtype=jnp.float64, nlevels=3, cfg_kw=None, A00_csr=None):
    """Build (config, data, setup) for the jitted ABF solve.

    Host setup mirrors the reference's one-pass assembly
    (femixedspace.c:2373-2647) but entirely in FACTORED form: the fine
    Jacobi diagonal, the esteig probe apply, the Galerkin L-2 matrix and
    rhs_diri all come from Bs/scale -- the (nel, nud, nud) element batch
    is never materialized (it is ~16 GB at mx=32 and dominated round-3's
    101-second setup). Galerkin RAP below L-2 stays scipy (small), esteig
    per level, and the Mpscaled weights as before. Returns (cfg, data,
    setup) where data is a pytree of device arrays (pass as jit
    arguments)."""
    from exsaddle_tpu.precond_mg import (Prolongation,
                                         galerkin_coarse_operators)
    from exsaddle_tpu.matfree import factored_host, MatFreeSaddleOperator
    import scipy.sparse as sp

    nd = mesh.ndim
    nu = mesh.nu
    nel = mesh.nel
    ue = np.asarray(mesh.u_el_dofs)

    bc_mask = np.zeros(mesh.ndof)
    bc_mask[:nu][np.asarray(bc_idx)] = 1.0
    x_bc = np.zeros(mesh.ndof)
    x_bc[:nu][np.asarray(bc_idx)] = np.asarray(bc_vals)
    bc_u = bc_mask[:nu]
    keep_u = 1.0 - bc_u

    with _stage("factored_host"):
        fd = factored_host(mesh, fes, coeff_qp, lame=lame)
    Bs, Dm_m, Np_m, fac = fd["Bs"], fd["Dm"], fd["Np"], fd["fac"]
    s_flat = fd["scale"]                          # (nel, nqp*ncomp), f64

    with _stage("parity op build"):
        pop = ParityMatFreeOperator.build(mesh, fes, coeff_qp, bc_mask,
                                          lame=lame, dtype=dtype, host=fd)
        aux = tree_aux(pop)
        perm, iperm = parity_permutation(mesh)

    # rhs_diri = -(A_raw x_bc), BC rows zeroed (femixedspace.c:2634-2643);
    # x_bc is zero at pressure dofs so only A11/A21 contribute, and only
    # the O(surface) elements touching a BC node contribute at all --
    # the GEMMs run on those rows alone (~30x fewer at mx=32)
    with _stage("rhs_diri"):
        bce = np.nonzero(bc_u[ue].any(axis=1))[0]
        xbe = x_bc[:nu][ue[bce]]
        yue = ((xbe @ Bs.T) * s_flat[bce]) @ Bs
        ype = -((xbe @ Dm_m.T) * fac[None, :]) @ Np_m
        rhs_diri = np.zeros(mesh.ndof)
        rhs_diri[:nu] = np.bincount(ue[bce].ravel(), weights=yue.ravel(),
                                    minlength=nu)
        rhs_diri[nu:] = np.bincount(
            np.asarray(mesh.p_el_nodes)[bce].ravel(),
            weights=ype.ravel(), minlength=mesh.np_)
        rhs_diri = -rhs_diri
        rhs_diri[:nu][np.asarray(bc_idx)] = 0.0

    # float64 factored saddle operator: the "assembled matrix" stand-in
    # for residual checks (tests) and the IR path
    with _stage("f64 saddle op"):
        sop = MatFreeSaddleOperator.build(mesh, fes, coeff_qp, bc_mask,
                                          lame=lame, dtype=jnp.float64,
                                          host=fd)

    # velocity-grid hierarchy (fine -> coarse), DMDA (M+1)/2 coarsening
    grids = [tuple(mesh.nn_u)]
    for _ in range(nlevels - 1):
        grids.append(tuple((m + 1) // 2 for m in grids[-1]))
    grids = grids[::-1]                      # coarsest first
    for g in grids:
        assert all(n >= 2 for n in g), "too many MG levels for this mesh"

    # deep transfer operators only (coarsest .. L-2); the FINE-level
    # Prolongation (823875 rows at mx=32, ~3 s to build + CSR-ify) is
    # needed only by the explicit-A00 path below
    with _stage("prolongations"):
        prolongs = [Prolongation(grids[k], grids[k + 1], nd)
                    for k in range(nlevels - 2)]
        if A00_csr is not None:
            prolongs.append(Prolongation(grids[-2], grids[-1], nd))
    W1 = None
    if A00_csr is not None:
        # explicit fine CSR supplied (host PC paths): classic chain
        coarse_csrs = galerkin_coarse_operators(A00_csr, prolongs)
        fine_diag = A00_csr.diagonal()
        fine_apply = (lambda v: A00_csr @ np.asarray(v))
    else:
        # factored fine level: diagonal, esteig apply and the L-2 Galerkin
        # matrix all from Bs/s_flat (A11[e] = Bs^T diag(s_e) Bs exactly)
        with _stage("fine diagonal"):
            keep_e = keep_u[ue]
            diag_e = s_flat @ (Bs ** 2)           # (nel, nud)
            fine_diag = bc_u + np.bincount(
                ue.ravel(), weights=(keep_e * diag_e).ravel(),
                minlength=nu)

        ue_flat = ue.ravel()

        def fine_apply(v):
            x = np.asarray(v)
            xe = (keep_u * x)[ue]
            yue = ((xe @ Bs.T) * s_flat) @ Bs
            # bincount is the vectorized scatter-add (np.add.at runs a
            # slow per-entry inner loop: ~0.15 s per apply at mx=32)
            y = np.bincount(ue_flat, weights=yue.ravel(), minlength=nu)
            return keep_u * y + bc_u * x

        # the fine-level esteig probe (10 GMRES Arnoldi applies, ~1.5 s
        # of dgemm at mx=32) depends only on fine_diag/s_flat -- run it
        # on a worker thread OVERLAPPED with the independent L-2/RAP
        # chain (numpy releases the GIL in BLAS; results are bit-
        # identical to the sequential order)
        import threading
        d_fine_w = np.where(fine_diag == 0.0, 1.0, fine_diag)
        fine_est = {}

        def _fine_esteig():
            try:
                fine_est["bounds"] = _esteig_bounds(fine_apply, d_fine_w,
                                                    nu)
            except BaseException as e:       # re-raised at the join site
                fine_est["error"] = e

        th = threading.Thread(target=_fine_esteig)
        t_est0 = time.perf_counter()
        th.start()

        with _stage("L-2 Galerkin elements"):
            A1e = _galerkin_l2_elements(mesh, _p_loc_l2(nd), Bs, s_flat,
                                        keep_e, bc_u)
        with _stage("L-2 stencil + csr"):
            W1 = _stencil_from_l2_elements(A1e, mesh.m_el, nd)
            A1 = csr_from_stencil(W1, tuple(reversed(grids[-2])), nd)
        with _stage("deep Galerkin RAPs"):
            coarse_csrs = galerkin_coarse_operators(A1, prolongs) + [A1]

    # per-level Jacobi diagonals + esteig bounds (levels coarsest..finest;
    # smoothers live on levels 1..nlevels-1)
    diags, bounds = [], []
    for k in range(1, nlevels):
        if k == nlevels - 1:
            d = np.where(fine_diag == 0.0, 1.0, fine_diag)
            if A00_csr is None:
                with _stage("fine esteig join"):
                    th.join()
                if "error" in fine_est:
                    raise fine_est["error"]
                emin, emax = fine_est["bounds"]
                if os.environ.get("EXSADDLE_SETUP_PROFILE") == "1":
                    print(f"[setup] fine esteig total (overlapped): "
                          f"{time.perf_counter() - t_est0:.2f} s",
                          file=sys.stderr, flush=True)
            else:
                with _stage(f"esteig level {k}"):
                    emin, emax = _esteig_bounds(fine_apply, d, nu)
            diags.append(d)
            bounds.append((emin, emax))
            continue
        A = coarse_csrs[k]
        d = A.diagonal()
        apply_fn = (lambda v, A=A: A @ np.asarray(v))
        n_lvl = A.shape[0]
        d = np.where(d == 0.0, 1.0, d)
        with _stage(f"esteig level {k}"):
            emin, emax = _esteig_bounds(apply_fn, d, n_lvl)
        diags.append(d)
        bounds.append((emin, emax))

    # coarse inverse (PCREDUNDANT + stable dense LU stand-in for UMFPACK)
    with _stage("coarse inverse"):
        A0 = coarse_csrs[0].toarray()
        coarse_inv = np.linalg.inv(A0)

    # block stencils for EVERY intermediate level 1..nlevels-2, including
    # the L-2 Galerkin level: applying L-2 as R A_fine P costs a full
    # fine-grid apply per smoothing iteration (2x the V-cycle,
    # VERDICT r3 weak #3); the materialized 3^nd-point stencil is the
    # same matrix (abf.opts:13 Galerkin semantics) at O(coarse) cost
    lvl_grids = [tuple(reversed(g)) for g in grids]   # reversed (z,y,x)
    stencils = []
    for k in range(1, nlevels - 1):
        if k == nlevels - 2 and W1 is not None:
            stencils.append(W1)               # built with A1, no re-extract
        else:
            stencils.append(stencil_from_csr(coarse_csrs[k],
                                             lvl_grids[k], nd))

    # fine-level Jacobi diagonal in parity tree form
    d_fine = diags[-1][perm[: mesh.nu]]
    inv_fine_flat = 1.0 / d_fine
    # split into parity subgrids
    npdt0 = np.dtype(dtype)

    def split_u(xu):
        subs = []
        off = 0
        for s in pop.cls_shapes:
            n = int(np.prod(s))
            subs.append(jnp.asarray(np.asarray(
                xu[off * nd:(off + n) * nd].reshape(s + (nd,)), npdt0)))
            off += n
        return subs
    inv_diag_fine = split_u(inv_fine_flat)

    # level diagonals as grids (z,y,x,nd), coarsest+1 .. fine-1
    inv_diag_lvls = []
    for k in range(1, nlevels - 1):
        d = diags[k - 1]
        inv_diag_lvls.append(jnp.asarray(np.asarray(
            (1.0 / d).reshape(lvl_grids[k] + (nd,)), npdt0)))

    # Schur p-block: Mpscaled factored weights + Jacobi + Chebyshev bounds
    with _stage("Schur-pre assembly"):
        if lame:
            inv = 1.0 / coeff_qp["lambda"] + 1.0 / coeff_qp["mu"]
        else:
            inv = 1.0 / coeff_qp["eta"]
        pscale = -(fes.wq[None, :] * fes.detJ_p) * inv      # (nel, nqp)
        from exsaddle_tpu.assembly import assemble_schur_pre
        Sel = assemble_schur_pre(fes, coeff_qp, lame=lame)
        dmp = np.bincount(mesh.p_el_nodes.ravel(),
                          weights=np.einsum("eii->ei", Sel).ravel(),
                          minlength=mesh.np_)
        import scipy.sparse as sp
        rows = np.broadcast_to(mesh.p_el_nodes[:, :, None],
                               Sel.shape).ravel()
        cols = np.broadcast_to(mesh.p_el_nodes[:, None, :],
                               Sel.shape).ravel()
        Mp = sp.coo_matrix((Sel.ravel(), (rows, cols)),
                           shape=(mesh.np_, mesh.np_)).tocsr()
    # spectrum interval of D^-1 Mp: exact (dense) on small problems,
    # Lanczos + element bracket above (replaces ARPACK: ~2.4 s -> ~0.1 s
    # at mx=32; see p_spectrum_bounds_assembled)
    with _stage("p-block spectrum"):
        p_emin, p_emax = p_spectrum_bounds_assembled(
            Mp, dmp, p_spectrum_bounds(Sel))

    # cast in numpy first: jnp's f64->f32 conversion of the large setup
    # arrays dispatches XLA convert kernels (~2 s at mx=32 on this host)
    npdt = np.dtype(dtype)
    cast = lambda a: jnp.asarray(np.asarray(a, npdt))
    with _stage("device cast"):
        data = {
            "op": pop,
            "aux": aux,
            "inv_diag_fine": inv_diag_fine,
            "inv_diag_lvls": inv_diag_lvls,
            # merged (x, dof)-lane form: the ONLY stencil form the jitted
            # single-device V-cycle reads; the W-form ships host-side in
            # `setup` for the distributed builds (the L-2 W at mx=32 is
            # ~35 MB -- putting it in `data` wasted that much HBM per
            # solver)
            "stencils_m": [cast(stencil_to_merged(W)) for W in stencils],
            "coarse_inv": cast(coarse_inv),
            "bounds": [(cast(b[0]), cast(b[1])) for b in bounds],
            "pscale": cast(pscale),
            "inv_diag_p": cast((1.0 / dmp).reshape(
                tuple(reversed(mesh.nn_p)))),
            "p_bounds": (cast(p_emin), cast(p_emax)),
        }
    cfg = ABFConfig(ndim=nd, nlevels=nlevels,
                    cls_shapes=tuple(tuple(s) for s in pop.cls_shapes),
                    m_el=tuple(mesh.m_el),
                    level_grids=tuple(lvl_grids),
                    **(cfg_kw or {}))
    setup = {"mesh": mesh, "sop": sop, "rhs_diri": rhs_diri,
             "bc_mask": bc_mask, "x_bc": x_bc, "perm": perm, "iperm": iperm,
             "A00_csr": A00_csr, "coarse_csrs": coarse_csrs, "Mp": Mp,
             "stencils_w": stencils}
    return cfg, data, setup


# --------------------------------------------------------------------------
# The composed jitted solver
# --------------------------------------------------------------------------

def make_abf_solver(cfg):
    """Return solve(data, F_tree, x0_tree) -> (x_tree, its, rnorm, state,
    hist), fully traceable. F/x trees are (subs list, p_grid) in the parity
    layout (matfree.to_tree)."""
    nlev = cfg.nlevels
    nd = cfg.ndim

    def solver(data, F, x0):
        with jax.default_matmul_precision(cfg.matmul_precision):
            return _solver_body(data, F, x0)

    def _solver_body(data, F, x0):
        op = data["op"]
        aux = data["aux"]

        # --- level applies (index k: 0 coarsest .. nlev-1 finest) ---------
        def fineA(subs):
            return mult_u_tree(op, aux, subs)

        def coarse_solve(xg):
            flat = xg.reshape(-1)
            return (data["coarse_inv"] @ flat).reshape(xg.shape)

        def merge(x):
            s = x.shape
            return x.reshape(s[:-2] + (s[-2] * s[-1],))

        def unmerge(x):
            s = x.shape
            return x.reshape(s[:-1] + (s[-1] // nd, nd))

        # level operators for k = 1 .. nlev-1 (smoothed levels); every
        # intermediate level -- including the L-2 Galerkin level -- is a
        # materialized block stencil (same matrix as R A_fine P at
        # O(coarse) cost per smoothing iteration), applied in the merged
        # (x, dof)-lane layout
        lvl_ops = {}
        lvl_pc = {}
        lvl_bounds = {}
        for k in range(1, nlev):
            emin, emax = data["bounds"][k - 1]
            lvl_bounds[k] = (emin, emax)
            if k == nlev - 1:
                lvl_ops[k] = fineA
                invd = data["inv_diag_fine"]
                lvl_pc[k] = lambda t, d=invd: [a * b for a, b in zip(d, t)]
            else:
                V = data["stencils_m"][k - 1]
                lvl_ops[k] = (lambda xm, V=V:
                              stencil_apply_merged(V, xm))
                invd_m = merge(data["inv_diag_lvls"][k - 1])
                lvl_pc[k] = lambda t, d=invd_m: d * t

        pre_its = cfg.cheb_pre_its if cfg.cheb_pre_its > 0 else cfg.cheb_its

        def smooth(k, b, x0v, pre=False):
            emin, emax = lvl_bounds[k]
            # unroll the small stencil levels; keep the big fine level as
            # a tight loop (see treeops.cheb_smooth's measurements).
            # Pre-smooths start from the zero vector: x0_zero skips the
            # initial A x0 apply (bit-identical result, one fewer mult).
            return treeops.cheb_smooth(lvl_ops[k], lvl_pc[k], emin, emax,
                                       pre_its if pre else cfg.cheb_its,
                                       b, x0v, unroll=(k < nlev - 1),
                                       x0_zero=pre)

        def restrict_k(k, r):
            """Residual transfer from level k to k-1."""
            if k == nlev - 1:
                return restrict_parity(r, cfg.cls_shapes, cfg.m_el)
            return restrict_grid(r, cfg.level_grids[k - 1])

        def prolong_k(k, xc):
            """Correction transfer from level k-1 to k."""
            if k == nlev - 1:
                return prolong_parity(xc, cfg.cls_shapes, cfg.m_el)
            return prolong_grid(xc, cfg.level_grids[k])

        def vcycle(k, b):
            """PCMG multiplicative V-cycle from zero initial guess
            (precond_mg.PCMG semantics). Mid-level iterates live in the
            merged lane layout; transfers see the (.., x, nd) form."""
            if k == 0:
                return coarse_solve(b)
            if k == nlev - 1:
                x = smooth(k, b, treeops.tzeros_like(b), pre=True)
                r = treeops.tsub(b, lvl_ops[k](x))
                xc = vcycle(k - 1, restrict_k(k, r))
                x = treeops.taxpy(1.0, prolong_k(k, xc), x)
                return smooth(k, b, x)
            bm = merge(b)
            xm = smooth(k, bm, jnp.zeros_like(bm), pre=True)
            rm = bm - lvl_ops[k](xm)
            xc = vcycle(k - 1, restrict_k(k, unmerge(rm)))
            xm = xm + merge(prolong_k(k, xc))
            return unmerge(smooth(k, bm, xm))

        def mg_pc(r):
            with jax.default_matmul_precision(cfg.pc_matmul_precision):
                return vcycle(nlev - 1, r)

        # --- u-block solve (abf.opts:5-6) ---------------------------------
        if cfg.u_fixed_vcycles > 0:
            nfv = cfg.u_fixed_vcycles

            def gcr(ru):
                x = mg_pc(ru)
                for _ in range(nfv - 1):
                    r = treeops.tsub(ru, fineA(x))
                    x = treeops.taxpy(1.0, mg_pc(r), x)
                return x, jnp.int32(nfv), jnp.float32(0.0)
        else:
            gcr = treeops.make_gcr(fineA, mg_pc, restart=cfg.gcr_restart,
                                   rtol=cfg.gcr_rtol, max_it=cfg.gcr_max_it)

        # --- Schur p-block: Chebyshev in Jacobi-preconditioned Mpscaled ---
        p_emin, p_emax = data["p_bounds"]
        pscale = data["pscale"]
        inv_dp = data["inv_diag_p"]

        def p_mult(pg):
            return mp_apply(op, pscale, pg)

        def p_pc(pg):
            return inv_dp * pg

        def p_solve(bp):
            with jax.default_matmul_precision(cfg.pc_matmul_precision):
                return treeops.cheb_smooth(p_mult, p_pc, p_emin, p_emax,
                                           cfg.p_cheb_its, bp,
                                           jnp.zeros_like(bp),
                                           x0_zero=True)

        # --- fieldsplit Schur UPPER (exSaddle.c:313-318) -------------------
        def pc_apply(t):
            bu, bp = t
            yp = p_solve(bp)
            gu = mult_up_tree(op, aux, yp)
            ru = [b - g for b, g in zip(bu, gu)]
            yu, _, _ = gcr(ru)
            return (yu, yp)

        def saddle_mult(t):
            return mult_tree(op, aux, t)

        fgmres = treeops.make_fgmres(saddle_mult, pc_apply,
                                     restart=cfg.restart, rtol=cfg.rtol,
                                     atol=cfg.atol, dtol=cfg.dtol,
                                     max_it=cfg.max_it,
                                     hist_len=cfg.hist_len)
        return fgmres(F, x0)

    return solver


def make_ir_solver(cfg, wdt, max_rounds=10):
    """Mixed-precision iterative refinement as ONE traced computation: the
    outer float64-residual correction loop is a `lax.while_loop` whose
    body runs the full jitted ABF solve (make_abf_solver) in the working
    dtype `wdt` -- zero host round trips, so no dispatch or
    synchronization gaps, between refinement rounds.

    Semantics are exactly ABFSolver.solve_ir's host loop: at least one
    round always runs; a diverged inner solve or a non-contracting
    correction REJECTS the update and stops (stalled); otherwise the loop
    continues until the true float64 residual falls below rtol * ||r0||
    or max_rounds is hit.

    Returns solve(data, op64, aux64, F64, rtol, n_rounds) ->
    (x64, rounds, inner_total, rnorm, rnorm0, history, stalled); rtol and
    n_rounds (<= the static max_rounds history bound) are traced scalars,
    so neither forces a recompile."""
    inner = make_abf_solver(cfg)

    def resid(op64, aux64, F64, x64):
        with jax.default_matmul_precision("float32"):
            r = jax.tree.map(jnp.subtract, F64,
                             mult_tree(op64, aux64, x64))
            return r, treeops.tnorm(r)

    def solve(data, op64, aux64, F64, rtol, n_rounds):
        x0 = treeops.tzeros_like(F64)
        r0, rnorm0 = resid(op64, aux64, F64, x0)
        hist = jnp.full((max_rounds + 1,), -1.0, jnp.float64)
        hist = hist.at[0].set(rnorm0)

        def cond(c):
            (x64, r64, rnorm, rounds, inner_total, hist, done,
             stalled) = c
            return jnp.logical_not(done) & (rounds < n_rounds)

        def body(c):
            (x64, r64, rnorm, rounds, inner_total, hist, done,
             stalled) = c
            rt = jax.tree.map(lambda a: jnp.asarray(a, wdt), r64)
            dx, its, _, state, _ = inner(data, rt,
                                         treeops.tzeros_like(rt))
            x_try = jax.tree.map(
                lambda x, d: x + jnp.asarray(d, jnp.float64), x64, dx)
            r_try, rn_try = resid(op64, aux64, F64, x_try)
            rounds = rounds + 1
            inner_total = inner_total + its
            accept = (state >= 0) & (rn_try < rnorm)
            sel = lambda a, b: jnp.where(accept, a, b)
            x64 = jax.tree.map(sel, x_try, x64)
            r64 = jax.tree.map(sel, r_try, r64)
            rnorm = jnp.where(accept, rn_try, rnorm)
            hist = jnp.where(accept, hist.at[rounds].set(rn_try), hist)
            stalled = jnp.logical_not(accept)
            done = stalled | (accept & (rnorm <= rtol * rnorm0))
            return (x64, r64, rnorm, rounds, inner_total, hist, done,
                    stalled)

        c0 = (x0, r0, rnorm0, jnp.int32(0), jnp.int32(0), hist,
              jnp.bool_(False), jnp.bool_(False))
        (x64, r64, rnorm, rounds, inner_total, hist, done,
         stalled) = lax.while_loop(cond, body, c0)
        return x64, rounds, inner_total, rnorm, rnorm0, hist, stalled

    return solve


def _default_device():
    """The device new arrays land on: the innermost jax.default_device
    context's, else the first device of the default backend."""
    dev = jax.config.jax_default_device
    if dev is None:
        return jax.devices()[0]
    if isinstance(dev, str):
        return jax.devices(dev)[0]
    return dev


class ABFSolver:
    """Host-facing wrapper: setup + jitted solve + monitor formatting."""

    def __init__(self, mesh, fes, coeff_qp, bc_idx, bc_vals, lame=False,
                 dtype=jnp.float64, nlevels=3, ir=False, **cfg_kw):
        self.mesh = mesh
        self.dtype = dtype
        # Setup (assembly, Galerkin RAP, esteig, dense inverse) is numpy
        # work plus a few small jnp ops: run those on the CPU backend,
        # then move the data pytree to the target device (the caller's
        # default device) in one transfer.
        target = _default_device()
        cpu = jax.local_devices(backend="cpu")[0]
        with jax.default_device(cpu):
            self.cfg, data, self.setup = build_abf(
                mesh, fes, coeff_qp, bc_idx, bc_vals, lame=lame,
                dtype=dtype, nlevels=nlevels, cfg_kw=cfg_kw)
            self._ir = None
            if ir:
                # float64 operator for iterative-refinement residuals:
                # reuse the f64 factored operator the build already made
                # (scale_visc + masks, not element matrices)
                with _stage("ir op64 build"):
                    op64 = ParityMatFreeOperator.from_matfree(
                        self.setup["sop"], mesh)
                    ir_ops = (op64, tree_aux(op64))
        with _stage("device transfer"):
            self.data = jax.device_put(data, target)
            self._ir_ops = jax.device_put(ir_ops, target) if ir else None
        self._solve = jax.jit(make_abf_solver(self.cfg))
        if ir:
            self._solve_ir_fn = jax.jit(make_ir_solver(self.cfg,
                                                       self.dtype))
            self._ir = True

    def vec_to_tree(self, x_flat):
        """Natural-ordering (ndof,) vector -> parity tree."""
        xp = np.asarray(x_flat)[self.setup["perm"]]
        return to_tree(self.data["op"], jnp.asarray(xp, self.dtype))

    def tree_to_vec(self, t):
        flat = np.asarray(from_tree(t))
        return flat[self.setup["iperm"]]

    def rhs_tree(self, coeff_qp=None, F_flat=None):
        if F_flat is None:
            raise ValueError("pass F_flat (natural ordering)")
        return self.vec_to_tree(F_flat)

    def solve(self, F_flat, x0_flat=None):
        """Solve A x = F. Returns dict with x (natural ordering), its,
        rnorm, reason, history (list of monitored residuals)."""
        Ft = self.vec_to_tree(F_flat)
        x0 = (self.vec_to_tree(x0_flat) if x0_flat is not None
              else treeops.tzeros_like(Ft))
        x, its, rnorm, state, hist = self._solve(self.data, Ft, x0)
        jax.block_until_ready(x)
        its = int(its)
        hist = np.asarray(hist)
        history = [float(h) for h in hist[: its + 1] if h >= 0.0]
        reason = treeops.reason_name(state)
        return {"x": self.tree_to_vec(x), "its": its,
                "rnorm": float(rnorm), "reason": reason,
                "history": history}

    def ir_args(self, F_flat, rtol=1e-8, max_rounds=10):
        """Arguments of the jitted refinement program (`_solve_ir_fn`)
        for right-hand side F_flat (natural ordering)."""
        op64, aux64 = self._ir_ops
        F64 = to_tree(op64, jnp.asarray(
            np.asarray(F_flat)[self.setup["perm"]], jnp.float64))
        return (self.data, op64, aux64, F64, jnp.float64(rtol),
                jnp.int32(max_rounds))

    def solve_ir(self, F_flat, rtol=1e-8, max_rounds=10):
        """Mixed-precision iterative refinement: float64 residuals around
        the low-precision jitted ABF solve (requires ir=True at
        construction): the inner FGMRES runs entirely in the working
        dtype (e.g. float32), while the outer correction loop drives the
        TRUE float64 residual below rtol * ||r0||.

        Returns dict with x (natural ordering, float64), rounds,
        inner_its (total), rnorm (true float64 residual), history (true
        residual per round)."""
        assert self._ir, "construct with ir=True"
        assert max_rounds <= 10, "make_ir_solver compiles for <= 10 rounds"
        # the ENTIRE refinement loop is one jitted while_loop
        # (make_ir_solver): inner f32 solves, f64 residuals, accept/
        # reject and the convergence test all run on device.
        # max_rounds stays inside the compiled bound; rtol is a traced
        # scalar (no recompile per tolerance).
        x64, rounds, inner_total, rnorm, rnorm0, hist, stalled = \
            self._solve_ir_fn(*self.ir_args(F_flat, rtol, max_rounds))
        (rounds, inner_total, rnorm, rnorm0, hist, stalled) = \
            jax.device_get((rounds, inner_total, rnorm, rnorm0, hist,
                            stalled))
        rounds = max(int(rounds), min(1, max_rounds))
        history = [float(h) for h in hist if h >= 0.0]
        rnorm_f = float(rnorm)
        rnorm0 = float(rnorm0)
        flat = np.asarray(from_tree(x64))
        return {"x": flat[self.setup["iperm"]], "rounds": rounds,
                "inner_its": int(inner_total), "rnorm": rnorm_f,
                "rnorm0": rnorm0, "history": history,
                "stalled": bool(stalled),
                "converged": rnorm_f <= rtol * rnorm0}
