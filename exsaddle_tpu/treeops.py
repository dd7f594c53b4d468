"""Jitted Krylov kernels over pytree vectors.

The building blocks of the fully-compiled solver path: FGMRES with restarts
and an ON-DEVICE convergence test (lax.while_loop -- no host scalar pulls),
GCR with a relative-tolerance test (the u-block solver of the ABF
configuration, abf.opts:5-6), and the PETSc Chebyshev recurrence
(cheby.c semantics as in krylov.KSP._solve_chebyshev).

Vectors are arbitrary pytrees of arrays ("tree vectors"); Krylov bases are
stored as stacked-leaf buffers so Gram-Schmidt reduces to masked
tensordots -- large on-device reductions instead of per-vector host loops.

Algorithmic choices mirror PETSc's KSP so iteration counts line up with the
host-orchestrated krylov.py (and thus with testref/): classical (unmodified)
Gram-Schmidt, Givens residual recurrence, right preconditioning with
unpreconditioned norms, KSPConvergedDefault (rtol/abstol/dtol, DIVERGED_ITS
at max_it) -- exSaddle.c:405 + abf.opts:1-16.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
import jax.scipy.linalg as jsla

# state codes (sign convention matches PETSc: >0 converged, <0 diverged)
RUNNING = 0
CONVERGED_RTOL = 2
CONVERGED_ATOL = 3
CONVERGED_HAPPY = 5
DIVERGED_ITS = -3
DIVERGED_DTOL = -4


def reason_name(state):
    """PETSc-style reason string for a jitted-solver state code (the ONE
    mapping shared by ABFSolver, CartABFSolver consumers and the driver
    shim)."""
    return {CONVERGED_RTOL: "CONVERGED_RTOL",
            CONVERGED_ATOL: "CONVERGED_ATOL",
            CONVERGED_HAPPY: "CONVERGED_HAPPY_BREAKDOWN",
            DIVERGED_ITS: "DIVERGED_ITS",
            DIVERGED_DTOL: "DIVERGED_DTOL"}.get(int(state),
                                                str(int(state)))


# --- tree-vector helpers ----------------------------------------------------

def tdot(a, b):
    """Global dot product of two tree vectors."""
    leaves_a = jax.tree.leaves(a)
    leaves_b = jax.tree.leaves(b)
    return sum(jnp.sum(x * y) for x, y in zip(leaves_a, leaves_b))


def tnorm(a):
    return jnp.sqrt(tdot(a, a))


def taxpy(alpha, x, y):
    """alpha*x + y."""
    return jax.tree.map(lambda u, v: alpha * u + v, x, y)


def tscale(alpha, x):
    return jax.tree.map(lambda u: alpha * u, x)

def tsub(a, b):
    return jax.tree.map(jnp.subtract, a, b)

def tzeros_like(t):
    """Zero tree DERIVED from t (a * 0, not jnp.zeros_like): under
    shard_map with check_vma=True a fresh constant is device-invariant,
    and a while_loop carry initialized invariant but updated with varying
    data fails variance checking. Deriving the zeros keeps the variance
    of t."""
    return jax.tree.map(lambda a: a * 0, t)


# --- stacked-leaf Krylov buffers -------------------------------------------

def buf_alloc(t, k):
    """Allocate a k-slot buffer holding vectors shaped like t. The zero
    buffer is derived from t (t*0 broadcast-added into a real allocation)
    so its shard_map variance matches the vectors later buf_set into it
    (check_vma). It must be a MATERIALIZED array, not a lazy
    `broadcast_to` view: dynamic_update_slice into a broadcast cannot
    alias in place, so every buf_set would copy the whole k-slot buffer."""
    return jax.tree.map(
        lambda a: jnp.zeros((k,) + a.shape, a.dtype) + (a * 0)[None], t)


def buf_set(buf, i, t):
    return jax.tree.map(
        lambda B, a: lax.dynamic_update_index_in_dim(B, a, i, 0), buf, t)


def buf_get(buf, i):
    return jax.tree.map(
        lambda B: lax.dynamic_index_in_dim(B, i, 0, keepdims=False), buf)


def buf_dots(buf, t, mask):
    """(k,) masked dots <buf_i, t>: the one-pass classical Gram-Schmidt
    reduction (VecMDot).

    Layout note: formulated as broadcast-multiply + axis reduction, NOT
    `B.reshape(k, -1) @ a.reshape(-1)`. The flattening reshape forces XLA
    to keep a second (flat-major) layout of the Krylov buffer next to the
    tiled layout the in-loop dynamic_update_slice wants, and the per-
    iteration relayout copies can dominate the jitted solve. A full
    flat-window GCR variant (single (k, n) matrices, GEMV dots, tree<->flat
    conversion at the mult/pc boundary) also pays a per-iteration
    unflatten of the iterate that relays every parity leaf the operator
    then gathers from. Both choices were made on earlier hardware and are
    not yet re-measured on the GPU."""
    parts = []
    for B, a in zip(jax.tree.leaves(buf), jax.tree.leaves(t)):
        parts.append(jnp.sum(B * a[None], axis=tuple(range(1, B.ndim))))
    return sum(parts) * mask


def buf_comb(buf, coeff, t):
    """t + sum_i coeff_i buf_i (VecMAXPY). Same layout note as buf_dots."""
    def leaf(B, a):
        cshape = (B.shape[0],) + (1,) * a.ndim
        return a + jnp.sum(B * coeff.reshape(cshape), axis=0)
    return jax.tree.map(leaf, buf, t)


def make_dots(weight=None, psum_axis=None):
    """(dot, bdots) pair for make_fgmres/make_gcr.

    weight: optional tree of per-entry ownership weights -- in a
    domain-decomposed layout with redundantly stored interface planes, the
    duplicate copies get weight 0 so global dots count each dof once (the
    owned-plane masking of SURVEY.md section 5).
    psum_axis: shard_map axis name to lax.psum partial dots over (the
    MPI_Allreduce of every VecDot/VecNorm)."""
    if weight is None and psum_axis is None:
        return tdot, buf_dots

    def dot(a, b):
        aw = a if weight is None else jax.tree.map(jnp.multiply, weight, a)
        s = tdot(aw, b)
        if psum_axis is not None:
            s = lax.psum(s, psum_axis)
        return s

    def bdots(buf, t, mask):
        tw = t if weight is None else jax.tree.map(jnp.multiply, weight, t)
        s = buf_dots(buf, tw, jnp.ones_like(mask))
        if psum_axis is not None:
            s = lax.psum(s, psum_axis)
        return s * mask

    return dot, bdots


# --- Chebyshev smoother ------------------------------------------------------

def cheb_smooth(mult, pc_apply, emin, emax, its, b, x0, unroll=False,
                x0_zero=False):
    """KSPSolve_Chebyshev three-term recurrence with norm type NONE
    (abf.opts:8-12 smoother: fixed `its` applications, nonzero initial
    guess). Matches krylov.KSP._solve_chebyshev step for step.

    unroll=True emits the (static-count) iterations as straight-line code
    instead of a lax.fori_loop: it removes the while loop's fixed cost per
    iteration and lets XLA fuse across iterations, which pays for the
    SMALL stencil levels, while the big fine level's large unrolled graph
    can schedule worse than a tight loop body. Callers pick per level;
    the split was chosen on earlier hardware and is not yet re-measured
    on the GPU.

    x0_zero=True asserts x0 is exactly zero, skipping the initial
    r = b - A x0 operator application (A 0 == 0 bitwise for these masked
    matrix-free applies, so the result is bit-identical with one fewer
    mult -- the pre-smooth of every V-cycle and the Schur p-polynomial
    both start from zero)."""
    scale = 2.0 / (emax + emin)
    alpha_ = 1.0 - scale * emin
    mu = 1.0 / alpha_
    omegaprod = 2.0 / alpha_

    r = b if x0_zero else tsub(b, mult(x0))
    p_k = taxpy(scale, pc_apply(r), x0)

    if unroll:
        p_km1 = x0
        c_km1 = jnp.ones_like(jnp.asarray(mu))
        c_k = mu * c_km1
        for _ in range(1, its):
            c_kp1 = 2.0 * mu * c_k - c_km1
            omega = omegaprod * c_k / c_kp1
            r = tsub(b, mult(p_k))
            z = pc_apply(r)
            # p_kp1 = omega (p_k + scale z - p_km1) + p_km1
            t = taxpy(scale, z, p_k)
            p_kp1 = jax.tree.map(lambda tt, pm: omega * (tt - pm) + pm,
                                 t, p_km1)
            p_km1, p_k, c_km1, c_k = p_k, p_kp1, c_k, c_kp1
        return p_k

    # p_km1 carries x0's values but r's shard_map variance (callers often
    # pass an invariant jnp.zeros_like(b) as x0; the loop carry must match
    # the varying iterates under check_vma)
    p_km1 = jax.tree.map(lambda x, rr: x + 0.0 * rr, x0, r)

    def body(_, carry):
        p_km1, p_k, c_km1, c_k = carry
        c_kp1 = 2.0 * mu * c_k - c_km1
        omega = omegaprod * c_k / c_kp1
        r = tsub(b, mult(p_k))
        z = pc_apply(r)
        # p_kp1 = omega (p_k + scale z - p_km1) + p_km1
        t = taxpy(scale, z, p_k)
        p_kp1 = jax.tree.map(lambda tt, pm: omega * (tt - pm) + pm, t, p_km1)
        return (p_k, p_kp1, c_k, c_kp1)

    one = jnp.ones_like(jnp.asarray(mu))
    # unroll=2: halves the fixed while-iteration overhead without the
    # scheduling regression full unrolling showed on earlier hardware
    _, p_k, _, _ = lax.fori_loop(1, its, body, (p_km1, p_k, one, mu * one),
                                 unroll=2)
    return p_k


# --- GCR ---------------------------------------------------------------------

def make_gcr(mult, pc_apply, restart=30, rtol=1e-2, atol=1e-50,
             max_it=200, dots=None):
    """Jitted KSPGCR: right-preconditioned, unpreconditioned norm,
    truncated restart (gcr.c semantics as in krylov.KSP._solve_gcr).

    dots: optional (dot, bdots) pair from make_dots (distributed layouts).
    Returns solve(b) -> (x, its, rnorm). Zero initial guess."""
    dot, bdots = dots if dots is not None else (tdot, buf_dots)

    def tnorm_(a):
        return jnp.sqrt(dot(a, a))

    def solve(b):
        x = tzeros_like(b)
        r = b
        rnorm0 = tnorm_(r)
        V = buf_alloc(b, restart)
        S = buf_alloc(b, restart)
        target = jnp.maximum(rtol * rnorm0, atol)

        def cond(c):
            return c[0] == RUNNING

        def body(c):
            state, x, r, V, S, nv, its, rnorm = c
            s = pc_apply(r)
            v = mult(s)
            mask = (jnp.arange(restart) < nv).astype(rnorm.dtype)
            beta = bdots(V, v, mask)
            v = buf_comb(V, -beta, v)
            s = buf_comb(S, -beta, s)
            alpha = tnorm_(v)
            safe = jnp.where(alpha == 0.0, 1.0, alpha)
            v = tscale(1.0 / safe, v)
            s = tscale(1.0 / safe, s)
            V = buf_set(V, nv, v)
            S = buf_set(S, nv, s)
            gamma = dot(r, v)
            x = taxpy(gamma, s, x)
            r = taxpy(-gamma, v, r)
            rnorm = tnorm_(r)
            its = its + 1
            nv = jnp.where(nv + 1 >= restart, 0, nv + 1)
            state = jnp.where(rnorm <= target, CONVERGED_RTOL, state)
            state = jnp.where((state == RUNNING) & (its >= max_it),
                              DIVERGED_ITS, state)
            state = jnp.where(alpha == 0.0, DIVERGED_ITS, state)
            return (state, x, r, V, S, nv, its, rnorm)

        state0 = jnp.where(rnorm0 <= atol, CONVERGED_ATOL, RUNNING)
        c = (state0, x, r, V, S, jnp.int32(0), jnp.int32(0), rnorm0)
        state, x, r, V, S, nv, its, rnorm = lax.while_loop(cond, body, c)
        return x, its, rnorm

    return solve


# --- FGMRES -------------------------------------------------------------------

def make_fgmres(mult, pc_apply, restart=30, rtol=1e-5, atol=1e-50,
                dtol=1e4, max_it=10000, hist_len=None, dots=None):
    """Jitted KSPFGMRES: right preconditioning, classical Gram-Schmidt,
    Givens recurrence, unpreconditioned norm, KSPConvergedDefault, restarts
    (fgmres.c semantics as in krylov.KSP._solve_gmres(flexible=True)).

    dots: optional (dot, bdots) pair from make_dots (distributed layouts).
    Returns solve(F, x0) -> (x, its, rnorm, state, hist) where hist is the
    monitor history hist[i] = residual at iteration i (the
    -ksp_monitor_short values), length hist_len (default max_it+1, capped
    entries beyond convergence hold -1)."""
    if hist_len is None:
        hist_len = max_it + 1
    dot, bdots = dots if dots is not None else (tdot, buf_dots)

    def tnorm_(a):
        return jnp.sqrt(dot(a, a))

    k = restart

    def solve(F, x0):
        x = x0
        dtype = jax.tree.leaves(F)[0].dtype
        V = buf_alloc(F, k + 1)
        Z = buf_alloc(F, k)
        H = jnp.zeros((k + 1, k), dtype)
        g = jnp.zeros(k + 1, dtype)
        cs = jnp.zeros(k, dtype)
        sn = jnp.zeros(k, dtype)
        hist = jnp.full((hist_len,), -1.0, dtype)

        def build_soln(x, Z, H, g, it):
            """x + Z y with y from the rotated upper-triangular H[:it,:it]
            (BuildGmresSoln). Padded columns get unit diagonal so the
            full-size triangular solve is exact."""
            colmask = (jnp.arange(k) < it).astype(dtype)
            Hp = H[:k, :] * colmask[None, :] * colmask[:, None] \
                + jnp.diag(1.0 - colmask)
            y = jsla.solve_triangular(Hp, g[:k] * colmask, lower=False)
            return buf_comb(Z, y * colmask, x)

        def cycle_start(c):
            (state, x, V, Z, H, g, cs, sn, it, itc, r0, rnorm, hist) = c
            r = tsub(F, mult(x))
            beta = tnorm_(r)
            rnorm = beta
            hist = hist.at[jnp.minimum(itc, hist_len - 1)].set(rnorm)
            r0 = jnp.where(itc == 0, beta, r0)
            safe = jnp.where(beta == 0.0, 1.0, beta)
            V = buf_set(buf_alloc(F, k + 1), 0, tscale(1.0 / safe, r))
            H = jnp.zeros_like(H)
            g = jnp.zeros_like(g).at[0].set(beta)
            cs = jnp.zeros_like(cs)
            sn = jnp.zeros_like(sn)
            state = jnp.where(beta == 0.0, CONVERGED_ATOL, state)
            state = jnp.where(
                (state == RUNNING) & (rnorm <= jnp.maximum(rtol * r0, atol)),
                jnp.where(rnorm < atol, CONVERGED_ATOL, CONVERGED_RTOL),
                state)
            state = jnp.where((state == RUNNING) & (rnorm > dtol * r0),
                              DIVERGED_DTOL, state)
            return (state, x, V, Z, H, g, cs, sn, jnp.int32(0), itc, r0,
                    rnorm, hist)

        def arnoldi(c):
            (state, x, V, Z, H, g, cs, sn, it, itc, r0, rnorm, hist) = c
            z = pc_apply(buf_get(V, it))
            w = mult(z)
            Z = buf_set(Z, it, z)
            mask = (jnp.arange(k + 1) <= it).astype(dtype)
            h = bdots(V, w, mask)
            w = buf_comb(V, -h, w)
            tt = tnorm_(w)
            # happy breakdown (gmres.c hapbnd: min(|tt/g_it|, haptol))
            git = lax.dynamic_index_in_dim(g, it, keepdims=False)
            hapbnd = jnp.minimum(jnp.abs(tt / jnp.where(git == 0.0, 1.0,
                                                        git)), 1e-30)
            happy = tt <= hapbnd
            safe = jnp.where(tt == 0.0, 1.0, tt)
            V = buf_set(V, it + 1, tscale(1.0 / safe, w))
            hcol = h.at[it + 1].set(tt)
            # apply previous rotations to the new column
            def rot(i, hc):
                t1 = hc[i]
                t2 = hc[i + 1]
                return hc.at[i].set(cs[i] * t1 + sn[i] * t2) \
                         .at[i + 1].set(-sn[i] * t1 + cs[i] * t2)
            hcol = lax.fori_loop(0, it, rot, hcol)
            h_it = lax.dynamic_index_in_dim(hcol, it, keepdims=False)
            h_it1 = lax.dynamic_index_in_dim(hcol, it + 1, keepdims=False)
            delta = jnp.sqrt(h_it * h_it + h_it1 * h_it1)
            safe_d = jnp.where(delta == 0.0, 1.0, delta)
            c_new = h_it / safe_d
            s_new = h_it1 / safe_d
            cs = cs.at[it].set(c_new)
            sn = sn.at[it].set(s_new)
            hcol = hcol.at[it].set(delta).at[it + 1].set(0.0)
            H = lax.dynamic_update_slice(H, hcol[:, None],
                                         (jnp.int32(0), it))
            g_new = -s_new * git
            g = g.at[it].set(c_new * git).at[it + 1].set(g_new)
            res = jnp.abs(g_new)
            it = it + 1
            itc = itc + 1
            rnorm = res
            hist = hist.at[jnp.minimum(itc, hist_len - 1)].set(rnorm)
            state = jnp.where(delta == 0.0, DIVERGED_ITS, state)
            state = jnp.where(
                (state == RUNNING) & (rnorm <= jnp.maximum(rtol * r0, atol)),
                jnp.where(rnorm < atol, CONVERGED_ATOL, CONVERGED_RTOL),
                state)
            state = jnp.where((state == RUNNING) & (rnorm > dtol * r0),
                              DIVERGED_DTOL, state)
            state = jnp.where((state == RUNNING) & happy, CONVERGED_HAPPY,
                              state)
            state = jnp.where((state == RUNNING) & (itc >= max_it),
                              DIVERGED_ITS, state)
            # end of cycle (terminal state or restart): build the solution
            done_or_restart = (state != RUNNING) | (it >= k)
            x = lax.cond(done_or_restart,
                         lambda _: build_soln(x, Z, H, g, it),
                         lambda _: x, None)
            it = jnp.where(done_or_restart, jnp.int32(-1), it)
            return (state, x, V, Z, H, g, cs, sn, it, itc, r0, rnorm, hist)

        def body(c):
            return lax.cond(c[8] < 0, cycle_start, arnoldi, c)

        def cond(c):
            return c[0] == RUNNING

        c0 = (jnp.int32(RUNNING), x, V, Z, H, g, cs, sn, jnp.int32(-1),
              jnp.int32(0), jnp.zeros((), dtype), jnp.zeros((), dtype), hist)
        (state, x, V, Z, H, g, cs, sn, it, itc, r0, rnorm,
         hist) = lax.while_loop(cond, body, c0)
        return x, itc, rnorm, state, hist

    return solve
