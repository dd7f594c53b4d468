"""Fully-jitted fixed-iteration Krylov paths for accelerator execution.

The host-orchestrated solvers in krylov.py reproduce PETSc's adaptive
control flow (convergence tests, restarts) for regression parity; this
module provides the performance path: whole solver iterations traced once
under `jax.jit` with `lax.fori_loop` / static unrolling, no host scalar
pulls, suitable for single-chip benchmarking and for sharded execution
over a device mesh (exsaddle_tpu/parallel).

Algorithms mirror the reference's solver configuration (abf.opts,
exSaddle.c:303-422): FGMRES with classical Gram-Schmidt and right
preconditioning, and Chebyshev smoothing iterations.

Every float32 matrix product here runs at "float32" matmul precision: on
the GPU a float32 dot with no stated precision runs in TF32, whose ~1e-3
relative error would perturb the Krylov recurrences.
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax


def make_fgmres_cycle(mult, pc_apply, k):
    """Return a jittable `cycle(F, x0) -> (x, rnorm)` performing one
    FGMRES(k) cycle with right preconditioning and classical Gram-Schmidt
    (the KSPFGMRES configuration the reference drives, exSaddle.c:405 +
    abf.opts:2).

    mult:     x -> A x
    pc_apply: x -> M^{-1} x
    k:        fixed iteration count (the restart length; no convergence
              test -- this is the benchmarking/compiled path).
    """

    def cycle(F, x0):
        with jax.default_matmul_precision("float32"):
            return _cycle(F, x0)

    def _cycle(F, x0):
        n = F.shape[0]
        dtype = F.dtype
        r0 = F - mult(x0)
        beta = jnp.linalg.norm(r0)
        V = jnp.zeros((k + 1, n), dtype).at[0].set(
            r0 / jnp.where(beta == 0.0, 1.0, beta))
        Z = jnp.zeros((k, n), dtype)
        H = jnp.zeros((k + 1, k), dtype)

        def body(j, carry):
            V, Z, H = carry
            z = pc_apply(V[j])
            w = mult(z)
            # classical (unmodified) Gram-Schmidt: one pass of dots, then
            # one fused subtraction -- two matrix-vector products.
            mask = (jnp.arange(k + 1) <= j).astype(dtype)
            h = (V @ w) * mask                     # (k+1,)
            w = w - h @ V
            hj1 = jnp.linalg.norm(w)
            V = V.at[j + 1].set(w / jnp.where(hj1 == 0.0, 1.0, hj1))
            Z = Z.at[j].set(z)
            H = H.at[:, j].set(h.at[j + 1].set(hj1))
            return (V, Z, H)

        V, Z, H = lax.fori_loop(0, k, body, (V, Z, H))

        # least-squares solve of min || beta e1 - H y || via normal
        # equations on the small (k+1, k) Hessenberg system (k is tiny;
        # dense QR/lstsq of a k x k system is negligible)
        e1 = jnp.zeros(k + 1, dtype).at[0].set(beta)
        y = jnp.linalg.lstsq(H, e1)[0]
        x = x0 + y @ Z
        rnorm = jnp.linalg.norm(F - mult(x))
        return x, rnorm

    return cycle


def make_fgmres(mult, pc_apply, k, ncycles):
    """Fixed-work FGMRES: `solve(F, x0) -> (x, rnorm)` running `ncycles`
    restarted FGMRES(k) cycles, fully traceable."""
    cycle = make_fgmres_cycle(mult, pc_apply, k)

    def solve(F, x0):
        def body(_, carry):
            x, _ = carry
            return cycle(F, x)
        return lax.fori_loop(0, ncycles, body,
                             (x0, jnp.array(0.0, F.dtype)))

    return solve


def make_chebyshev(mult, pc_apply, emin, emax, its):
    """Jittable Chebyshev(its) smoother `smooth(b, x0) -> x` over the
    interval [emin, emax] (KSPCHEBYSHEV as configured by abf.opts:8-12)."""
    theta = 0.5 * (emax + emin)
    delta = 0.5 * (emax - emin)

    def smooth(b, x0):
        with jax.default_matmul_precision("float32"):
            return _smooth(b, x0)

    def _smooth(b, x0):
        r = b - mult(x0)
        d = pc_apply(r) / theta
        x = x0 + d
        alpha = theta

        def body(_, carry):
            x, d, alpha = carry
            r = b - mult(x)
            beta = (delta / 2.0) ** 2 / alpha
            alpha = theta - beta
            d = (pc_apply(r) + beta * d) / alpha
            return (x + d, d, alpha)

        x, _, _ = lax.fori_loop(1, its, body, (x, d, alpha))
        return x

    return smooth


def make_fgmres_cycle_tree(k):
    """Tree-form FGMRES(k) cycle: `cycle(op, aux, inv_diag_tree, F_tree,
    x0_tree) -> (x_tree, rnorm)`.

    Same algorithm as make_fgmres_cycle but with vectors kept as parity
    subgrid pytrees end to end (matfree.mult_tree) -- the fast production
    path: flat (ndof,) vectors pay grid<->1D relayouts each iteration.
    Pass op/aux/inv_diag as jit ARGUMENTS."""
    from exsaddle_tpu.matfree import mult_tree, tree_dot, tree_norm

    def tmap(f, *ts):
        return jax.tree.map(f, *ts)

    def cycle(op, aux, inv_diag, F, x0):
        with jax.default_matmul_precision("float32"):
            return _cycle(op, aux, inv_diag, F, x0)

    def _cycle(op, aux, inv_diag, F, x0):
        mult = lambda t: mult_tree(op, aux, t)
        pc = lambda t: tmap(jnp.multiply, inv_diag, t)
        dtype = F[1].dtype

        r0 = tmap(jnp.subtract, F, mult(x0))
        beta = tree_norm(r0)
        safe = jnp.where(beta == 0.0, 1.0, beta)
        V = [tmap(lambda a: a / safe, r0)]
        Z = []
        H = jnp.zeros((k + 1, k), dtype)
        for j in range(k):                      # static unroll
            z = pc(V[j])
            w = mult(z)
            hs = [tree_dot(V[i], w) for i in range(j + 1)]
            for i in range(j + 1):
                w = tmap(lambda a, b: a - hs[i] * b, w, V[i])
            hj1 = tree_norm(w)
            H = H.at[: j + 1, j].set(jnp.stack(hs)).at[j + 1, j].set(hj1)
            safe1 = jnp.where(hj1 == 0.0, 1.0, hj1)
            V.append(tmap(lambda a: a / safe1, w))
            Z.append(z)
        e1 = jnp.zeros(k + 1, dtype).at[0].set(beta)
        y = jnp.linalg.lstsq(H, e1)[0]
        x = x0
        for j in range(k):
            x = tmap(lambda a, b: a + y[j] * b, x, Z[j])
        rnorm = tree_norm(tmap(jnp.subtract, F, mult(x)))
        return x, rnorm

    return cycle
