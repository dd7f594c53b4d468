"""Correctness of the fast-apply paths against the element-batched
reference operator: grid_ops strided apply, matrix-free factored apply,
parity-layout apply, assembled-nnz model, and the compiled (fully-jitted)
FGMRES path vs the host-orchestrated KSP."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from exsaddle_tpu import models as emodels, driver
from exsaddle_tpu.assembly import FESpace, assemble_element_matrices
from exsaddle_tpu.mesh import SaddleMesh
from exsaddle_tpu.operator import apply_dirichlet_elimination
from exsaddle_tpu.options import Options
from exsaddle_tpu.grid_ops import GridSaddleOperator
from exsaddle_tpu.matfree import (MatFreeSaddleOperator,
                                  ParityMatFreeOperator,
                                  parity_permutation, assembled_nnz)


def _build(nd, m_el, lame=False, model="0", size=None):
    opts = Options.from_args(["-model", model])
    ctx = emodels.ModelContext(opts, nd, lame=lame, log=lambda *a, **k: None)
    mesh = SaddleMesh(nd, m_el, size or (1.0,) * nd)
    fes = FESpace(mesh)
    bci, bcv = emodels.create_bc_list(ctx, mesh)
    c = emodels.evaluate_coefficients(
        ctx, fes.qp_coords.reshape(-1, nd)).reshape(mesh.nel, fes.nqp, -1)
    coeff = driver._qp_dict(ctx, c)
    elm = assemble_element_matrices(fes, coeff, lame=lame)
    op, rhs, bc_mask, xbc = apply_dirichlet_elimination(mesh, elm, bci, bcv)
    return mesh, fes, coeff, op, bc_mask


CASES = [(2, (5, 4), False, "0", None),
         (3, (3, 4, 2), False, "11", (0.1, 1.0, 1.0)),
         (2, (4, 4), True, "6", None),
         (3, (3, 3, 3), True, "6", None),
         (2, (1, 1), False, "0", None)]


@pytest.mark.parametrize("nd,m_el,lame,model,size", CASES)
def test_grid_and_matfree_match_element_apply(nd, m_el, lame, model, size):
    mesh, fes, coeff, op, bc_mask = _build(nd, m_el, lame, model, size)
    x = jnp.asarray(np.random.default_rng(0).standard_normal(mesh.ndof))
    y_ref = np.asarray(op.mult(x))
    scale = np.abs(y_ref).max()

    gop = GridSaddleOperator.from_operator(mesh, op)
    assert np.abs(np.asarray(gop.mult(x)) - y_ref).max() < 1e-12 * scale

    mf = MatFreeSaddleOperator.build(mesh, fes, coeff, bc_mask, lame=lame,
                                     dtype=jnp.float64)
    assert np.abs(np.asarray(mf.mult(x)) - y_ref).max() < 1e-12 * scale

    pop = ParityMatFreeOperator.build(mesh, fes, coeff, bc_mask, lame=lame,
                                      dtype=jnp.float64)
    perm, iperm = parity_permutation(mesh)
    y_par = np.asarray(pop.mult(jnp.asarray(np.asarray(x)[perm])))[iperm]
    assert np.abs(y_par - y_ref).max() < 1e-12 * scale


@pytest.mark.parametrize("nd,m_el", [(2, (3, 2)), (2, (4, 4)), (3, (2, 3, 2))])
def test_assembled_nnz_model_exact(nd, m_el):
    mesh, fes, coeff, op, bc_mask = _build(nd, m_el)
    assert assembled_nnz(mesh) == op.to_csr().nnz


def test_compiled_fgmres_matches_host_ksp():
    from exsaddle_tpu.compiled import make_fgmres_cycle
    from exsaddle_tpu.krylov import KSPConfig, KSP
    from exsaddle_tpu import precond

    mesh, fes, coeff, op, bc_mask = _build(3, (3, 3, 3), False, "11",
                                           (0.1, 1.0, 1.0))
    F = jnp.asarray(np.random.default_rng(2).standard_normal(mesh.ndof))
    d = np.asarray(op.diagonal())
    inv = jnp.asarray(1.0 / np.where(d == 0.0, 1.0, d))
    cycle = jax.jit(make_fgmres_cycle(op.mult, lambda v: inv * v, 20))
    _, rn = cycle(F, jnp.zeros_like(F))

    hist = []
    cfg = KSPConfig(type="fgmres", restart=20, max_it=20,
                    convergence_test="skip",
                    monitor=lambda i, r: hist.append(r))
    ksp = KSP(op.mult, pc=precond.PCJacobi(d), cfg=cfg)
    ksp.solve(F)
    assert abs(hist[-1] - float(rn)) / hist[-1] < 1e-8


@pytest.mark.slow
def test_entry_and_dryrun():
    import __graft_entry__ as g
    fn, args = g.entry()
    x, rnorm = jax.jit(fn)(*args)
    assert np.isfinite(float(rnorm))
    g.dryrun_multichip(4)


@pytest.mark.parametrize("nd,m_el,lame,model,size", CASES)
def test_tree_apply_matches_flat(nd, m_el, lame, model, size):
    from exsaddle_tpu.matfree import (tree_aux, to_tree, from_tree,
                                      mult_tree, tree_norm)
    mesh, fes, coeff, op, bc_mask = _build(nd, m_el, lame, model, size)
    pop = ParityMatFreeOperator.build(mesh, fes, coeff, bc_mask, lame=lame,
                                      dtype=jnp.float64)
    x = jnp.asarray(np.random.default_rng(3).standard_normal(mesh.ndof))
    y_flat = np.asarray(pop.mult(x))
    tree = to_tree(pop, x)
    y_tree = np.asarray(from_tree(mult_tree(pop, tree_aux(pop), tree)))
    assert np.abs(y_tree - y_flat).max() < 1e-13 * np.abs(y_flat).max()
    assert abs(float(tree_norm(to_tree(pop, x)))
               - float(jnp.linalg.norm(x))) < 1e-12


def test_tree_fgmres_matches_host_ksp():
    from exsaddle_tpu.compiled import make_fgmres_cycle_tree
    from exsaddle_tpu.matfree import tree_aux, to_tree
    from exsaddle_tpu.krylov import KSPConfig, KSP
    from exsaddle_tpu import precond
    import __graft_entry__ as g

    mesh, pop, Fp, diag = g._build_flagship_parity(mx=4, dtype=jnp.float64)
    inv = 1.0 / jnp.where(diag == 0.0, 1.0, diag)
    cyc = jax.jit(make_fgmres_cycle_tree(15))
    xt, rn = cyc(pop, tree_aux(pop), to_tree(pop, inv), to_tree(pop, Fp),
                 to_tree(pop, jnp.zeros_like(Fp)))

    hist = []
    cfg = KSPConfig(type="fgmres", restart=15, max_it=15,
                    convergence_test="skip",
                    monitor=lambda i, r: hist.append(r))
    KSP(pop.mult, pc=precond.PCJacobi(np.asarray(diag)), cfg=cfg).solve(Fp)
    assert abs(hist[-1] - float(rn)) / hist[-1] < 1e-8
