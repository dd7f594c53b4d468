"""exsaddle_tpu: a JAX/XLA saddle-point solver framework for the GPU.

A from-scratch rebuild of the capabilities of psanan/exsaddle (C/PETSc/MPI):
Q2-Q1 (Taylor-Hood) mixed finite elements for variable-viscosity Stokes and
mixed-form linear elasticity (Lame) on structured box meshes, with a composable
Krylov/preconditioner stack (FGMRES/GMRES/GCR/Chebyshev x Jacobi/ILU/
fieldsplit-Schur/multigrid/ASM/LU) designed for array hardware:

  - element-batched dense matrix representation of operators: SpMV is a batched
    (nel, ndof_el, ndof_el) x (nel, ndof_el) matmul plus gather/segment-sum
    scatter, instead of a CSR translation of PETSc AIJ; the production solver
    goes further and applies the factored operator matrix-free (matfree.py);
  - functional, jit-compatible Krylov loops (lax.while_loop / lax.scan);
  - SPMD distribution via jax.sharding.Mesh + shard_map with halo exchange
    (parallel/), instead of MPI/VecScatter;
  - float64 regression path on CPU that reproduces the reference's testref/
    solver behavior; on the GPU a float32 solver (full-FP32 matmuls) inside
    float64 iterative refinement.

Reference layer map: SURVEY.md in the repository root.
"""

__version__ = "0.1.0"

from exsaddle_tpu.mesh import SaddleMesh
from exsaddle_tpu.operator import SaddleOperator

__all__ = ["SaddleMesh", "SaddleOperator"]
