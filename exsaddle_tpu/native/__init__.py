"""Native (C++) runtime components, bound via ctypes.

The reference's performance-critical host-side stack is native (ILUPACK
F77, METIS/AMD orderings, UMFPACK -- SURVEY.md section 2.3); this package
holds the equivalents: sequential sparse factorizations that belong next
to, not on, the accelerator compute path. Libraries are compiled on first
use with
the toolchain baked into the image (g++); no pip/pybind11 required."""

import ctypes
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_LIBS = {}


def _load(name):
    if name in _LIBS:
        return _LIBS[name]
    src = os.path.join(_HERE, f"{name}.cpp")
    so = os.path.join(_HERE, f"lib{name}.so")
    if (not os.path.exists(so)
            or os.path.getmtime(so) < os.path.getmtime(src)):
        subprocess.check_call(
            ["g++", "-O3", "-shared", "-fPIC", "-o", so, src])
    lib = ctypes.CDLL(so)
    _LIBS[name] = lib
    return lib


_c_long_p = ctypes.POINTER(ctypes.c_long)
_c_dbl_p = ctypes.POINTER(ctypes.c_double)
_c_char_p = ctypes.POINTER(ctypes.c_char)


def _as_upper_csr_arrays(A_upper_csr):
    A = A_upper_csr.tocsr().sorted_indices()
    Ap = np.ascontiguousarray(A.indptr, dtype=np.int64)
    Aj = np.ascontiguousarray(A.indices, dtype=np.int64)
    Ax = np.ascontiguousarray(A.data, dtype=np.float64)
    return A.shape[0], Ap, Aj, Ax


class ILDLFactor:
    """Incomplete LDL^T of a symmetric matrix given by its upper-triangular
    scipy CSR (diagonal entries present), with drop tolerance. condest > 0
    enables inverse-based dropping (entries kept down to droptol/kappa where
    kappa estimates the growth of L^{-1}, capped at condest)."""

    def __init__(self, A_upper_csr, droptol, condest=-1.0, drop_cap=-1.0):
        lib = _load("ildl")
        lib.ildl_factor2.restype = ctypes.c_int
        n, Ap, Aj, Ax = _as_upper_csr_arrays(A_upper_csr)
        Lp = _c_long_p()
        Li = _c_long_p()
        Lx = _c_dbl_p()
        D = _c_dbl_p()
        nnz = ctypes.c_long()
        rc = lib.ildl_factor2(
            ctypes.c_long(n),
            Ap.ctypes.data_as(_c_long_p), Aj.ctypes.data_as(_c_long_p),
            Ax.ctypes.data_as(_c_dbl_p), ctypes.c_double(droptol),
            ctypes.c_double(condest), ctypes.c_double(drop_cap),
            ctypes.byref(Lp), ctypes.byref(Li), ctypes.byref(Lx),
            ctypes.byref(D), ctypes.byref(nnz))
        if rc != 0:
            raise RuntimeError("ildl_factor failed")
        self._lib = lib
        self.n = n
        self.nnz = int(nnz.value)          # incl. diagonal
        # copy into numpy and free the C buffers
        ln = np.ctypeslib.as_array(Lp, shape=(n + 1,)).copy()
        lnnz = int(ln[-1])
        self.Lp = ln
        self.Li = np.ctypeslib.as_array(Li, shape=(max(lnnz, 1),)).copy()
        self.Lx = np.ctypeslib.as_array(Lx, shape=(max(lnnz, 1),)).copy()
        self.D = np.ctypeslib.as_array(D, shape=(n,)).copy()
        for p in (Lp, Li, Lx, D):
            lib.ildl_free(p)

    def solve(self, b):
        x = np.array(b, dtype=np.float64, copy=True)
        self._lib.ildl_solve(
            ctypes.c_long(self.n),
            self.Lp.ctypes.data_as(_c_long_p),
            self.Li.ctypes.data_as(_c_long_p),
            self.Lx.ctypes.data_as(_c_dbl_p),
            self.D.ctypes.data_as(_c_dbl_p),
            x.ctypes.data_as(_c_dbl_p))
        return x


class _MLLevel:
    __slots__ = ("n", "nsplit", "perm", "iperm", "Lp", "Li", "Lx", "D",
                 "nnz")


class MultilevelILDLFactor:
    """Multilevel incomplete LDL^T: condest-driven pivot rejection with
    Schur-complement recursion -- the semantics of ILUPACK's AMGfactor
    (pcilupack.c:29-176: droptol for the factors, condest bounding the
    inverse growth per level, droptolS for the coarse Schur systems).

    Per level, two native passes: a TRIAL factorization discovers which
    pivots are safe under the condest bound, then the rejected unknowns are
    permuted last and a SPLIT factorization eliminates the safe block and
    forms the approximate Schur complement, which becomes the next level.
    Recursion stops when nothing is rejected or the Schur system is small;
    a droptol-0 factorization (a direct LDL^T) finishes the job."""

    def __init__(self, A_upper_csr, droptol, condest=100.0, droptolS=None,
                 drop_cap=5.0, max_levels=20, nmin=16):
        import scipy.sparse as sp
        lib = _load("ildl")
        lib.ildl_factor_trial.restype = ctypes.c_int
        lib.ildl_factor_split.restype = ctypes.c_int
        self._lib = lib
        if droptolS is None:
            droptolS = droptol
        self.levels = []
        A = A_upper_csr.tocsr()
        total_nnz = 0
        for _ in range(max_levels):
            n = A.shape[0]
            if n <= nmin:
                break
            _, Ap, Aj, Ax = _as_upper_csr_arrays(A)
            rej = _c_char_p()
            nreject = ctypes.c_long()
            rc = lib.ildl_factor_trial(
                ctypes.c_long(n),
                Ap.ctypes.data_as(_c_long_p), Aj.ctypes.data_as(_c_long_p),
                Ax.ctypes.data_as(_c_dbl_p),
                ctypes.c_double(droptol), ctypes.c_double(condest),
                ctypes.c_double(drop_cap),
                ctypes.byref(rej), ctypes.byref(nreject))
            if rc != 0:
                raise RuntimeError("ildl_factor_trial failed")
            rj = np.frombuffer(
                ctypes.string_at(rej, n), dtype=np.int8).copy()
            lib.ildl_free(rej)
            nc = int(nreject.value)
            nsplit = n - nc
            perm = np.concatenate([np.nonzero(rj == 0)[0],
                                   np.nonzero(rj)[0]]).astype(np.int64)
            # symmetric permutation, rejected last, back to upper CSR
            Afull = A + sp.triu(A, 1).T
            Pm = Afull[perm][:, perm]
            Aperm = sp.triu(Pm).tocsr()
            _, Ap, Aj, Ax = _as_upper_csr_arrays(Aperm)
            Lp = _c_long_p(); Li = _c_long_p(); Lx = _c_dbl_p()
            D = _c_dbl_p()
            Sp = _c_long_p(); Sj = _c_long_p(); Sx = _c_dbl_p()
            nnz = ctypes.c_long()
            rc = lib.ildl_factor_split(
                ctypes.c_long(n),
                Ap.ctypes.data_as(_c_long_p), Aj.ctypes.data_as(_c_long_p),
                Ax.ctypes.data_as(_c_dbl_p),
                ctypes.c_double(droptol), ctypes.c_double(condest),
                ctypes.c_double(drop_cap),
                ctypes.c_double(droptolS), ctypes.c_long(nsplit),
                ctypes.byref(Lp), ctypes.byref(Li), ctypes.byref(Lx),
                ctypes.byref(D), ctypes.byref(nnz),
                ctypes.byref(Sp), ctypes.byref(Sj), ctypes.byref(Sx))
            if rc != 0:
                raise RuntimeError("ildl_factor_split failed")
            lv = _MLLevel()
            lv.n = n
            lv.nsplit = nsplit
            lv.perm = perm
            lv.iperm = np.empty(n, dtype=np.int64)
            lv.iperm[perm] = np.arange(n)
            ln = np.ctypeslib.as_array(Lp, shape=(n + 1,)).copy()
            lnnz = int(ln[-1])
            lv.Lp = ln
            lv.Li = np.ctypeslib.as_array(Li, shape=(max(lnnz, 1),)).copy()
            lv.Lx = np.ctypeslib.as_array(Lx, shape=(max(lnnz, 1),)).copy()
            lv.D = np.ctypeslib.as_array(D, shape=(n,)).copy()
            lv.nnz = int(nnz.value)
            total_nnz += lv.nnz
            spv = np.ctypeslib.as_array(Sp, shape=(nc + 1,)).copy()
            snnz = int(spv[-1]) if nc > 0 else 0
            sjv = np.ctypeslib.as_array(Sj, shape=(max(snnz, 1),)).copy()
            sxv = np.ctypeslib.as_array(Sx, shape=(max(snnz, 1),)).copy()
            for p in (Lp, Li, Lx, D, Sp, Sj, Sx):
                lib.ildl_free(p)
            self.levels.append(lv)
            if nc == 0:
                A = None
                break
            A = sp.csr_matrix((sxv[:snnz], sjv[:snnz], spv), shape=(nc, nc))
        # terminal level: droptol-0 plain factorization = direct LDL^T
        self.coarse = None
        if A is not None and A.shape[0] > 0:
            self.coarse = ILDLFactor(A, droptol=0.0)
            total_nnz += self.coarse.nnz
        self.n = self.levels[0].n if self.levels else (
            self.coarse.n if self.coarse else 0)
        self.nnz = total_nnz
        self.nlevels = len(self.levels) + (1 if self.coarse is not None
                                           else 0)

    def storage_bytes(self):
        """Measured memory held by the preconditioner: every per-level
        array (factor values + index arrays + diagonals + permutations),
        the basis of the honest 'final elbow space factor' report
        (pcilupack.c:169 prints ILUPACK's used-elbow, i.e. memory consumed
        relative to nnz(A))."""
        total = 0
        for lv in self.levels:
            for name in ("Lp", "Li", "Lx", "D", "perm", "iperm"):
                a = getattr(lv, name, None)
                if a is not None:
                    total += np.asarray(a).nbytes
        if self.coarse is not None:
            for name in ("Lp", "Li", "Lx", "D"):
                total += np.asarray(getattr(self.coarse, name)).nbytes
        return total

    def _solve_level(self, k, b):
        if k >= len(self.levels):
            return self.coarse.solve(b) if self.coarse is not None else b
        lv = self.levels[k]
        x = np.asarray(b, dtype=np.float64)[lv.perm]
        self._lib.ildl_split_fwd(
            ctypes.c_long(lv.n), ctypes.c_long(lv.nsplit),
            lv.Lp.ctypes.data_as(_c_long_p),
            lv.Li.ctypes.data_as(_c_long_p),
            lv.Lx.ctypes.data_as(_c_dbl_p),
            lv.D.ctypes.data_as(_c_dbl_p),
            x.ctypes.data_as(_c_dbl_p))
        if lv.nsplit < lv.n:
            x[lv.nsplit:] = self._solve_level(k + 1, x[lv.nsplit:])
        self._lib.ildl_split_bwd(
            ctypes.c_long(lv.n), ctypes.c_long(lv.nsplit),
            lv.Lp.ctypes.data_as(_c_long_p),
            lv.Li.ctypes.data_as(_c_long_p),
            lv.Lx.ctypes.data_as(_c_dbl_p),
            x.ctypes.data_as(_c_dbl_p))
        return x[lv.iperm]

    def solve(self, b):
        return self._solve_level(0, b)


def _sym_adjacency(A_csr):
    """Full symmetric pattern CSR (int64) of A + A^T, no self loops."""
    import scipy.sparse as sp
    A = A_csr.tocsr()
    S = (A + A.T).tocsr().sorted_indices()
    S.setdiag(0)
    S.eliminate_zeros()
    Ap = np.ascontiguousarray(S.indptr, dtype=np.int64)
    Aj = np.ascontiguousarray(S.indices, dtype=np.int64)
    return S.shape[0], Ap, Aj, S


def amd_order(A_csr):
    """Approximate Minimum Degree ordering (native/order.cpp: quotient
    graph, element absorption, approximate external degrees, supervariable
    coalescing -- the AMD the reference links via SuiteSparse,
    Makefile:32)."""
    lib = _load("order")
    lib.amd_order.restype = ctypes.c_int
    n, Ap, Aj, _ = _sym_adjacency(A_csr)
    perm = np.empty(n, dtype=np.int64)
    rc = lib.amd_order(ctypes.c_long(n),
                       Ap.ctypes.data_as(_c_long_p),
                       Aj.ctypes.data_as(_c_long_p),
                       perm.ctypes.data_as(_c_long_p))
    if rc != 0:
        raise RuntimeError("amd_order failed")
    return perm


def nd_order(A_csr, leaf=64):
    """Nested-dissection ordering (native/order.cpp: recursive level-set
    bisection, pseudo-peripheral roots, separators last, minimum-degree
    leaves) -- the METIS_NodeND class the reference's 'metisn' default
    uses (pcildl.c:480-482)."""
    lib = _load("order")
    lib.nd_order.restype = ctypes.c_int
    n, Ap, Aj, _ = _sym_adjacency(A_csr)
    perm = np.empty(n, dtype=np.int64)
    rc = lib.nd_order(ctypes.c_long(n),
                      Ap.ctypes.data_as(_c_long_p),
                      Aj.ctypes.data_as(_c_long_p),
                      perm.ctypes.data_as(_c_long_p),
                      ctypes.c_long(leaf))
    if rc != 0:
        raise RuntimeError("nd_order failed")
    return perm


def mc64_scaling(A_csr):
    """Maximum-product matching scalings (MC64 job=5 semantics,
    native/order.cpp): row/column scalings that make every matched entry
    of |D_r A D_c| equal 1 and all others <= 1. Returns (sr, sc, match).
    The symmetrized scaling sqrt(sr*sc) is what ILUPACK applies before
    its symmetric factorizations (pcildl.c:147-193)."""
    lib = _load("order")
    lib.mc64_scale.restype = ctypes.c_int
    A = A_csr.tocsr().sorted_indices()
    n = A.shape[0]
    Ap = np.ascontiguousarray(A.indptr, dtype=np.int64)
    Aj = np.ascontiguousarray(A.indices, dtype=np.int64)
    Ax = np.ascontiguousarray(A.data, dtype=np.float64)
    sr = np.empty(n)
    sc = np.empty(n)
    match = np.empty(n, dtype=np.int64)
    rc = lib.mc64_scale(ctypes.c_long(n),
                        Ap.ctypes.data_as(_c_long_p),
                        Aj.ctypes.data_as(_c_long_p),
                        Ax.ctypes.data_as(_c_dbl_p),
                        sr.ctypes.data_as(_c_dbl_p),
                        sc.ctypes.data_as(_c_dbl_p),
                        match.ctypes.data_as(_c_long_p))
    if rc != 0:
        raise RuntimeError("mc64: structurally singular matrix")
    return sr, sc, match


class ILU0Factor:
    """ILU(0) on the original CSR pattern, natural ordering (PETSc PCILU
    defaults). Factorization and triangular solves run in native C++
    (exsaddle_tpu/native/ilu0.cpp)."""

    def __init__(self, A_csr):
        lib = _load("ilu0")
        lib.ilu0_factor.restype = ctypes.c_long
        A = A_csr.tocsr().sorted_indices()
        self.n = A.shape[0]
        self.Ap = np.ascontiguousarray(A.indptr, dtype=np.int64)
        self.Aj = np.ascontiguousarray(A.indices, dtype=np.int64)
        self.Ax = np.ascontiguousarray(A.data, dtype=np.float64).copy()
        rc = lib.ilu0_factor(
            ctypes.c_long(self.n),
            self.Ap.ctypes.data_as(_c_long_p),
            self.Aj.ctypes.data_as(_c_long_p),
            self.Ax.ctypes.data_as(_c_dbl_p))
        if rc >= 0:
            raise ZeroDivisionError(f"ILU(0) zero pivot at row {rc}")
        self._lib = lib

    def solve(self, b):
        x = np.array(b, dtype=np.float64, copy=True)
        self._lib.ilu0_solve(
            ctypes.c_long(self.n),
            self.Ap.ctypes.data_as(_c_long_p),
            self.Aj.ctypes.data_as(_c_long_p),
            self.Ax.ctypes.data_as(_c_dbl_p),
            x.ctypes.data_as(_c_dbl_p))
        return x
