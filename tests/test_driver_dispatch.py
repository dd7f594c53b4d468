"""One-binary dispatch: the same options tree reaches either the
host-orchestrated KSP stack (-jit 0 / CPU default) or the fully-jitted
ABFSolver (-jit 1 / accelerator default), like the reference's single
executable (exSaddle.c:124-566).

The jitted p-block is the Chebyshev stand-in for serial bjacobi+ILU(0),
so histories are equivalent-quality, not bit-identical: the
PC-independent initial residual must agree to monitor precision,
iteration counts within 1, and solution diagnostics to the outer rtol."""

import os
import re

import numpy as np
import pytest

from exsaddle_tpu.options import Options
from exsaddle_tpu.driver import saddle_solve, _abf_options_match

ABF_OPTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "abf.opts")
ARGS = ["-options_file", ABF_OPTS] + (
    "-model 11 -size_x 0.1 -mx 6 -saddle_ksp_monitor_short "
    "-saddle_ksp_converged_reason -diagnostics").split()


def _run(jit):
    lines = []
    opts = Options.from_args(ARGS + ["-jit", jit])
    r = saddle_solve(opts, 3,
                     log=lambda *a: lines.append(
                         " ".join(str(x) for x in a)))
    return lines, r


def test_abf_options_match():
    assert _abf_options_match(Options.from_args(ARGS))
    # a non-ABF tree must not dispatch
    assert not _abf_options_match(Options.from_args(["-mx", "4"]))
    assert not _abf_options_match(Options.from_args(["-fs"]))


def test_dispatch_host_vs_jitted_parity():
    lines0, r0 = _run("0")
    lines1, r1 = _run("1")

    def monitor0(lines):
        for ln in lines:
            m = re.match(r"\s*0 KSP Residual norm ([\d.e+-]+)", ln)
            if m:
                return m.group(1)
        raise AssertionError("no monitor line")

    # PC-independent initial residual: identical to monitor precision
    assert monitor0(lines0) == monitor0(lines1)
    # converged, within one iteration of each other
    assert "CONVERGED_RTOL" in str(r0["result"].reason)
    assert "CONVERGED_RTOL" in str(r1["result"].reason)
    assert abs(r0["result"].its - r1["result"].its) <= 1
    # same converged-reason line format
    assert any(ln.startswith("Linear saddle_ solve converged due to")
               for ln in lines1)
    # solutions agree to the outer tolerance
    X0 = np.asarray(r0["X"])
    X1 = np.asarray(r1["X"])
    assert (np.linalg.norm(X0 - X1) / np.linalg.norm(X0)) < 1e-3


@pytest.mark.parametrize("flags,mode", [
    (["-jit", "1", "-ir"], "ir"),
    (["-jit", "0", "-ir"], None),
    (["-ir"], None),            # CPU backend: host stack by default
])
def test_jit_flag_dispatch(flags, mode):
    """The committed abf.opts reaches the jitted refinement solver under
    -jit 1, and the host KSP stack under -jit 0 or by default on CPU. An
    odd element count does not split over the 8 virtual devices, so the
    jitted run stays on one device (two velocity-MG levels: an odd grid
    coarsens once)."""
    opts = Options.from_args(
        ["-options_file", ABF_OPTS, "-model", "11", "-size_x", "0.1",
         "-mx", "3", "-saddle_fieldsplit_u_pc_mg_levels", "2"] + flags)
    r = saddle_solve(opts, 3, log=lambda *a: None)
    assert getattr(r["ksp"], "_mode", None) == mode
    assert "CONVERGED" in str(r["result"].reason)
