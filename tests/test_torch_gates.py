"""The options92 gate through the port, on the CPU.

examples/eigenmode1d (the options92-class workload: a k0 = 4
eigenmode grows, saturates into 4 peaks, and the adaptive stepper
reaches h = dt_max) with its PETSc block, whose '-ksp_type preonly
-pc_type lu' routes both packages onto the banded exact tier:

- the first 40 steps through each package's library flow (Parser ->
  SolutionParameters -> decode_numerics -> route_petsc_direct ->
  Solver): the start bit for bit, k and failures equal, t and h to
  1e-8 relative, u to 1e-8 of max|u| (the adaptive bound of
  tests/test_torch_host_solver.py), and after 2 steps to 1e-12.  One exact step agrees to about
  1e-14 of max|u|; the controller's error norm, a difference of close
  stage solutions, carries that into h at about 1e-8 from the first
  rejection on, and the growing eigenmode carries h into u;
- the whole gate cut to tmax = 2e4 (as tests/test_gates.py:40 cuts
  it) through ``python -m ksfd_tpu_torch``, with that test's
  signature.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import h5py
import jax.numpy as jnp
import numpy as np
import pytest

import ksfd_tpu as KJ
from ksfd_tpu.ic import initial_values as jinitial_values
from ksfd_tpu.ops import PDEOperators as JPDEOperators
from ksfd_tpu.solvers import Solver as JSolver
from ksfd_tpu.solvers import route_petsc_direct as jroute
from ksfd_tpu_torch import Grid, SolutionParameters
from ksfd_tpu_torch import ksfdsolver as tks
from ksfd_tpu_torch.ic import initial_values
from ksfd_tpu_torch.ops import PDEOperators
from ksfd_tpu_torch.solvers import Solver
from ksfd_tpu_torch.solvers.solver import route_petsc_direct
from ksfd_tpu_torch.utils.cli import decode_numerics

REPO = Path(__file__).resolve().parents[1]
HEAD_STEPS = 40
ADAPT_REL = 1e-8


def _reference_driver():
    spec = importlib.util.spec_from_file_location(
        "ksfd_reference_driver", REPO / "ksfdsolver.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def grid_kw(ps):
    return dict(dim=ps.dim, dof=ps.nligands + 1, width=ps.width,
                height=ps.height, depth=ps.depth, nx=ps.nwidth,
                ny=ps.nheight, nz=ps.ndepth, order=ps.degree)


def solver_kw(ps, t):
    p0 = ps.params0
    return dict(t0=t, dt=float(p0["dt"]), tmax=float(p0["tmax"]),
                maxsteps=int(p0["maxsteps"]), rtol=float(p0["rtol"]),
                atol=float(p0["atol"]))


def cut_example(tmp_path, **lines):
    """examples/eigenmode1d with the parameter lines ``lines`` in place
    of the file's: '@<path>'."""
    src = (REPO / "examples" / "eigenmode1d").read_text().splitlines()
    src = [ln for ln in src if ln.split("=", 1)[0] not in lines]
    path = tmp_path / "eigenmode1d"
    path.write_text("\n".join(src + ["%s=%s" % kv for kv in lines.items()])
                    + "\n")
    return "@" + str(path)


#: steps of the head-to-head, and the bound on u relative to max|u|:
#: before the first rejection the exact steps agree to 1e-12
HEAD = {2: 1e-12, HEAD_STEPS: ADAPT_REL}


@pytest.mark.parametrize("steps", sorted(HEAD))
def test_eigenmode1d_head_to_head(tmp_path, steps):
    argv = [cut_example(tmp_path, maxsteps=steps)]
    jd = _reference_driver()
    jcl = jd.parse_commandline(argv)
    jps = KJ.SolutionParameters(jcl)
    jgrid = KJ.Grid(**grid_kw(jps))
    jnm = jroute(KJ.decode_numerics(jcl.numerics, petsc_tokens=jcl.petsc),
                 jgrid)
    ju0, jt, _ = jinitial_values(jcl, jgrid, jps)
    jops = JPDEOperators(jps, jgrid,
                         sources=jd.decode_sources(jcl.source, jps, jgrid))
    ref = JSolver(jops, jnm, **solver_kw(jps, jt))
    ref_u = np.asarray(ref.solve(jnp.asarray(ju0), t=jt))

    cl = tks.parse_commandline(argv)
    ps = SolutionParameters(cl)
    grid = Grid(**grid_kw(ps))
    nm = route_petsc_direct(decode_numerics(cl.numerics,
                                            petsc_tokens=cl.petsc), grid)
    u0, t, _ = initial_values(cl, grid, ps, device="cpu")
    ops = PDEOperators(ps, grid, sources=tks.decode_sources(
        cl.source, ps, grid, device="cpu"), device="cpu")
    s = Solver(ops, nm, rng_state=cl.seed, **solver_kw(ps, t))
    u = s.solve(u0, t=t).numpy()

    assert nm.ksp_type == jnm.ksp_type == "banded"
    assert nm.asdict() == jnm.asdict()
    np.testing.assert_array_equal(u0.numpy(), np.asarray(ju0))
    assert s.k == ref.k == steps
    assert s.snes_failures == ref.snes_failures
    assert abs(s.t - float(ref.t)) <= ADAPT_REL * abs(float(ref.t))
    assert abs(s.h - float(ref.h)) <= ADAPT_REL * abs(float(ref.h))
    np.testing.assert_allclose(u, ref_u, rtol=0,
                               atol=HEAD[steps] * np.abs(ref_u).max())


def count_peaks(rho):
    above = rho > rho.mean()
    edges = np.diff(np.r_[above, above[0]].astype(int))
    return int((edges == 1).sum())


def test_options92_gate_through_the_port_cli(tmp_path):
    """tests/test_gates.py:40's signature: 100 <= k <= 500, the last
    step longer than 2000, 4 peaks, min rho in (200, 600), max rho in
    (20000, 28000), ligands positive."""
    save = str(tmp_path / "gate")
    env = dict(os.environ, KSFD_PLATFORM="cpu")
    res = subprocess.run(
        [sys.executable, "-m", "ksfd_tpu_torch",
         cut_example(tmp_path, tmax=20000),
         "--save=" + save], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "solve failures" in res.stdout
    assert "routed to the exact direct tier: -ksp_type banded" in res.stderr
    with h5py.File(save + "s1r0.h5", "r") as f:
        ks = sorted(int(k[4:]) for k in f if k.startswith("data"))
        assert 100 <= ks[-1] <= 500, ks[-1]
        last = f["data%d" % ks[-1]]
        tfinal = float(last.attrs["t"])
        assert tfinal >= 20000.0
        u = np.asarray(last)
        assert tfinal - float(f["data%d" % ks[-2]].attrs["t"]) > 2000.0
    rho = u[0]
    assert count_peaks(rho) == 4
    assert 200.0 < rho.min() < 600.0
    assert 20000.0 < rho.max() < 28000.0
    assert float(u[1:].min()) > 0.0
