"""The port's driver (``python -m ksfd_tpu_torch``) on the CPU.

``ksfd_tpu_torch/ksfdsolver.py:main`` run in this process with
``KSFD_PLATFORM=cpu`` on tiny 1D options files (as tests/test_tools.py
runs the JAX package's ``ksfdsolver.py``): an end-to-end save,
``--save_every``, a 3 + 3 resume against 6 straight steps through the
port's ``lastcheckpoint``, the port resuming a checkpoint that the JAX
package wrote, ``--ensemble`` against ``EnsembleSolver`` run directly,
and the options the port refuses.
"""

import os
import re
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ksfd_tpu_torch import KSFDException, SolutionParameters
from ksfd_tpu_torch import io as tio
from ksfd_tpu_torch import ksfdsolver as tks
from ksfd_tpu_torch.ic import start_values
from ksfd_tpu_torch.randomfield import Generator
from ksfd_tpu_torch.solvers import EnsembleSolver
from ksfd_tpu_torch.tools.lastcheckpoint import last_checkpoint
from ksfd_tpu_torch.utils.cli import decode_numerics

REPO = Path(__file__).resolve().parents[1]
#: the increment bound of tests/test_torch_host_solver.py (float32
#: sweeps on both sides), and its t and h bound
F32_INC = 1e-5
ADAPT_REL = 1e-8

COMMON = (
    "tmax=1e6\nwidth=1\nnelements=16\ndim=1\n"
    "degree=3\natol=0.01\nrtol=1e-6\nsigma=0.02357\ns2=sigma**2/2\n"
    "Nworms=0\nsrho0=0\nrho0=9000+100*sin(2*pi*x)\n"
    "ngroups=1\nnligands_1=1\nalpha_1=1500\nbeta_1=5.56e-4\n"
    "s_1_1=0.01\ngamma_1_1=0.01\nD_1_1=1e-6\n"
)
FIXED = "--petsc\n-ts_type rosw\n-ts_adapt_type none\n--\n"


@pytest.fixture(autouse=True)
def cpu_run(monkeypatch):
    """KSFD_PLATFORM=cpu, and the signal handlers that main installs
    (catch_signals) put back afterwards."""
    monkeypatch.setenv("KSFD_PLATFORM", "cpu")
    monkeypatch.delenv("KSFD_NUM_PROCS", raising=False)
    names = ("SIGHUP", "SIGINT", "SIGPIPE", "SIGALRM", "SIGTERM",
             "SIGXCPU", "SIGXFSZ", "SIGVTALRM", "SIGPROF", "SIGUSR1",
             "SIGUSR2", "SIGQUIT")
    saved = {n: signal.getsignal(getattr(signal, n)) for n in names
             if hasattr(signal, n)}
    yield
    for n, h in saved.items():
        signal.signal(getattr(signal, n), h)


def options(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return "@" + str(path)


def run(*argv):
    return tks.main("ksfd_tpu_torch", *argv)


def series(prefix):
    """(ks, ts, last state, solver_state) of a saved series."""
    ts = tio.TimeSeries(str(prefix), mode="r")
    ks = [int(k) for k in ts.ks[ts.sorted_steps()]]
    times = list(ts.sorted_times())
    out = (ks, times, ts.retrieve_by_time(times[-1]),
           ts.load_solver_state(), ts.retrieve_by_time(times[0]))
    ts.close()
    return out


def failures(stdout):
    return int(re.findall(r"solve failures = (\d+)", stdout)[-1])


def test_driver_end_to_end_save(tmp_path, capsys):
    opt = options(tmp_path, "opts", "--save={d}/solutions/cli\ndt=1\n"
                  "maxsteps=2\n".format(d=tmp_path) + COMMON + FIXED)
    assert run(opt) == 0
    out = capsys.readouterr().out
    assert "step   2" in out and "solve failures = 0" in out
    soln = tio.Solution(str(tmp_path / "solutions/cli"), device="cpu")
    assert soln.tmax == 2.0 and soln.grid.nx == 16
    assert soln.clargs.save == str(tmp_path / "solutions/cli")
    assert float(soln.tseries.info["dt"][()]) == 1.0
    assert soln.derivatives.nligands == 1
    soln.close()


def test_driver_save_every_thins_and_keeps_the_last_state(tmp_path):
    opt = options(tmp_path, "opts", "--save={d}/thin\n--save_every=2\n"
                  "dt=1\nmaxsteps=5\n".format(d=tmp_path) + COMMON + FIXED)
    assert run(opt) == 0
    ks, times, _, state, _ = series(tmp_path / "thin")
    assert ks == [0, 2, 4, 5] and times == [0.0, 2.0, 4.0, 5.0]
    assert state["k"] == 5


def test_driver_resume_bit_equal(tmp_path, capsys):
    """6 adaptive steps straight, against 3 with checkpoints then
    --resume from lastcheckpoint's prefix (dt left out, so the file's
    dt is used): the same trajectory bit for bit, k continued."""
    assert run(options(tmp_path, "A", "--save={d}/A\ndt=0.1\nmaxsteps=6\n"
                       .format(d=tmp_path) + COMMON)) == 0
    assert run(options(tmp_path, "B", "--save={d}/B\n--check={d}/cpB\n"
                       "dt=0.1\nmaxsteps=3\n".format(d=tmp_path)
                       + COMMON)) == 0
    cp = last_checkpoint(str(tmp_path / "cpB"))
    assert cp == str(tmp_path / "cpB_3_")
    assert run(options(tmp_path, "C", "--save={d}/C\n--resume={cp}\n"
                       "maxsteps=6\n".format(d=tmp_path, cp=cp)
                       + COMMON)) == 0
    ka, ta, ua, sa, _ = series(tmp_path / "A")
    kc, tc, uc, sc, _ = series(tmp_path / "C")
    assert ta[-1] == tc[-1] and sa["dt"] == sc["dt"]
    np.testing.assert_array_equal(ua, uc)
    assert kc[0] == 3 and kc[-1] == ka[-1] == 6
    assert ka[3:] == kc and ta[3:] == tc


def reference_cli(argv):
    """The JAX package's ksfdsolver.py in its own process, on the CPU."""
    env = dict(os.environ, KSFD_PLATFORM="cpu", PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, str(REPO / "ksfdsolver.py")]
                         + argv, capture_output=True, text=True, env=env,
                         timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout


def test_driver_resumes_a_jax_checkpoint(tmp_path, capsys):
    """The JAX package writes a checkpoint at k = 3; the port resumes
    it to k = 6, against the JAX package's uninterrupted 6 steps: k and
    failures equal, t and h to 1e-8 relative, u within 1e-5 of the
    increment.  The stage solves are the dense exact tier: float32
    sweeps round apart between the packages and move an adaptive t and
    h by about 1e-6.  The JAX noise key cannot be continued: the port
    says so and seeds its own stream."""
    dense = "--numerics\n-ksp_type dense\n--\n"
    out_a = reference_cli([options(tmp_path, "A", "--save={d}/A\n"
                                   "dt=0.1\nmaxsteps=6\n".format(d=tmp_path)
                                   + COMMON + dense)])
    out_b = reference_cli([options(tmp_path, "B", "--check={d}/cpB\n"
                                   "dt=0.1\nmaxsteps=3\n".format(d=tmp_path)
                                   + COMMON + dense)])
    cp = last_checkpoint(str(tmp_path / "cpB"))
    assert cp.endswith("_3_")
    assert run(options(tmp_path, "C", "--save={d}/C\n--resume={cp}\n"
                       "maxsteps=6\n".format(d=tmp_path, cp=cp)
                       + COMMON + dense)) == 0
    cap = capsys.readouterr()
    assert "restarts from --seed" in cap.err
    ka, ta, ua, sa, ua0 = series(tmp_path / "A")
    kc, tc, uc, sc, _ = series(tmp_path / "C")
    assert kc[0] == 3 and kc[-1] == ka[-1] == 6
    assert failures(out_a) == failures(out_b) + failures(cap.out)
    assert abs(tc[-1] - ta[-1]) <= ADAPT_REL * abs(ta[-1])
    assert abs(sc["dt"] - sa["dt"]) <= ADAPT_REL * abs(sa["dt"])
    np.testing.assert_allclose(
        uc, ua, rtol=0, atol=F32_INC * float(np.abs(ua - ua0).max()))


def test_driver_ensemble_equals_the_ensemble_solver(tmp_path):
    """--ensemble=2: each member's series ends where EnsembleSolver,
    run directly on the same starts (member i from Generator(seed + i),
    noise seed = seed), ends, bit for bit."""
    text = ("--save={d}/E\n--ensemble=2\n--seed=11\ndt=0.1\nmaxsteps=3\n"
            .format(d=tmp_path) + COMMON.replace("srho0=0", "srho0=90"))
    opt = options(tmp_path, "E", text)
    assert run(opt) == 0
    clargs = tks.parse_commandline([opt])
    ps = SolutionParameters(clargs)
    grid = tio.TimeSeries(str(tmp_path / "E_m0"), mode="r")
    g = grid.grid
    grid.close()
    from ksfd_tpu_torch.ops import PDEOperators

    ops = PDEOperators(ps, g, device="cpu")
    starts = []
    for i in range(2):
        Generator(seed=11 + i)
        starts.append(start_values(clargs, g, ps, device="cpu")[0])
    p0 = ps.params0
    es = EnsembleSolver(ops, decode_numerics(clargs.numerics,
                                             petsc_tokens=clargs.petsc),
                        t0=0.0, dt=0.1, tmax=float(p0["tmax"]), maxsteps=3,
                        rtol=1e-6, atol=0.01, rng_key=11)
    out = es.solve(torch.stack(starts))
    assert not torch.equal(starts[0], starts[1])
    for i in range(2):
        ks, times, u, _, u0 = series(tmp_path / ("E_m%d" % i))
        assert ks[-1] == int(out.k[i]) == 3 and times[-1] == out.t[i]
        np.testing.assert_array_equal(u, out.u[i].numpy())
        np.testing.assert_array_equal(u0, ops.groom(starts[i]).numpy())
        ts = tio.TimeSeries(str(tmp_path / ("E_m%d" % i)), mode="r")
        assert int(ts.info["member"][()]) == i
        ts.close()


# with_g: --with_g runs since it was ported, with --ensemble it is the
# reference's KSFDException; flux_form runs (exc None):
# tests/test_torch_with_g.py holds both runs
REFUSED = {
    "with_g": (["--with_g", "--ensemble=2"], KSFDException,
               "does not support --with_g"),
    "flux_form": (["--flux_form"], None, None),
    "noperiodic": (["--noperiodic"], KSFDException, "periodic"),
    "ensemble_check": (["--ensemble=2", "--check=cp"], KSFDException,
                       "fresh starts"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_driver_refusals(tmp_path, capsys, case):
    argv, exc, match = REFUSED[case]
    opt = options(tmp_path, "opts", "dt=1\nmaxsteps=2\n" + COMMON + FIXED)
    if exc is None:
        assert run(opt, *argv) == 0
        assert "step   2" in capsys.readouterr().out
        return
    with pytest.raises(exc, match=match):
        run(opt, *argv)
    assert "step" not in capsys.readouterr().out


def test_driver_refuses_several_processes(tmp_path, monkeypatch):
    """Several processes run (tests/test_torch_distributed.py); a
    KSFD_NUM_PROCS request that made no process group (no coordinator,
    no rank) is refused before any step, naming what is missing."""
    monkeypatch.setenv("KSFD_NUM_PROCS", "2")
    monkeypatch.delenv("KSFD_COORDINATOR", raising=False)
    monkeypatch.delenv("KSFD_PROC_ID", raising=False)
    opt = options(tmp_path, "opts", "dt=1\nmaxsteps=2\n" + COMMON + FIXED)
    with pytest.raises(KSFDException,
                       match="KSFD_COORDINATOR.*KSFD_PROC_ID"):
        run(opt)


@pytest.mark.parametrize("flag", ["--save", "--check", "--resume"])
def test_driver_without_h5py_refuses_io_before_any_step(tmp_path, capsys,
                                                        monkeypatch, flag):
    monkeypatch.setitem(sys.modules, "h5py", None)
    opt = options(tmp_path, "opts", "dt=1\nmaxsteps=2\n" + COMMON + FIXED)
    with pytest.raises(KSFDException, match="h5py"):
        run(opt, "%s=%s" % (flag, tmp_path / "x"))
    assert "step" not in capsys.readouterr().out
    # without the I/O options the same run goes on
    assert run(opt) == 0


def test_driver_showparams_onestep_source_and_xprof(tmp_path, capsys):
    """--showparams prints the parameters and steps nothing; --onestep
    takes one step; --source adds a source term (a duplicated or
    unknown one raises, as in the reference); --xprof writes a
    torch.profiler chrome trace."""
    opt = options(tmp_path, "opts", "dt=1\nmaxsteps=3\n" + COMMON + FIXED)
    assert run(opt, "--showparams") == 0
    out = capsys.readouterr().out
    assert "sigma=0.02357" in out and "nelements=16" in out
    assert "clock:" not in out
    assert run(opt, "--onestep", "--source=rho=100*sin(2*pi*x)",
               "--xprof=" + str(tmp_path / "trace")) == 0
    out = capsys.readouterr().out
    assert "step   1" in out and "step   2" not in out
    assert (tmp_path / "trace" / "ksfd_trace.json").stat().st_size > 0
    with pytest.raises(KSFDException, match="duplicated sources"):
        run(opt, "--source=rho=1", "--source=rho=2")
    with pytest.raises(KSFDException, match="unknown function"):
        run(opt, "--source=U_9_9=1")


def test_driver_imports_without_h5py():
    """The card's machine has no h5py: the driver and the I/O package
    import all the same (h5py is imported on first use)."""
    code = ("import sys; sys.modules['h5py'] = None; "
            "import ksfd_tpu_torch.ksfdsolver, ksfd_tpu_torch.io; "
            "assert 'jax' not in sys.modules")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
