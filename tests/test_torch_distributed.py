"""The port's driver over several processes, on the CPU.

``python -m ksfd_tpu_torch`` run as subprocesses with ``KSFD_PLATFORM=cpu``
and ``KSFD_COORDINATOR``/``KSFD_NUM_PROCS``/``KSFD_PROC_ID`` (one gloo
rank per process, one x-slab each) on a 2D problem at 32^2 x 3, a few
steps: the port's counterpart of the reference's tests/test_distributed.py
(:95, :183, :254, :321, :415, :463; 1D there: the 1D mesh and the y
splits are tests/test_torch_mesh_splits.py's).  Every independent run starts at once (``runs``), the
resumes after them; each process has a timeout, and a process that fails
fails the test with its output.

- the 2- and 4-process slab write: ``<save>s<N>r<k>.h5`` with
  ``/ranges``, merged by ksfd_tpu_torch/tools/tsmerge.py into a series
  with the one-process run's steps and times, within 1e-10 of its
  max|u| (fixed dt, ``pc_dtype`` float32 pinned: the sharded pc's
  all_reduce sums the float32 products in another order); against the
  reference's own one-process driver (ksfdsolver.py) within 1e-5 of the
  increment (float32 sweeps round apart between the packages);
- a 2-process checkpoint and resume (adaptive, its own slab files)
  equal to the uninterrupted 2-process run bit for bit, k continued;
  the slab files of the ranks swapped raise "tsmerge the series first";
- one process resuming the 2-rank checkpoint through the virtual slab
  view;
- ``--ensemble=4`` over 2 processes (members 0-1 and 2-3), each
  member's series bit-equal to the one-process run's, and 3 members
  over 2 processes refused;
- ``-ksp_type lu`` (the PETSc block's ``preonly`` + ``lu``) over 2
  processes: the replicated host solve, bit-equal to one process.
"""

import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from ksfd_tpu_torch import io as tio
from ksfd_tpu_torch.tools import tsmerge
from ksfd_tpu_torch.tools.lastcheckpoint import last_checkpoint

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 240

PROBLEM = """\
tmax=1e6
width=1
height=1
nelements=32
dim=2
degree=3
atol=0.01
rtol=1e-6
rhomax=28000
cushion=2000
s2=2.78e-4
Nworms=0
ngroups=2
nligands_1=1
alpha_1=1500
beta_1=5.56e-4
s_1_1=0.01
gamma_1_1=0.01
D_1_1=1e-6
nligands_2=1
alpha_2=1500
beta_2=-5.56e-4
s_2_1=0.001
gamma_2_1=0.001
D_2_1=1e-5
"""
SMOOTH = "'rho0=9000 + 100*sin(2*pi*(x+y))'\nsrho0=0\n"
FIXED = (PROBLEM + SMOOTH + "dt=1e-3\nmaxsteps=3\n--numerics\n"
         "-ts_adapt_type none\n-pc_dtype float32\n--\n")
ADAPTIVE = PROBLEM + SMOOTH + "--numerics\n-pc_dtype float32\n--\n"
ENSEMBLE = (PROBLEM + "rho0=9000\nsrho0=30\ndt=1e-3\nmaxsteps=3\n"
            "--numerics\n-ts_adapt_type none\n--\n")
LU = (PROBLEM + SMOOTH + "dt=1e-3\nmaxsteps=3\n--petsc\n-ts_adapt_type "
      "none\n-ksp_type preonly\n-pc_type lu\n--\n")


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def env_of(extra):
    env = dict(os.environ, KSFD_PLATFORM="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO))
    for key in ("KSFD_COORDINATOR", "KSFD_NUM_PROCS", "KSFD_PROC_ID",
                "JAX_PLATFORMS"):
        env.pop(key, None)
    env.update(extra)
    return env


def launch(opt, nprocs, *args):
    """``nprocs`` coordinated driver processes (one without the KSFD_*
    variables): the mpiexec analog."""
    port = free_port()
    cmd = [sys.executable, "-m", "ksfd_tpu_torch", "@" + str(opt)]
    if nprocs == 1:
        extras = [{}]
    else:
        extras = [dict(KSFD_COORDINATOR="127.0.0.1:%d" % port,
                       KSFD_NUM_PROCS=str(nprocs), KSFD_PROC_ID=str(i))
                  for i in range(nprocs)]
    return [subprocess.Popen(cmd + list(args), env=env_of(e), cwd=REPO,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for e in extras]


def reference(opt, *args):
    """The JAX package's driver in one process on the CPU."""
    return [subprocess.Popen(
        [sys.executable, str(REPO / "ksfdsolver.py"), "@" + str(opt)]
        + list(args), env=env_of({}), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)]


def finish(procs):
    """(return codes, outputs) of the processes, each within TIMEOUT;
    a process still running then is killed."""
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            out += "\n[killed after %d s]" % TIMEOUT
        outs.append(out)
    return [p.returncode for p in procs], outs


def ok(result):
    rcs, outs = result
    assert rcs == [0] * len(rcs), "\n----\n".join(outs)
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every independent run at once, then the resumes."""
    d = tmp_path_factory.mktemp("procs")
    opts = {}
    for name, text in (("fixed", FIXED), ("adaptive6", ADAPTIVE
                                          + "dt=0.1\nmaxsteps=6\n"),
                       ("adaptive3", ADAPTIVE + "dt=0.1\nmaxsteps=3\n"),
                       ("resume", ADAPTIVE + "maxsteps=6\n"),
                       ("ensemble", ENSEMBLE), ("lu", LU)):
        opts[name] = d / name
        opts[name].write_text(text)
    started = {
        "fixed1": launch(opts["fixed"], 1, "--save=%s" % (d / "f1")),
        "fixed2": launch(opts["fixed"], 2, "--save=%s" % (d / "f2")),
        "fixed4": launch(opts["fixed"], 4, "--save=%s" % (d / "f4")),
        "reference": reference(opts["fixed"], "--save=%s" % (d / "ref")),
        "adaptive6": launch(opts["adaptive6"], 2, "--save=%s" % (d / "A")),
        "check3": launch(opts["adaptive3"], 2, "--save=%s" % (d / "B"),
                         "--check=%s" % (d / "cpB")),
        "ens2": launch(opts["ensemble"], 2, "--ensemble=4", "--seed=5",
                       "--save=%s" % (d / "e2" / "e")),
        "ens1": launch(opts["ensemble"], 1, "--ensemble=4", "--seed=5",
                       "--save=%s" % (d / "e1" / "e")),
        "ens_bad": launch(opts["ensemble"], 2, "--ensemble=3"),
        "lu2": launch(opts["lu"], 2, "--save=%s" % (d / "lu2")),
        "lu1": launch(opts["lu"], 1, "--save=%s" % (d / "lu1")),
    }
    res = {name: finish(procs) for name, procs in started.items()}
    out = dict(dir=d, res=res)
    if res["check3"][0] != [0, 0]:
        return out
    cp = last_checkpoint(str(d / "cpB"))
    out["cp"] = cp
    # the ranks' checkpoint files swapped: each rank reads the other's box
    swap = str(d / "swap_3_")
    for r in range(2):
        shutil.copy("%ss2r%d.h5" % (cp, r), "%ss2r%d.h5" % (swap, 1 - r))
    started = {
        "resume": launch(opts["resume"], 2, "--resume=" + cp,
                         "--save=%s" % (d / "C")),
        "virtual": launch(opts["resume"], 1, "--resume=" + cp,
                          "--save=%s" % (d / "V")),
        "swapped": launch(opts["resume"], 2, "--resume=" + swap),
    }
    res.update({name: finish(procs) for name, procs in started.items()})
    return out


def series(prefix):
    """(ks, times, states by step) of a series, a slab set read whole."""
    ts = tio.TimeSeries(str(prefix), mode="r")
    order = ts.sorted_steps()
    ks = [int(k) for k in ts.ks[order]]
    times = [float(t) for t in ts.sorted_times()]
    states = [np.asarray(ts.retrieve_by_time(t)) for t in times]
    ts.close()
    return ks, times, states


def merged(d, prefix):
    out = str(d / ("merged_" + prefix))
    assert tsmerge.main([str(d / prefix), "-o", out]) == 0
    return out


@pytest.mark.parametrize("nprocs", [2, 4])
def test_slab_write_and_merge(runs, nprocs):
    """Each process writes its x-slab with /ranges; tsmerge's series has
    the one-process run's steps and times and its states within 1e-10
    of max|u|; only rank 0 prints the monitor lines."""
    d = runs["dir"]
    outs = ok(runs["res"]["fixed%d" % nprocs])
    ok(runs["res"]["fixed1"])
    assert "step   3" in outs[0]
    for out in outs[1:]:
        assert "clock:" not in out and "step" not in out
    boxes = []
    for r in range(nprocs):
        ts = tio.TimeSeries(str(d / ("f%d" % nprocs)), mode="r",
                            size=nprocs, rank=r)
        assert ts.filename.endswith("f%ds%dr%d.h5" % (nprocs, nprocs, r))
        boxes.append(ts.ranges)
        assert ts.local_shape == (3, 32 // nprocs, 32)
        ts.close()
    w = 32 // nprocs
    assert boxes == [((w * r, w * (r + 1)), (0, 32)) for r in range(nprocs)]
    ks, times, states = series(merged(d, "f%d" % nprocs))
    ks1, times1, states1 = series(d / "f1")
    assert ks == ks1 == [0, 1, 2, 3] and times == times1
    scale = np.abs(states1[-1]).max()
    for a, b in zip(states, states1):
        assert np.abs(a - b).max() <= 1e-10 * scale


def test_slab_write_matches_the_reference_driver(runs):
    """The 2-process series, merged, against the reference's
    one-process driver on the same options: the same steps and times,
    the states within 1e-5 of the increment."""
    d = runs["dir"]
    ok(runs["res"]["fixed2"])
    ok(runs["res"]["reference"])
    ks, times, states = series(merged(d, "f2"))
    ksr, timesr, statesr = series(d / "ref")
    assert ks == ksr and times == pytest.approx(timesr, rel=1e-12)
    inc = np.abs(statesr[-1] - statesr[0]).max()
    for a, b in zip(states, statesr):
        assert np.abs(a - b).max() <= 1e-5 * inc


def test_checkpoint_and_resume_over_two_processes(runs):
    """3 adaptive steps with per-rank slab checkpoints, then a 2-process
    --resume to 6: each rank's series equals the uninterrupted 2-process
    run's from k = 3 bit for bit."""
    d = runs["dir"]
    ok(runs["res"]["adaptive6"])
    ok(runs["res"]["check3"])
    assert runs["cp"].endswith("cpB_3_")
    for k in range(4):
        for r in range(2):
            assert (d / ("cpB_%d_s2r%d.h5" % (k, r))).is_file()
    ok(runs["res"]["resume"])
    for r in range(2):
        a = tio.TimeSeries(str(d / "A"), mode="r", size=2, rank=r)
        c = tio.TimeSeries(str(d / "C"), mode="r", size=2, rank=r)
        assert a.ranges == c.ranges == ((16 * r, 16 * (r + 1)), (0, 32))
        aks = sorted(int(k) for k in a.ks)
        cks = sorted(int(k) for k in c.ks)
        assert aks == list(range(7)) and cks == list(range(3, 7))
        ta = dict(zip((int(k) for k in a.ks), a.ts))
        tc = dict(zip((int(k) for k in c.ks), c.ts))
        for k in cks:
            assert ta[k] == tc[k]
            np.testing.assert_array_equal(a.retrieve_by_time(ta[k]),
                                          c.retrieve_by_time(tc[k]))
        a.close()
        c.close()


def test_resume_of_swapped_slabs_names_tsmerge(runs):
    """A rank whose checkpoint holds another rank's box refuses before
    any step: 'tsmerge the series first', on both ranks."""
    rcs, outs = runs["res"]["swapped"]
    assert rcs[0] != 0 and rcs[1] != 0
    for out in outs:
        assert "tsmerge the series first" in out, out
        assert "step" not in out


def test_one_process_resumes_a_slab_set(runs):
    """One process resumes the 2-rank checkpoint through the virtual
    slab view: its first snapshot is the checkpoint's global state."""
    d = runs["dir"]
    ok(runs["res"]["virtual"])
    cp = tio.TimeSeries(runs["cp"], mode="r")
    assert cp.virtual
    want = np.asarray(cp.retrieve_by_time(cp.sorted_times()[-1]))
    cp.close()
    ks, _, states = series(d / "V")
    assert ks == [3, 4, 5, 6]
    np.testing.assert_array_equal(states[0], want)


def test_ensemble_over_two_processes(runs):
    """--ensemble=4 over 2 processes: members 0-1 and 2-3, each member's
    series bit-equal to the one-process run's (global member indices
    seed the starts and the noise streams); the members differ; 3
    members do not divide over 2 processes."""
    d = runs["dir"]
    outs = ok(runs["res"]["ens2"])
    ok(runs["res"]["ens1"])
    text = "".join(outs)
    assert "members 0-1" in text and "members 2-3" in text
    for i in range(4):
        ks2, t2, s2 = series(d / "e2" / ("e_m%d" % i))
        ks1, t1, s1 = series(d / "e1" / ("e_m%d" % i))
        assert ks2 == ks1 == [0, 1, 2, 3] and t2 == t1
        for a, b in zip(s2, s1):
            np.testing.assert_array_equal(a, b)
    first = series(d / "e2" / "e_m0")[2][0]
    last = series(d / "e2" / "e_m3")[2][0]
    assert np.abs(first - last).max() > 1.0
    rcs, bad = runs["res"]["ens_bad"]
    assert rcs[0] != 0 and rcs[1] != 0
    for out in bad:
        assert "divide evenly" in out, out


def test_exact_lu_over_two_processes(runs):
    """The PETSc block's preonly + lu routed to -ksp_type lu on 2
    processes: the replicated host solve, bit-equal to one process."""
    d = runs["dir"]
    outs = ok(runs["res"]["lu2"])
    ok(runs["res"]["lu1"])
    assert "routed to the exact direct tier" in outs[0]
    ks, times, states = series(merged(d, "lu2"))
    ks1, times1, states1 = series(d / "lu1")
    assert ks == ks1 == [0, 1, 2, 3] and times == times1
    for a, b in zip(states, states1):
        np.testing.assert_array_equal(a, b)
