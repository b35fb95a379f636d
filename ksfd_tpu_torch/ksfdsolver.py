"""Solve the Keller-Segel PDE system with ksfd_tpu_torch, on the card.

Counterpart: ksfdsolver.py (the JAX package's driver, the reference's
ksfdsolver2.py), with the same command-line grammar:

- options ``--name=value`` controlling how to solve (save, check,
  resume, restart, seed, onestep, showparams, source, ensemble, ...);
- parameters ``name=value`` with sympy-expression values describing the
  problem;
- a numerics block ``--numerics ... --`` or a reference PETSc block
  ``--petsc ... --``;
- ``@optionsfile`` indirection with '#' comments.

    python -m ksfd_tpu_torch @examples/aggregation2d --numerics \\
        -device_loop 1 --
    KSFD_PLATFORM=cpu python -m ksfd_tpu_torch @examples/eigenmode1d

It runs on the CUDA card and raises where there is none;
``KSFD_PLATFORM=cpu`` (the JAX package's own switch) runs it on the CPU.
Saving, checkpoints and resuming need h5py; without it those options
raise before any step.  ``--with_g`` carries G as a stored last field
(ops/operators_with_g.py; with ``--ensemble`` it is a KSFDException, as
in the reference), ``--flux_form`` runs the conservative
discretization.  Refused, as in the reference: ``--noperiodic``.

Several processes (the mpiexec analog, as the reference's driver):

    KSFD_COORDINATOR=localhost:29500 KSFD_NUM_PROCS=2 KSFD_PROC_ID=$i \\
        python -m ksfd_tpu_torch @examples/aggregation2d

starts one torch.distributed rank per process (parallel/distributed.py:
NCCL with one card per rank, gloo with ``KSFD_PLATFORM=cpu``), each
integrating its box of the grid through the Solver on the mesh
(parallel/mesh.py: the split ``mesh_shape_for`` picks, as the
reference's: an x split where ``nx % (8 nprocs) == 0``, else the most
balanced one, e.g. (2, 2) for 4 processes on 24x32; a 1D grid splits
x); only rank 0 prints the monitor lines, and each rank
writes and resumes its own ``<save>s<N>r<k>.h5`` with its box in
``/ranges`` (``python -m ksfd_tpu_torch.tools.tsmerge <save> -o <out>``
merges them).  ``--ensemble=N`` puts N/nprocs members on each process
instead, each process writing its own members' series.  A caller that
made its own process group (two gloo ranks on one card) runs ``main``
over it.
"""

import contextlib
import os
import sys
import time

import numpy as np
import torch

from .grid import Grid
from .ic import initial_values, start_values
from .io import (
    TimeSeries,
    h5py_module,
    make_checkpoint_monitor,
    make_save_monitor,
    write_info,
)
from .models import SolutionParameters
from .ops import PDEOperators, SpatialExpression, WithGOperators, with_g_grid
from .parallel import (
    global_from_local,
    grid_mesh,
    maybe_init_distributed,
    process_box,
    process_count,
    process_index,
)
from .randomfield import DEFAULT_SEED, Generator
from .solvers import EnsembleSolver, Solver
from .solvers.solver import print_monitor, route_petsc_direct
from .utils import find_duplicates
from .utils.cli import Parser, decode_numerics
from .utils.device import resolve_device
from .utils.exceptions import KSFDException

__all__ = ["parse_commandline", "catch_signals", "decode_sources",
           "run_device", "run_ensemble", "main"]


def parse_commandline(args=None):
    """The parsed command line.  Counterpart:
    ksfdsolver.py:parse_commandline (the same options and defaults)."""
    parser = Parser(description="Solve Keller-Segel PDEs (PyTorch/CUDA)")
    parser.add_argument("--cappotential", choices=["tophat", "witch"],
                        default="tophat",
                        help="potential function for capping rho")
    parser.add_argument("--save",
                        help="filename prefix in which to save results")
    parser.add_argument("--save_every", type=int, default=1,
                        help="minimum steps between saved snapshots "
                             "(default 1 = every accepted step; the "
                             "final state is always saved)")
    parser.add_argument("--check", help="filename prefix for checkpoints")
    parser.add_argument("--resume",
                        help="resume from last point of a TimeSeries")
    parser.add_argument("--restart",
                        help="restart (t=t0) from last point of a TimeSeries")
    parser.add_argument("--series_retries", type=int, default=0,
                        help="# retries to open TimeSeries")
    parser.add_argument("--series_retry_interval", type=int, default=60,
                        help="time (s) between open retries")
    parser.add_argument("--mpiok", action="store_true",
                        help="accepted for compatibility: a single-"
                             "process reader opens a complete slab set "
                             "as one series")
    parser.add_argument("--showparams", action="store_true",
                        help="print all parameters and exit")
    parser.add_argument("--noperiodic", action="store_true",
                        help="not implemented: only periodic BCs exist")
    parser.add_argument("--onestep", action="store_true",
                        help="exit after one step (a build check)")
    parser.add_argument("--solver", default="tpu", help="accepted for compat")
    parser.add_argument("--seed", type=int, default=DEFAULT_SEED,
                        help="random number generator seed")
    parser.add_argument("--source", type=str, action="append", default=[],
                        help="source function for rho, U_1_1, ...")
    parser.add_argument("--flux_form", action="store_true",
                        help="the conservative flux discretization of "
                             "the rho row (sum(rho) conserved to "
                             "roundoff)")
    parser.add_argument("--with_g", action="store_true",
                        help="carry the free energy G as a stored last "
                             "field, refreshed after every accepted step")
    parser.add_argument("--xprof", metavar="DIR",
                        help="write a torch.profiler chrome trace of the "
                             "solve to DIR: the torch ops, the card's "
                             "kernels and the port's host spans "
                             "(ksfd::attempt, tier, read, step, pc, "
                             "dispatch, post_accept, fallback, halo, "
                             "all_reduce), on one clock")
    parser.add_argument("--ensemble", type=int, default=0, metavar="N",
                        help="integrate N ensemble members (fresh starts "
                             "seeded seed..seed+N-1, independent noise "
                             "streams) as one batched program; members "
                             "save to <save>_m<i>")
    parser.add_argument("params", type=str, nargs="*",
                        help="parameter values (name=value, sympy exprs)")
    return parser.parse_args(args=args)


def catch_signals():
    """Turn catchable signals into KeyboardInterrupt so that files
    close.  Counterpart: ksfdsolver.py:catch_signals."""
    import signal as sig

    def handler(signum, frame):
        raise KeyboardInterrupt("Caught signal " + str(signum))

    for name in (
        "SIGHUP", "SIGINT", "SIGPIPE", "SIGALRM", "SIGTERM", "SIGXCPU",
        "SIGXFSZ", "SIGVTALRM", "SIGPROF", "SIGUSR1", "SIGUSR2", "SIGQUIT",
    ):
        try:
            sig.signal(getattr(sig, name), handler)
        except (OSError, ValueError, AttributeError):
            pass  # not on this platform, or not the main thread


def decode_sources(sargs, ps, grid, device=None):
    """--source=<field>=<expr> list -> per-field SpatialExpressions.
    Counterpart: ksfdsolver.py:decode_sources."""
    device = resolve_device(device)
    sources = [0.0] * (ps.nligands + 1)
    keys = [arg.split("=", maxsplit=1)[0] for arg in sargs]
    dups = find_duplicates(keys)
    if dups:
        raise KSFDException("duplicated sources: " + ", ".join(dups))
    names = ["rho"] + [lig.name() for lig in ps.groups.ligands()]
    for k in keys:
        if k not in names:
            raise KSFDException("unknown function: " + k)
    for snum, name in enumerate(keys):
        _, val = sargs[snum].split("=", maxsplit=1)
        sources[names.index(name)] = SpatialExpression(
            ps, grid, val, name="src_" + name, device=device)
    return [
        s if isinstance(s, SpatialExpression)
        else SpatialExpression(ps, grid, s, device=device)
        for s in sources
    ]


def run_device():
    """The card, or the CPU where ``KSFD_PLATFORM=cpu`` (the switch the
    JAX package reads, ksfd_tpu/__init__.py:31); without a card and
    without that switch, RuntimeError."""
    cpu = os.environ.get("KSFD_PLATFORM", "").lower() == "cpu"
    return resolve_device("cpu" if cpu else None)


def _init_processes():
    """``maybe_init_distributed`` on the run's device (NCCL on the card,
    gloo with ``KSFD_PLATFORM=cpu``) when the ``KSFD_*`` variables ask
    for several processes; returns whether it made the process group
    (a group the caller made already is used as it is)."""
    keys = ("KSFD_COORDINATOR", "KSFD_NUM_PROCS", "KSFD_PROC_ID")
    if not all(os.environ.get(k) for k in keys):
        return False
    return maybe_init_distributed(device=run_device())


@contextlib.contextmanager
def xprof_trace(directory, rank=None):
    """A torch.profiler chrome trace of the block into ``directory``
    (the counterpart of the JAX driver's ``jax.profiler.trace``), one
    file per rank when ``rank`` is given, or nothing for ``directory``
    None.  The trace holds the port's ``ksfd::`` host spans
    (utils/spans.py) beside the ops and kernels."""
    if not directory:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(directory, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    try:
        with prof:
            yield
    finally:
        prof.export_chrome_trace(os.path.join(
            directory, "ksfd_trace%s.json" % (
                "" if rank is None else "_r%d" % rank)))


def _refuse(clargs):
    """Raise, before any step, for what the port does not run: the
    reference's refusals, h5py missing for the I/O options, and a
    several-process request (``KSFD_NUM_PROCS`` above 1) that started
    no process group because ``KSFD_COORDINATOR`` or ``KSFD_PROC_ID`` is
    missing (each process would run the whole problem alone)."""
    if clargs.noperiodic:
        raise KSFDException("--noperiodic not implemented: BCs are periodic")
    if clargs.with_g and int(clargs.ensemble or 0) >= 1:
        raise KSFDException("--ensemble does not support --with_g")
    asked = int(os.environ.get("KSFD_NUM_PROCS", 1))
    if asked > 1 and process_count() == 1:
        raise KSFDException(
            "KSFD_NUM_PROCS=%d without a process group: set "
            "KSFD_COORDINATOR (host:port of rank 0) and KSFD_PROC_ID (this "
            "process's rank) too" % asked)
    if clargs.save or clargs.check or clargs.resume or clargs.restart:
        h5py_module()


def _open_series(prefix, grid, clargs, size=1, rank=0, ranges=None):
    return TimeSeries(prefix, grid=grid, mode="w",
                      retries=clargs.series_retries,
                      retry_interval=clargs.series_retry_interval,
                      size=size, rank=rank, ranges=ranges)


def run_ensemble(clargs, ps, grid, ops, numerics):
    """--ensemble=N: N fresh starts, member i from ``Generator(seed +
    i)``, integrated by one EnsembleSolver per process (noise seed
    ``seed``); member i saves to ``<save>_m<i>`` with '/info/member'.
    Counterpart: ksfdsolver.py:run_ensemble.  Over several processes the
    members go contiguously over them (``N % nproc == 0``): process p
    integrates members ``m0 = p * N // nproc`` onward on its own device,
    with no collective, its EnsembleSolver given
    ``member_offset=m0``, and writes those members' series itself;
    starts and noise streams follow the global member index, so each
    member's trajectory and series are the one-process run's.  Returns
    the exit status."""
    N = int(clargs.ensemble)
    if clargs.resume or clargs.restart or clargs.check:
        raise KSFDException(
            "--ensemble supports fresh starts only "
            "(no --resume/--restart/--check)"
        )
    nproc, pid = process_count(), process_index()
    if N % nproc:
        raise KSFDException(
            "--ensemble=%d members must divide evenly over %d processes "
            "(members slab contiguously per process)" % (N, nproc))
    nloc = N // nproc
    m0 = pid * nloc  # the process's first global member index
    members = []
    t0 = float(ps.t0)
    for i in range(m0, m0 + nloc):
        Generator(seed=clargs.seed + i)
        u0, t0 = start_values(clargs, grid, ps, device=ops.device)
        members.append(u0)
    U0 = torch.stack(members)
    p0 = ps.params0
    maxsteps = 1 if clargs.onestep else int(p0["maxsteps"])
    es = EnsembleSolver(
        ops, numerics, t0=t0, dt=float(p0["dt"]), tmax=float(p0["tmax"]),
        maxsteps=maxsteps, rtol=float(p0["rtol"]), atol=float(p0["atol"]),
        rng_key=clargs.seed, member_offset=m0,
    )
    series = []
    if clargs.save:
        for i in range(m0, m0 + nloc):
            ts_i = _open_series("%s_m%d" % (clargs.save, i), grid, clargs)
            write_info(ts_i, clargs=clargs, ps=ps, sources=ops.sources)
            ts_i.try_to_set("/info/member", i)
            ts_i.flush()
            series.append(ts_i)
    every = max(1, int(clargs.save_every))
    lastk = [None] * nloc

    def store_members(ks, ts, U, force=False):
        Uh = U.detach().cpu().numpy()
        for i, s in enumerate(series):
            k = int(ks[i])
            if lastk[i] == k:
                continue
            if not force and lastk[i] is not None and k - lastk[i] < every:
                continue
            if not s.tsFile:
                s.reopen()
            s.store(Uh[i], float(ts[i]), k=k)
            s.temp_close()
            lastk[i] = k

    slab = "" if nproc == 1 else " members %d-%d," % (m0, m0 + nloc - 1)

    def ens_print(es_, ks, ts, U):
        print("clock: %s,%s steps %d-%d t=[%.6g, %.6g] h=[%.3g, %.3g]" % (
            time.strftime("%H:%M:%S"), slab, int(np.min(ks)), int(np.max(ks)),
            float(np.min(ts)), float(np.max(ts)), float(np.min(es_.hs)),
            float(np.max(es_.hs))), flush=True)

    es.add_monitor(ens_print)
    if series:
        es.add_monitor(lambda es_, ks, ts, U: store_members(ks, ts, U))
    status = 0
    out = None
    try:
        with xprof_trace(clargs.xprof, None if nproc == 1 else pid):
            out = es.solve(U0)
    except KeyboardInterrupt as e:
        print("KeyboardInterrupt:", str(e))
    except Exception as e:  # the run's boundary: report, then save
        print("Exception:", str(e))
        import traceback

        traceback.print_exc()
        status = 1
    if series:
        if es.u is not None and es.ks is not None:
            try:
                store_members(es.ks, es.ts, es.u, force=True)
            except Exception as e:
                print("final save failed:", str(e))
        for s in series:
            s.close()
    if out is not None:
        print("members = %d%s diverged = %d, solve failures = %d" % (
            nloc, slab or ",", int(np.sum(out.diverged)),
            int(np.sum(out.snes_failures))))
    return status


def main(*args):
    """Run the command line ``args`` (``sys.argv`` when none: args[0]
    is the program name); returns the exit status.  Counterpart:
    ksfdsolver.py:main.  Over several processes (module docstring) each
    rank integrates its box through ``Solver(mesh=)``; the process
    group that main makes it also ends."""
    args = list(args) if args else sys.argv
    owns_group = _init_processes()
    try:
        return _main(args)
    finally:
        if owns_group:
            import torch.distributed as dist

            dist.destroy_process_group()


def _main(args):
    clargs = parse_commandline(args[1:])
    catch_signals()
    _refuse(clargs)
    ps = SolutionParameters(clargs)
    Generator(seed=clargs.seed)
    if clargs.showparams:
        for n, p, d, h in ps.params0.params():
            print("{n}={val} -- {h}".format(n=n, val=p(), h=h))
        return 0
    numerics = decode_numerics(clargs.numerics, petsc_tokens=clargs.petsc)
    device = run_device()
    grid = Grid(
        dim=ps.dim,
        dof=ps.nligands + 1,
        width=ps.width, height=ps.height, depth=ps.depth,
        nx=ps.nwidth, ny=ps.nheight, nz=ps.ndepth,
        order=ps.degree,
    )
    sources = decode_sources(clargs.source, ps, grid, device=device)
    if int(clargs.ensemble or 0) >= 1:
        ops = PDEOperators(ps, grid, sources=sources,
                           flux_form=clargs.flux_form, device=device)
        return run_ensemble(clargs, ps, grid, ops, numerics)
    if clargs.with_g:
        # the G slot last: a resumed series carries it, a fresh start
        # gets zeros, which the Solver's first refresh_G fills
        full_grid = with_g_grid(grid)
        ops = WithGOperators(ps, full_grid, sources=sources,
                             flux_form=clargs.flux_form, device=device)
        if clargs.resume or clargs.restart:
            u0, t, extras = initial_values(clargs, full_grid, ps,
                                           device=device)
        else:
            u0p, t, extras = initial_values(clargs, grid, ps,
                                            device=device)
            u0 = torch.cat([torch.as_tensor(u0p, device=device),
                            torch.zeros((1,) + tuple(grid.Sshape),
                                        dtype=torch.float64,
                                        device=device)])
        grid = full_grid
    else:
        ops = PDEOperators(ps, grid, sources=sources,
                           flux_form=clargs.flux_form, device=device)
        u0, t, extras = initial_values(clargs, grid, ps, device=device)
        # a PETSc '-ksp_type preonly -pc_type lu' block asks for exact
        # direct solves (the reference's MUMPS configuration)
        numerics = route_petsc_direct(numerics, grid)
    nprocs, rank = process_count(), process_index()
    mesh = slab = None
    if nprocs > 1:
        # one box per rank, the split the reference's mesh_shape_for
        # picks (ksfdsolver.py:371-390, grid_mesh(grid)); grid_mesh
        # raises where it would leave ranks idle.  A resume read only
        # this rank's block, whose box (the file's /ranges) must be the
        # one this run's mesh gives the rank
        mesh = grid_mesh(grid, device=device)
        slab = process_box(grid, mesh)
        box = extras.get("box")
        if box is not None and tuple(box) != tuple(slab):
            raise KSFDException(
                "checkpoint slab %r does not match this run's "
                "decomposition %r; tsmerge the series first"
                % (tuple(box), tuple(slab)))
        u0 = global_from_local(u0, grid, mesh, box=box)
    p0 = ps.params0
    tseries = None
    if clargs.save:
        tseries = _open_series(clargs.save, grid, clargs, size=nprocs,
                               rank=rank, ranges=slab)
        write_info(tseries, clargs=clargs, ps=ps, sources=sources)
        tseries.try_to_set("/info/dt", float(p0["dt"]))
        if "lastvart" in p0:
            tseries.try_to_set("/info/lastvart", float(p0["lastvart"]))
        tseries.flush()
    maxsteps = 1 if clargs.onestep else int(p0["maxsteps"])
    solver = Solver(
        ops,
        numerics,
        t0=t,
        dt=float(p0["dt"]),
        tmax=float(p0["tmax"]),
        maxsteps=maxsteps,
        rtol=float(p0["rtol"]),
        atol=float(p0["atol"]),
        # the noise stream: the checkpoint's, else seeded from --seed
        rng_state=extras.get("rng_state", clargs.seed),
        lastvart=float(p0["lastvart"]) if "lastvart" in p0 else None,
        k0=int(extras.get("k", 0)),
        mesh=mesh,
    )
    if rank == 0:  # the reference's printMonitor is rank 0's
        solver.add_monitor(print_monitor)
    if tseries is not None:
        save_monitor, closer = make_save_monitor(tseries,
                                                 every=clargs.save_every)
        solver.add_monitor(save_monitor)
    if clargs.check:
        solver.add_monitor(make_checkpoint_monitor(
            clargs.check, grid, clargs=clargs, ps=ps, sources=sources,
            retries=clargs.series_retries,
            retry_interval=clargs.series_retry_interval,
            size=nprocs, rank=rank, ranges=slab))
    status = 0
    try:
        with xprof_trace(clargs.xprof, None if mesh is None else rank):
            solver.solve(u0, t=t)
    except KeyboardInterrupt as e:
        print("KeyboardInterrupt:", str(e))
    except Exception as e:  # the run's boundary: report, then save
        print("Exception:", str(e))
        import traceback

        traceback.print_exc()
        status = 1
    if tseries is not None:
        if solver.u is not None:
            # --save_every thinning: the last accepted state always
            # lands, also after an interrupt or an exception
            try:
                save_monitor(solver, solver.k, solver.t, solver.u,
                             force=True)
            except Exception as e:
                print("final save failed:", str(e))
        closer()
        tseries.close()
    if rank == 0:
        print("solve failures =", solver.snes_failures)
    return status
