"""Initial values: fresh starts and checkpoint resume.

Counterpart: ksfd_tpu/ic.py (the reference's ksfdsolver2.py:500-639).
A fresh start is rho0 plus a smooth random field drawn on a coarse grid
(randomfield.py), the ligands given or at their local steady state.
A resume or restart reads the last snapshot of a TimeSeries (io/).
"""

import os
import sys

import numpy as np
import torch

from .grid import Grid
from .ops.spatial import SpatialExpression
from .randomfield import Generator, random_function
from .io.timeseries import TimeSeries, parse_filename
from .parallel.distributed import process_count, process_index
from .utils.debug import logger
from .utils.device import resolve_device
from .utils.exceptions import KSFDException

logMAIN = logger("MAIN")

__all__ = ["initial_values", "start_values", "resume_values"]


def initial_values(clargs, grid, ps, device=None):
    """(state, t0, extras) for a fresh or resumed run.  Counterpart:
    ksfd_tpu/ic.py:initial_values."""
    if clargs.resume or clargs.restart:
        return resume_values(clargs, grid, ps, device=device)
    u, t = start_values(clargs, grid, ps, device=device)
    return u, t, {}


def start_values(clargs, grid, ps, device=None):
    """Fresh start ``(u, t0)``: u a float64 tensor of ``grid.Vshape`` on
    ``device`` (the card unless given).  Counterpart: ksfd_tpu/ic.py:
    start_values.

    rho is rho0 plus a smooth random field on a coarse grid of
    ``randgridnw`` (default nwidth // 4) points per axis: ``srho0``
    (a SpatialExpression) times a standard normal draw from the process
    Generator, plus Nworms / width^dim, interpolated to the grid.  Each
    ligand is its ``U0_<g>_<l>`` where given, else the local steady
    state ``rho * s / gamma`` with s and gamma at their DAG-resolved t0
    values.
    """
    device = resolve_device(device)
    p0 = ps.params0
    rnx = p0["randgridnw"] or ps.nwidth // 4
    rny = p0["randgridnh"] or ps.nheight // 4
    rnz = p0["randgridnd"] or ps.ndepth // 4
    rgrid = Grid(
        dim=ps.dim, width=ps.width, height=ps.height, depth=ps.depth,
        nx=rnx, ny=rny, nz=rnz, dof=1, order=ps.degree,
    )
    values0 = ps.values0
    murho0 = values0["Nworms"] / (ps.width**ps.dim)
    sigma = values0["srho0"]
    if np.isscalar(sigma) and sigma == 0.0:
        rva = np.full(rgrid.Sshape, murho0)
    else:
        rva = SpatialExpression(ps, rgrid, sigma, device="cpu")(
            t=ps.t0).numpy()
        stn = Generator.get_rng().normal(size=rva.shape)
        rva = rva * stn + murho0
    randrho = random_function(grid, randgrid=rgrid, vals=rva)

    def spatial(expr):
        return SpatialExpression(ps, grid, expr, device="cpu")(
            t=ps.t0).numpy()

    u = np.zeros(grid.Vshape)
    if values0["rho0"]:
        u[0] = spatial(values0["rho0"])
    u[0] += randrho
    for dof, lig in enumerate(ps.groups.ligands()):
        name = "U0" + lig.name()[1:]
        v = values0.get(name)
        if v is not None and v is not False and v != "":
            u[dof + 1] = spatial(v)
        else:
            # local steady state U = rho*s/gamma (ksfdsolver2.py:637),
            # s and gamma at their DAG-resolved t0 values
            suffix = lig.name()[1:]  # "_<g>_<l>"
            sval = values0.get("s" + suffix, lig.s)
            gval = values0.get("gamma" + suffix, lig.gamma)
            u[dof + 1] = u[0] * (float(sval) / float(gval))
    return torch.from_numpy(u).to(device), float(ps.t0)


def resume_values(clargs, grid, ps, device=None):
    """Resume (keep t) or restart (t = t0) from the last snapshot of the
    TimeSeries ``clargs.resume`` or ``clargs.restart``: ``(u, t,
    extras)``, u a float64 tensor on ``device`` (the card unless given).
    Counterpart: ksfd_tpu/ic.py:resume_values.

    dt and lastvart (written into ``ps.params0``) come from a ``dt=`` or
    ``lastvart=`` parameter on the command line, else the file's
    '/solver_state' or '/info', else the spacing of the last two
    snapshots, else the default (ksfdsolver2.py:525-578).  A resume's
    extras carry the step counter ``k`` and the noise generator's
    ``rng_state`` where the file has them.  A checkpoint of the JAX
    package holds a JAX key instead, which cannot be continued here:
    the noise chain then restarts from --seed, and a line on stderr
    says so.

    One process: a complete slab set reads as one series (the virtual
    slab view).  Over N ranks (torch.distributed) each rank reads its
    own ``<prefix>s<N>r<k>.h5`` and returns its block, with the block's
    box in ``extras['box']`` (the driver checks it against the block its
    mesh gives the rank); a series of one process is read whole by
    every rank.  A slab of a run on another rank count, another rank's
    slab, or a lone slab read by one process raises naming
    tools/tsmerge.py, as the reference does.
    """
    device = resolve_device(device)
    prefix = clargs.resume or clargs.restart
    nprocs, rank = process_count(), process_index()
    cpf = TimeSeries(
        prefix, grid=grid, mode="r", size=nprocs, rank=rank,
        retries=clargs.series_retries,
        retry_interval=clargs.series_retry_interval,
    )
    full_box = tuple((0, int(n)) for n in grid.nps)
    box = cpf.ranges if cpf.ranges is not None else full_box
    if box != full_box:
        _, fsize, frank, _ = parse_filename(os.path.basename(cpf.filename))
        if nprocs == 1 or fsize != nprocs or frank != rank:
            cpf.close()
            raise KSFDException(
                "cannot resume slab series %r (written by %d ranks) with "
                "%d process(es); merge it first: python -m "
                "ksfd_tpu_torch.tools.tsmerge %s -o <merged>"
                % (cpf.filename, fsize, nprocs, prefix)
            )
    stimes = cpf.sorted_times()
    tlast = stimes[-1]
    state = cpf.load_solver_state()
    jax_key = "solver_state/rng_key" in cpf.tsf
    dtparams = [p for p in clargs.params if p.startswith("dt=")]
    lastvartparams = [p for p in clargs.params if p.startswith("lastvart=")]
    extras = {}
    if clargs.resume:
        t = float(tlast)
        if dtparams:
            ps.params0["dt"] = float(dtparams[0][3:])
        elif "dt" in state:
            ps.params0["dt"] = float(state["dt"])
        elif len(stimes) >= 2:
            ps.params0["dt"] = float(tlast - stimes[-2])
        if lastvartparams:
            ps.params0["lastvart"] = float(lastvartparams[0][9:])
        elif "lastvart" in state:
            ps.params0["lastvart"] = float(state["lastvart"])
        elif len(stimes) >= 2:
            ps.params0["lastvart"] = float(tlast - stimes[-2])
        else:
            ps.params0["lastvart"] = t
        if "rng_state" in state:
            extras["rng_state"] = state["rng_state"]
        elif jax_key:
            print("ksfd: %s holds the JAX package's noise key, which this "
                  "package cannot continue; the noise chain restarts from "
                  "--seed=%d" % (cpf.filename, clargs.seed), file=sys.stderr)
        if "k" in state:
            extras["k"] = int(state["k"])
    else:
        t = float(ps.t0)
        if lastvartparams:
            ps.params0["lastvart"] = float(lastvartparams[0][9:])
        else:
            ps.params0["lastvart"] = float(ps.t0)
    values = np.asarray(cpf.retrieve_by_time(tlast)).reshape(cpf.local_shape)
    cpf.close()
    if box != full_box:
        extras["box"] = box
    logMAIN("resumed at t", t, "from", prefix,
            "box", box if box != full_box else "full")
    return torch.from_numpy(values).to(device), t, extras
