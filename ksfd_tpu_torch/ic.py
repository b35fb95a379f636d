"""Initial values: fresh starts (and, later, checkpoint resume).

Counterpart: ksfd_tpu/ic.py (the reference's ksfdsolver2.py:500-639).
A fresh start is rho0 plus a smooth random field drawn on a coarse grid
(randomfield.py), the ligands given or at their local steady state.
Resuming from a checkpoint reads a TimeSeries, which is I/O: ROADMAP
Queue A item 6 (A8 part 2).
"""

import numpy as np
import torch

from .grid import Grid
from .ops.spatial import SpatialExpression
from .randomfield import Generator, random_function
from .utils.device import resolve_device

__all__ = ["initial_values", "start_values", "resume_values"]


def initial_values(clargs, grid, ps, device=None):
    """(state, t0, extras) for a fresh or resumed run.  Counterpart:
    ksfd_tpu/ic.py:initial_values."""
    if clargs.resume or clargs.restart:
        return resume_values(clargs, grid, ps)
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


def resume_values(clargs, grid, ps):
    """Counterpart: ksfd_tpu/ic.py:resume_values, which reads a
    TimeSeries checkpoint."""
    raise NotImplementedError(
        "not ported yet (see ROADMAP): resume and restart read a "
        "TimeSeries checkpoint, the I/O of Queue A item 6 (A8 part 2)"
    )
