"""Carrying problems and arrays across from the JAX package.

- ``problem_from_clargs(clargs, nx, ny, nz=None, device=None)`` builds
  the port's ``(ps, grid, ops)`` from the same argparse ``Namespace``
  that ``ksfd_tpu.SolutionParameters`` takes, as
  ``__graft_entry__._make_problem`` builds the reference's 2D problem,
  ``tests/test_3d.py:_problem`` its 3D one and
  ``tests/manufactured.py:make_problem`` its 1D one.  The dimension comes
  from the parameters (``dim``).  ``with_g=True`` builds the with-G
  problem (ops/operators_with_g.py: the grid and the state carry the G
  field last, nligands+2 fields, as the reference driver's
  ``--with_g`` run and its stored states do); ``flux_form=True`` the
  conservative discretization.
- ``tensors_from_numpy(arrays, device=None)`` turns arrays taken from
  the JAX package as numpy (the state, a base RHS f0, a
  preconditioner's Q/lam) into tensors, keeping dtype and the
  ``(dof, nx, ny[, nz])`` layout; ``numpy_from_tensors`` goes back.

Both run on the card unless ``device`` names another device
(utils/device.py).  Neither side is imported by the other: arrays
cross as numpy.
"""

import numpy as np
import torch

from .grid import Grid
from .models import SolutionParameters
from .ops import PDEOperators, WithGOperators, with_g_grid
from .utils.device import resolve_device

__all__ = ["problem_from_clargs", "tensors_from_numpy", "numpy_from_tensors"]


def problem_from_clargs(clargs, nx, ny=None, nz=None, device=None,
                        with_g=False, flux_form=False):
    """(ps, grid, ops) of a 1D, 2D or 3D problem on a periodic grid
    whose dimension, extent, field count and stencil order come from
    the parameters.  A 2D problem needs ``ny``, a 3D one (``dim=3``)
    ``ny`` and ``nz``; a 1D one reads only ``nx``.  With ``with_g`` the
    grid and ops are the with-G ones (a reference with-G state, numpy
    ``(nligands+2, ...)``, crosses as it is); ``flux_form`` as
    PDEOperators takes it."""
    device = resolve_device(device)
    ps = SolutionParameters(clargs)
    dim = ps.dim
    if dim == 1:
        grid = Grid(dim=1, width=ps.width, nx=nx, dof=ps.nligands + 1,
                    order=ps.degree)
    elif dim == 2:
        grid = Grid(
            dim=2, width=ps.width, height=ps.height, nx=nx, ny=ny,
            dof=ps.nligands + 1, order=ps.degree,
        )
    elif dim == 3:
        if nz is None:
            raise ValueError("a 3D problem needs nz")
        grid = Grid(
            dim=3, width=ps.width, height=ps.height, depth=ps.depth,
            nx=nx, ny=ny, nz=nz, dof=ps.nligands + 1, order=ps.degree,
        )
    else:
        raise ValueError("dim=%d: a grid has 1, 2 or 3 dimensions" % dim)
    if with_g:
        grid = with_g_grid(grid)
        return ps, grid, WithGOperators(ps, grid, flux_form=flux_form,
                                        device=device)
    return ps, grid, PDEOperators(ps, grid, flux_form=flux_form,
                                  device=device)


def _map(fn, arrays):
    if isinstance(arrays, dict):
        return {k: fn(v) for k, v in arrays.items()}
    if isinstance(arrays, (list, tuple)):
        return type(arrays)(fn(v) for v in arrays)
    return fn(arrays)


def tensors_from_numpy(arrays, device=None):
    """An array, or a list/tuple/dict of arrays, as tensors on
    ``device`` with the same dtype, shape and element order.  The data
    is copied: arrays taken from JAX are read-only views."""
    device = resolve_device(device)
    return _map(lambda a: torch.from_numpy(np.array(a)).to(device), arrays)


def numpy_from_tensors(tensors):
    """The inverse of tensors_from_numpy (copies to the host)."""
    return _map(lambda x: x.detach().cpu().numpy(), tensors)
