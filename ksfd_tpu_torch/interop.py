"""Carrying problems and arrays across from the JAX package.

- ``problem_from_clargs(clargs, nx, ny, device)`` builds the port's
  ``(ps, grid, ops)`` from the same argparse ``Namespace`` that
  ``ksfd_tpu.SolutionParameters`` takes, as
  ``__graft_entry__._make_problem`` builds the reference's.
- ``tensors_from_numpy(arrays, device)`` turns arrays taken from the
  JAX package as numpy (the state, a base RHS f0, a preconditioner's
  Q/lam) into tensors, keeping dtype and the ``(dof, nx, ny)`` layout;
  ``numpy_from_tensors`` goes back.

Neither side is imported by the other: arrays cross as numpy.
"""

import numpy as np
import torch

from .grid import Grid
from .models import SolutionParameters
from .ops import PDEOperators

__all__ = ["problem_from_clargs", "tensors_from_numpy", "numpy_from_tensors"]


def problem_from_clargs(clargs, nx, ny, device="cpu"):
    """(ps, grid, ops) of a 2D problem on an nx x ny periodic grid whose
    extent, field count and stencil order come from the parameters."""
    ps = SolutionParameters(clargs)
    grid = Grid(
        dim=2, width=ps.width, height=ps.height, nx=nx, ny=ny,
        dof=ps.nligands + 1, order=ps.degree,
    )
    return ps, grid, PDEOperators(ps, grid, device=device)


def _map(fn, arrays):
    if isinstance(arrays, dict):
        return {k: fn(v) for k, v in arrays.items()}
    if isinstance(arrays, (list, tuple)):
        return type(arrays)(fn(v) for v in arrays)
    return fn(arrays)


def tensors_from_numpy(arrays, device="cpu"):
    """An array, or a list/tuple/dict of arrays, as tensors on
    ``device`` with the same dtype, shape and element order.  The data
    is copied: arrays taken from JAX are read-only views."""
    return _map(lambda a: torch.from_numpy(np.array(a)).to(device), arrays)


def numpy_from_tensors(tensors):
    """The inverse of tensors_from_numpy (copies to the host)."""
    return _map(lambda x: x.detach().cpu().numpy(), tensors)
