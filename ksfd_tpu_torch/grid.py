"""Uniform periodic Cartesian grid (pure metadata + coordinates).

Counterpart: ksfd_tpu/grid.py:Grid (a copy).  Fields are torch tensors
of shape ``(dof, nx[, ny[, nz]])``.  Axis d has ``n_d`` points at
coordinates ``i * spacing_d`` with ``spacing_d = bounds_d / n_d``.
"""

import numpy as np

from .utils.exceptions import KSFDException

__all__ = ["Grid"]


class Grid:
    def __init__(
        self,
        dim=1,
        width=1.0,
        height=1.0,
        depth=1.0,
        nx=8,
        ny=8,
        nz=8,
        dof=2,
        order=3,
        stencil_width=None,
    ):
        """Create a grid description.

        dim: 1, 2, or 3 spatial dimensions.
        width/height/depth: domain extent per axis (periodic).
        nx/ny/nz: grid points per axis.
        dof: fields per grid point (rho + nligands).
        order: order of the finite-difference approximations; the
            stencil half-width defaults to 1 + order//2
            (KSFD/ksfdgrid.py:155-156).
        """
        if dim not in (1, 2, 3):
            raise KSFDException("Grid dimension must be 1, 2, or 3")
        self._dim = dim
        self._width = float(width)
        self._height = float(height)
        self._depth = float(depth)
        self._bounds = np.array([width, height, depth][:dim], dtype=float)
        self._nx = int(nx)
        self._ny = int(ny)
        self._nz = int(nz)
        self._nps = np.array([nx, ny, nz][:dim], dtype=int)
        self._spacing = self._bounds / self._nps
        self._dof = int(dof)
        self._order = int(order)
        self._stencil_width = (
            int(stencil_width) if stencil_width else 1 + self._order // 2
        )

    # -- scalar properties --------------------------------------------
    @property
    def dim(self):
        return self._dim

    @property
    def width(self):
        return self._width

    @property
    def height(self):
        return self._height

    @property
    def depth(self):
        return self._depth

    @property
    def bounds(self):
        return self._bounds

    @property
    def nx(self):
        return self._nx

    @property
    def ny(self):
        return self._ny

    @property
    def nz(self):
        return self._nz

    @property
    def nps(self):
        return self._nps

    @property
    def spacing(self):
        return self._spacing

    @property
    def dof(self):
        return self._dof

    @property
    def order(self):
        return self._order

    @property
    def stencil_width(self):
        return self._stencil_width

    # -- shapes --------------------------------------------------------
    @property
    def Sshape(self):
        """Shape of a scalar field array."""
        return tuple(int(n) for n in self._nps)

    @property
    def Vshape(self):
        """Shape of the state array (dof leading)."""
        return (self._dof,) + self.Sshape

    @property
    def Cshape(self):
        """Shape of the coordinates array (dim leading)."""
        return (self._dim,) + self.Sshape

    # reference-compatible aliases (global == local in SPMD)
    globalSshape = Sshape
    globalVshape = Vshape
    globalCshape = Cshape
    Slshape = Sshape
    Vlshape = Vshape
    Clshape = Cshape

    @property
    def n_points(self):
        return int(np.prod(self._nps))

    @property
    def n_dofs(self):
        return self._dof * self.n_points

    # -- coordinates ----------------------------------------------------
    def axis_coords(self, d):
        """1D numpy array of point coordinates along axis d."""
        return np.arange(self._nps[d], dtype=float) * self._spacing[d]

    @property
    def coords(self):
        """ndarray of shape Cshape: coords[d] is the d-coordinate field."""
        if not hasattr(self, "_coords"):
            axes = [self.axis_coords(d) for d in range(self._dim)]
            mesh = np.meshgrid(*axes, indexing="ij")
            self._coords = np.stack(mesh, axis=0)
        return self._coords

    # reference-compatible alias
    @property
    def coordsNoGhosts(self):
        return self.coords

    # -- persistence metadata ---------------------------------------------
    def state(self):
        return dict(
            dim=self.dim,
            width=self.width,
            height=self.height,
            depth=self.depth,
            nx=self.nx,
            ny=self.ny,
            nz=self.nz,
            dof=self.dof,
            order=self.order,
            stencil_width=self.stencil_width,
        )

    def __getstate__(self):
        return self.state()

    def __setstate__(self, state):
        self.__init__(**state)

    def __eq__(self, other):
        return isinstance(other, Grid) and self.state() == other.state()

    def __repr__(self):
        return "Grid({})".format(
            ", ".join("{k}={v}".format(k=k, v=v) for k, v in self.state().items())
        )
