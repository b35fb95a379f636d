"""Random numbers and smooth random initial fields.

Counterpart: ksfd_tpu/randomfield.py.

Generator: the process-wide reproducible stream.  The reference wraps a
JAX PRNG key that is split on every draw and saved in checkpoints; here
the stream is an explicit CPU ``torch.Generator`` seeded from the run's
seed, and its state (``current_key``, ``set_key``: the generator's
``get_state``/``set_state``) takes the key's place, so a run resumes bit
for bit within the port.  PyTorch cannot reproduce JAX's draws: the
two packages agree on given values and on the draws' statistics only.

random_function: the smooth random field of the reference, normals on a
coarse grid interpolated with the compact C^1 bump
f(x) = 2x^3 - 3x^2 + 1 as a per-dimension product.  On a uniform
periodic grid the bump's support covers the two nearest coarse vertices
per axis, so the field is a separable gather over the 2^dim corners of
each point's coarse cell.  It runs once per run, on the host (numpy).
"""

import numpy as np
import torch

from .utils.exceptions import KSFDException

__all__ = ["Generator", "random_function", "bump_kernel", "DEFAULT_SEED"]

#: the command line's historical default seed (ksfd_tpu/randomfield.py:44)
DEFAULT_SEED = 793817931


def bump_kernel(x):
    """C^1 compact interpolation kernel 2x^3 - 3x^2 + 1 on [0, 1].
    Counterpart: ksfd_tpu/randomfield.py:bump_kernel."""
    return 2.0 * x**3 - 3.0 * x**2 + 1.0


class Generator:
    """Process-wide reproducible stream over a CPU ``torch.Generator``.
    Counterpart: ksfd_tpu/randomfield.py:Generator."""

    _gen = None
    _seed = None

    def __init__(self, seed=None):
        if seed is None and type(self)._gen is not None:
            return  # already initialized
        if seed is None:
            seed = DEFAULT_SEED
        type(self)._seed = int(seed)
        type(self)._gen = torch.Generator().manual_seed(int(seed))

    def __call__(self):
        return self

    @classmethod
    def get_rng(cls):
        if cls._gen is None:
            cls()
        return cls()

    @classmethod
    def generator(cls):
        """The underlying ``torch.Generator`` (draws advance it)."""
        if cls._gen is None:
            cls()
        return cls._gen

    @classmethod
    def set_key(cls, state):
        """Restore the stream from a ``current_key()`` state (resume)."""
        cls.generator().set_state(state)

    @classmethod
    def current_key(cls):
        """The stream's state, a uint8 tensor (what a checkpoint keeps)."""
        return cls.generator().get_state()

    def normal(self, loc=0.0, scale=1.0, size=()):
        draw = torch.randn(tuple(size), generator=self.generator(),
                           dtype=torch.float64)
        return draw.numpy() * scale + loc


def _axis_weights(nfine, hfine, ncoarse, hcoarse):
    """Per-axis interpolation: fine index -> (i0, i1, w0, w1).
    Counterpart: ksfd_tpu/randomfield.py:_axis_weights."""
    x = np.arange(nfine) * hfine
    u = x / hcoarse
    i0 = np.floor(u + 1e-12).astype(int)
    frac = u - i0
    i0 = i0 % ncoarse
    i1 = (i0 + 1) % ncoarse
    w0 = bump_kernel(np.clip(frac, 0.0, 1.0))
    w1 = bump_kernel(np.clip(1.0 - frac, 0.0, 1.0))
    return i0, i1, w0, w1


def random_function(grid, randgrid=None, vals=None, mu=0.0, sigma=0.01):
    """Smooth random scalar field on ``grid``, a numpy array of shape
    ``grid.Sshape``.  Counterpart: ksfd_tpu/randomfield.py:
    random_function.

    randgrid: the coarse Grid the random values live on (default grid).
    vals: values of shape randgrid.Sshape (numpy or a tensor); drawn
        N(mu, sigma) from the process Generator when not given.
    """
    if randgrid is None:
        randgrid = grid
    if grid.dim != randgrid.dim:
        raise KSFDException("randgrid and grid must have the same dimension")
    if vals is None:
        vals = Generator.get_rng().normal(
            loc=mu, scale=sigma, size=randgrid.Sshape
        )
    if isinstance(vals, torch.Tensor):
        vals = vals.detach().cpu().numpy()
    vals = np.asarray(vals, dtype=float).reshape(randgrid.Sshape)
    if tuple(randgrid.nps) == tuple(grid.nps) and np.allclose(
        randgrid.spacing, grid.spacing
    ):
        return vals.copy()
    dim = grid.dim
    axes = [
        _axis_weights(
            grid.nps[d], grid.spacing[d], randgrid.nps[d], randgrid.spacing[d]
        )
        for d in range(dim)
    ]
    out = np.zeros(grid.Sshape, dtype=float)
    # sum over the 2^dim corners of the coarse cell holding each point
    for corner in range(2**dim):
        idx = []
        w = 1.0
        for d in range(dim):
            i0, i1, w0, w1 = axes[d]
            upper = (corner >> d) & 1
            shape = [1] * dim
            shape[d] = -1
            idx.append((i1 if upper else i0).reshape(shape))
            w = w * (w1 if upper else w0).reshape(shape)
        out += w * vals[tuple(np.broadcast_arrays(*idx))]
    return out
