"""ksfd_tpu_torch — the PyTorch/CUDA port of ksfd_tpu.

A second package beside ``ksfd_tpu`` (the JAX reference, which stays
unchanged).  It imports torch and never jax, and it mirrors the
reference's module layout: each docstring names its counterpart as
``ksfd_tpu/<file>:<function>``.

What runs: the driver ``python -m ksfd_tpu_torch @<optionsfile>``
(ksfdsolver.py: the reference's command line, options files and PETSc
blocks, ``--ensemble``; HDF5 series, checkpoints and resume through
io/ where h5py is installed), the host Solver (solvers/solver.py
Solver, with fresh starts and resumes from ic.py and the exact tiers of
solvers/banded_path.py, solvers/direct.py and the dense LU step), the
fixed-dt multistep and the adaptive chunk (solvers/solver.py
make_multistep_fn, make_adaptive_chunk_fn) on 1D, 2D and 3D periodic
problems, with default numerics (a float64 state) and in the float32
fast mode (``NumericsOptions(precision="float32")``), the fused pc
(``pc_pallas``), the float64 GMRES fallback step and
``solvers.EnsembleSolver`` (members batched through the kernels' member
axis), with the float32 kernels of ops/fused_stencil.py,
ops/fused_stencil3d.py and ops/fused_pc.py written in CUDA for Hopper
(csrc/stencil2d.cu, csrc/stencil3d.cu, csrc/pc2d.cu).  The step, the
multistep, the chunk and the host Solver also run SPMD over
torch.distributed ranks, one per box of the grid (``mesh=``,
parallel/: x splits with the halo-slab builds of the stencil kernels,
y and z splits and 1D grids on the unfused step), as do the pc forms,
the flux form, with-G states and ``EnsembleSolver``, and the driver
(``python -m ksfd_tpu_torch``) runs one such rank per process.
Importing the
package sets no global torch state (no default dtype, no default
device): tensors carry their own dtype and device, float64 for the
state as in the reference, float32 in the fast mode.
"""

__version__ = "0.1.0"

from .utils import (  # noqa: E402
    KSFDException,
    NumericsOptions,
    Parameter,
    Parser,
    decode_numerics,
    ParameterList,
    default_parameters,
    find_duplicates,
    log,
    safe_sympify,
    torchify,
)
from .models import (  # noqa: E402
    Ligand,
    LigandGroup,
    LigandGroups,
    SolutionParameters,
)
from .grid import Grid  # noqa: E402

__all__ = [
    "KSFDException",
    "NumericsOptions",
    "Parameter",
    "Parser",
    "decode_numerics",
    "ParameterList",
    "default_parameters",
    "find_duplicates",
    "log",
    "safe_sympify",
    "torchify",
    "Ligand",
    "LigandGroup",
    "LigandGroups",
    "SolutionParameters",
    "Grid",
]
