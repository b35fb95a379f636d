from .steppers import (
    ARK324,
    ARK436,
    BEULER,
    DIRKTableau,
    ROS34PW2,
    Tableau,
    get_tableau,
    wlte_norm_delta,
)
from .linalg import SpectralPreconditioner, BlockSpectralPreconditioner
from .gmres import (
    chebyshev_solve,
    chebyshev_solve_resid,
    gmres_solve,
    richardson_solve,
    richardson_solve_resid,
)
from .solver import (
    Solver,
    make_adaptive_chunk_fn,
    make_multistep_fn,
    make_step_fn,
)
from .ensemble import EnsembleSolver, shard_members

__all__ = [
    "Tableau",
    "DIRKTableau",
    "ROS34PW2",
    "BEULER",
    "ARK324",
    "ARK436",
    "get_tableau",
    "wlte_norm_delta",
    "SpectralPreconditioner",
    "BlockSpectralPreconditioner",
    "richardson_solve",
    "richardson_solve_resid",
    "chebyshev_solve",
    "chebyshev_solve_resid",
    "gmres_solve",
    "make_step_fn",
    "make_multistep_fn",
    "make_adaptive_chunk_fn",
    "Solver",
    "EnsembleSolver",
    "shard_members",
]
