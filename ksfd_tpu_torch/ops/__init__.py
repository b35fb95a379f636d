from .stencil import (
    deriv_apply,
    deriv_coeffs,
    grad_apply,
    laplacian_apply,
    laplacian_symbol,
    shift,
)
from .spatial import SpatialExpression
from .operators import PDEOperators
from .operators_with_g import WithGOperators, with_g_grid

__all__ = [
    "deriv_apply",
    "deriv_coeffs",
    "grad_apply",
    "laplacian_apply",
    "laplacian_symbol",
    "shift",
    "SpatialExpression",
    "PDEOperators",
    "WithGOperators",
    "with_g_grid",
]
