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

__all__ = [
    "deriv_apply",
    "deriv_coeffs",
    "grad_apply",
    "laplacian_apply",
    "laplacian_symbol",
    "shift",
    "SpatialExpression",
    "PDEOperators",
]
