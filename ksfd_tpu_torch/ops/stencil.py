"""Finite-difference stencil coefficients on the periodic uniform grid.

Coefficients are generated with sympy's
``Derivative.as_finite_difference`` over the star stencil of half-width
``sw`` (offsets -sw..sw), matching the reference's construction
(KSFD/ksfdsym.py:391-436 via KSFD/ksfdgrid.py:155-156: sw = 1 +
degree//2).  Counterpart: ksfd_tpu/ops/stencil.py.  The coefficient
and eigenbasis functions are numpy and copied unchanged; the periodic
shift becomes ``torch.roll``.  The same coefficients are printed into
the CUDA kernels by ops/codegen.py.

Also provides the exact Fourier symbols of the discrete operators,
used by the spectral preconditioner: on a periodic uniform grid the
stencil operator is diagonalized by the DFT, with eigenvalue
``sum_j c_j * exp(2*pi*i*j*m/n)`` at mode m.
"""

import functools

import numpy as np
import sympy as sy

__all__ = [
    "deriv_coeffs",
    "deriv_apply",
    "grad_apply",
    "laplacian_apply",
    "laplacian_symbol",
    "laplacian_eigs",
    "laplacian_eigendecomp",
    "real_dft_basis",
    "shift",
]


@functools.lru_cache(maxsize=None)
def _deriv_coeffs_unit(deriv_order, sw):
    """FD coefficients for d^order/dx^order on offsets -sw..sw, h=1."""
    x = sy.Symbol("x")
    f = sy.Function("f")
    points = [sy.Integer(j) for j in range(-sw, sw + 1)]
    expr = sy.Derivative(f(x), (x, deriv_order)).as_finite_difference(
        points=points, x0=sy.Integer(0)
    )
    coeffs = np.zeros(2 * sw + 1, dtype=float)
    expr = sy.expand(expr)
    for j in range(-sw, sw + 1):
        c = expr.coeff(f(sy.Integer(j)))
        coeffs[j + sw] = float(c)
    return coeffs


def deriv_coeffs(deriv_order, sw, h=1.0):
    """Coefficients c_j (j=-sw..sw) with grid spacing ``h`` applied."""
    return _deriv_coeffs_unit(deriv_order, sw) / float(h) ** deriv_order


def shift(field, offset, axis):
    """Periodic stencil read: value of ``field`` at grid offset +offset.

    field(x_i + offset*h) == field[i + offset] with wraparound, i.e.
    torch.roll(field, -offset, axis).
    """
    import torch

    return torch.roll(field, -offset, dims=axis)


def deriv_apply(field, d, spacing, sw, first_axis=0, order=1):
    """d^order/dx_d^order of a scalar field via the FD stencil."""
    cs = deriv_coeffs(order, sw, spacing[d])
    axis = first_axis + d
    acc = None
    for j in range(-sw, sw + 1):
        # python float: keeps the field dtype
        c = float(cs[j + sw])
        if c == 0.0:
            continue
        term = c * shift(field, j, axis)
        acc = term if acc is None else acc + term
    return acc


def grad_apply(field, spacing, sw, first_axis=0):
    """Gradient components of a scalar field via the FD stencil.

    Returns a list of ``ndim`` arrays, where ndim counts the axes of
    ``field`` starting at ``first_axis``.
    """
    ndim = field.ndim - first_axis
    return [
        deriv_apply(field, d, spacing, sw, first_axis=first_axis, order=1)
        for d in range(ndim)
    ]


def laplacian_apply(field, spacing, sw, first_axis=0):
    """Laplacian of a scalar field via the FD stencil."""
    ndim = field.ndim - first_axis
    acc = None
    for d in range(ndim):
        term = deriv_apply(
            field, d, spacing, sw, first_axis=first_axis, order=2
        )
        acc = term if acc is None else acc + term
    return acc


def laplacian_eigs(n, h, sw):
    """Eigenvalues of the periodic 1D second-derivative stencil.

    Mode k (0..n-1) has eigenvalue c_0 + 2*sum_{j>0} c_j cos(2 pi j k/n)
    — shared by the cos and sin eigenvectors of the circulant operator.
    """
    cs = deriv_coeffs(2, sw, h)
    k = np.arange(n)
    lam = np.full(n, cs[sw])
    for j in range(1, sw + 1):
        lam = lam + 2.0 * cs[sw + j] * np.cos(2.0 * np.pi * j * k / n)
    return lam


def real_dft_basis(n):
    """Orthonormal real-DFT basis Q (n x n) of symmetric circulants.

    Column 2k/2k+1 hold the cos/sin pair of frequency k; Q is
    orthogonal (Q Q^T = I) so transforms are plain matmuls — the
    MXU-friendly, float64-safe alternative to an FFT (TPU XLA has no
    f64 FFT, and the CPU FFT thunk is layout-fragile under SPMD).
    The column ordering matches ``dft_mode_freqs(n)``.
    """
    i = np.arange(n)[:, None]
    cols = []
    freqs = []
    cols.append(np.full((n, 1), 1.0 / np.sqrt(n)))
    freqs.append(0)
    kmax = n // 2
    for k in range(1, (n + 1) // 2):
        ang = 2.0 * np.pi * k * i / n
        cols.append(np.sqrt(2.0 / n) * np.cos(ang))
        freqs.append(k)
        cols.append(np.sqrt(2.0 / n) * np.sin(ang))
        freqs.append(k)
    if n % 2 == 0:
        cols.append(((-1.0) ** i) / np.sqrt(n))
        freqs.append(kmax)
    Q = np.concatenate(cols, axis=1)
    return Q, np.asarray(freqs)


def laplacian_eigendecomp(n, h, sw):
    """(Q, lam_per_column) such that L = Q diag(lam) Q^T exactly."""
    Q, freqs = real_dft_basis(n)
    lam_k = laplacian_eigs(n, h, sw)
    return Q, lam_k[freqs]


def laplacian_symbol(nps, spacing, sw):
    """Exact DFT eigenvalues of the discrete Laplacian.

    Returns a real ndarray of shape ``nps`` (with the last axis
    truncated to n//2+1 for use with rfftn): symbol[m] such that
    ``ifftn(symbol * fftn(u)) == laplacian_apply(u)`` exactly.

    The per-axis symbol of the symmetric second-derivative stencil is
    ``c_0 + 2*sum_{j>0} c_j cos(2 pi j m / n)``.
    """
    ndim = len(nps)
    axes = [
        laplacian_eigs(int(nps[d]), spacing[d], sw) for d in range(ndim)
    ]
    # rfft truncation on the last axis
    axes[-1] = axes[-1][: nps[-1] // 2 + 1]
    total = axes[0]
    for d in range(1, ndim):
        total = total[..., None] + axes[d]
    return total
