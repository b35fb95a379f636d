"""Aggregate counts of a density field.

Counterpart: tools/peakstats.py:count_peaks_1d and :count_peaks_nd (the
port's own copy: the port imports nothing of the JAX package's tree).
An aggregate is a connected component of {rho >= thresh} on the
periodic grid, thresh = mean + frac * (max - mean); 1D counts periodic
runs, 2D and 3D label with scipy.ndimage and merge labels that touch
across each periodic boundary.
"""

import numpy as np

__all__ = ["count_peaks_1d", "count_peaks_nd"]


def count_peaks_1d(rho, frac=0.5):
    """Connected runs of {rho >= thresh} on a periodic 1D grid."""
    rho = np.asarray(rho)
    mu = float(np.mean(rho))
    thresh = mu + frac * (float(np.max(rho)) - mu)
    mask = rho >= thresh
    if mask.all():
        return 1
    if not mask.any():
        return 0
    # rotate so index 0 is outside a run, then count run starts
    off = int(np.argmin(mask))
    m = np.roll(mask, -off)
    return int(np.sum(m[1:] & ~m[:-1]) + int(m[0]))


def count_peaks_nd(rho, frac=0.5):
    """Connected components of {rho >= thresh}, periodic wrap merged."""
    from scipy import ndimage

    rho = np.asarray(rho)
    if rho.ndim == 1:
        return count_peaks_1d(rho, frac)
    mu = float(np.mean(rho))
    thresh = mu + frac * (float(np.max(rho)) - mu)
    lab, n = ndimage.label(rho >= thresh)
    if n == 0:
        return 0
    parent = list(range(n + 1))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for ax in range(rho.ndim):
        lo = np.take(lab, 0, axis=ax).ravel()
        hi = np.take(lab, -1, axis=ax).ravel()
        for a, b in zip(lo, hi):
            if a and b:
                ra, rb = find(int(a)), find(int(b))
                if ra != rb:
                    parent[rb] = ra
    return len({find(i) for i in range(1, n + 1)})
