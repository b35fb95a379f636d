"""Dump per-frame field arrays and parameter values to an HDF5 file.

Counterpart: tools/h5images.py (the reference's h5images.py), on the
port's ``io.Solution``: for downstream analysis in other tools (e.g.
Mathematica), writes datasets 'images<n>' with attrs t and a JSON
params string, plus 'times' and 'coords'.

    python -m ksfd_tpu_torch.tools.h5images -n 100 solutions/run1 \\
        run1_images.h5

It needs h5py; without it it raises ImportError saying so.  It reads
on the host and needs no card.
"""

import argparse
import json
import sys

import numpy as np

from ..io.solution import Solution

__all__ = ["main"]


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "h5images needs h5py, which this Python does not have") from e
    return h5py


def main(argv=None):
    parser = argparse.ArgumentParser(description="dump solution images")
    parser.add_argument("-n", "--nframes", type=int, default=100)
    parser.add_argument("--steps", action="store_true",
                        help="use stored steps instead of interpolation")
    parser.add_argument("-s", "--start", type=float, default=None)
    parser.add_argument("-e", "--end", type=float, default=None)
    parser.add_argument("prefix")
    parser.add_argument("outfile")
    args = parser.parse_args(argv)
    h5py = _h5py()
    soln = Solution(args.prefix, device="cpu")
    t0 = args.start if args.start is not None else soln.tmin
    t1 = args.end if args.end is not None else soln.tmax
    if args.steps:
        times = [t for t in soln.tstimes if t0 <= t <= t1]
    else:
        times = np.linspace(t0, t1, args.nframes)
    with h5py.File(args.outfile, "w") as out:
        out["times"] = np.asarray(times, dtype=float)
        out["coords"] = np.asarray(soln.grid.coords)
        for n, t in enumerate(times):
            ims = soln.images(t)
            ds = out.create_dataset("images%d" % n, data=np.asarray(ims))
            ds.attrs["t"] = t
            if soln.ps is not None:
                vals = soln.ps.values(t)
                ds.attrs["params"] = json.dumps(
                    {k: v for k, v in vals.items()
                     if isinstance(v, (int, float, bool))}
                )
    soln.close()
    print(args.outfile)
    return 0


if __name__ == "__main__":
    sys.exit(main())
