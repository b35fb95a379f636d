"""Merge TimeSeries files into a single series.

Counterpart: tools/tsmerge.py, on the port's TimeSeries and Gatherer
(ksfd_tpu_torch/io/timeseries.py).  Combines per-process files and/or
the per-step checkpoints of interrupted runs into one '<out>s1r0.h5'.
'/info' metadata is copied from the first input.

Usage:
    python -m ksfd_tpu_torch.tools.tsmerge in_prefix [...] -o out_prefix
    python -m ksfd_tpu_torch.tools.tsmerge 'checks/run_@' -o solutions/rebuilt
A trailing '@' on a prefix expands to every checkpoint '<prefix><k>_'
found on disk, in step order (lastcheckpoint.py gather syntax).
"""

import argparse
import glob
import os
import re
import sys

import numpy as np

from ..io import Gatherer, TimeSeries


def expand_at(prefix):
    """Expand the '@' gather syntax.  Counterpart:
    tools/tsmerge.py:expand_at.

    'checks/run@' -> every checkpoint ['checks/run_0_', ...];
    'checks/run_5_@' (lastcheckpoint --gather output) -> that one
    checkpoint prefix (its per-rank files are gathered by Gatherer).
    """
    if not prefix.endswith("@"):
        return [prefix]
    base = prefix[:-1].rstrip("_")
    pat = re.compile(
        re.escape(os.path.basename(base)) + r"_(\d+)_s\d+r\d+\.h5$"
    )
    found = {}
    for f in glob.glob(base + "_*_s*r*.h5"):
        m = pat.fullmatch(os.path.basename(f))
        if m:
            found[int(m.group(1))] = base + "_" + m.group(1) + "_"
    if found:
        return [found[k] for k in sorted(found)]
    # single-series form: '<prefix>_<k>_@' or '<prefix>@' with rank
    # files directly under the bare prefix
    bare = prefix[:-1]
    if glob.glob(bare + "s*r*.h5"):
        return [bare]
    return []


def main(argv=None):
    parser = argparse.ArgumentParser(description="merge KSFD TimeSeries")
    parser.add_argument("-o", "--out", required=True,
                        help="output prefix")
    parser.add_argument("--start", type=float, default=None,
                        help="earliest time to include")
    parser.add_argument("--end", type=float, default=None,
                        help="latest time to include")
    parser.add_argument("inputs", nargs="+", help="input prefixes")
    args = parser.parse_args(argv)
    prefixes = [p for inp in args.inputs for p in expand_at(inp)]
    if not prefixes:
        parser.error("no inputs found")
    out = None
    info_copied = False
    for prefix in prefixes:
        for ts in Gatherer(prefix):
            if out is None:
                grid = ts.grid
                out = TimeSeries(args.out, grid=grid, mode="w")
            if not info_copied and len(ts.info):
                for key in ts.info:
                    out.try_to_set("/info/" + key, ts.info[key][()])
                info_copied = True
            ranges = ts.ranges
            full = tuple((0, int(n)) for n in ts.grid.nps)
            for t in ts.sorted_times():
                if args.start is not None and t < args.start:
                    continue
                if args.end is not None and t > args.end:
                    continue
                data = np.asarray(ts.retrieve_by_time(t))
                if ranges != full and data.shape == ts.grid.Vshape:
                    # full-shape store holding only the owned slab
                    slc = (slice(None),) + tuple(
                        slice(*r) for r in ranges
                    )
                    data = data[slc]
                out.store_slice(ranges, data, t)
            ts.close()
    if out is not None:
        out.close()
        print("merged {n} series into {o}s1r0.h5".format(
            n=len(prefixes), o=args.out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
