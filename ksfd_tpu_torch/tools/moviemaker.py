"""Render frames of a stored solution (1D curves / 2D images).

Counterpart: tools/moviemaker.py (the reference's moviemaker1.py), on
the port's ``io.Solution``: reads a stored run, plots rho and each
ligand at a series of times (interpolated with -n, or the actual stored
steps with --steps), labels frames with evaluated parameters, writes
numbered PNGs ready for ffmpeg:

    python -m ksfd_tpu_torch.tools.moviemaker -n 100 solutions/run1 \\
        frames/run1
    ffmpeg -r 10 -i frames/run1%04d.png movie.mp4

Field selection (-ss/--subspace by dof index or field name), display
names (--names; a count that does not match the fields exits 2 naming
--names), frame labels (--label/--format_time), color scaling
(--vmin/--vmax), --dpi and -c/--nocolorbar follow the reference's
flags.  It needs matplotlib and h5py (the series); without them it
raises ImportError saying so.  It reads on the host and needs no card.
"""

import argparse
import datetime
import os
import sys

import numpy as np

from ..io.solution import Solution

__all__ = ["main", "field_names", "frame_label"]


def _pyplot():
    """matplotlib's pyplot on the Agg backend, imported on first use."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "moviemaker needs matplotlib, which this Python does not "
            "have") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def field_names(soln):
    names = ["rho"]
    if soln.ps is not None:
        names += [lig.name() for lig in soln.ps.Vgroups.ligands()]
    else:
        names += ["U%d" % i for i in range(1, soln.grid.dof)]
    return names


def frame_label(soln, t, label, format_time):
    """'t = 1:02:03' (timedelta) or '<param> = <value>' per the
    reference's --label/--format_time semantics."""
    val = t
    if soln.ps is not None:
        try:
            val = float(soln.ps.values(t)[label])
        except (KeyError, TypeError):
            val = t
    if label == format_time:
        return "%s = %s" % (
            label, datetime.timedelta(seconds=int(np.round(val)))
        )
    return "%s = %.6g" % (label, val)


def plot_frame(soln, t, fields, opts, label_params=()):
    plt = _pyplot()
    ims = soln.images(t)
    grid = soln.grid
    fig, axes = plt.subplots(
        len(fields), 1, figsize=(8, 2.5 * len(fields)), squeeze=False,
        dpi=opts.dpi,
    )
    title = frame_label(soln, t, opts.label, opts.format_time)
    if label_params and soln.ps is not None:
        vals = soln.ps.values(t)
        title += "  " + ", ".join(
            "%s=%.4g" % (p, vals[p]) for p in label_params if p in vals
        )
    fig.suptitle(title)
    for row, (idx, name) in enumerate(fields):
        ax = axes[row][0]
        img = ims[idx]
        fmin, fmax = float(np.min(img)), float(np.max(img))
        # reference clamp semantics: the requested range never widens
        # the data range (moviemaker1.py:93-103)
        vmin = fmin if opts.vmin is None else max(fmin, opts.vmin)
        vmax = fmax if opts.vmax is None else min(fmax, opts.vmax)
        if grid.dim == 1:
            x = grid.axis_coords(0)
            curve = np.clip(
                img,
                opts.vmin if opts.vmin is not None else -np.inf,
                opts.vmax if opts.vmax is not None else np.inf,
            )
            ax.plot(x, curve)
            ax.set_ylabel(name)
        else:
            im = ax.imshow(
                img.T if grid.dim == 2 else img[..., 0].T,
                origin="lower",
                extent=[0, grid.width, 0, grid.height],
                aspect="auto",
                vmin=vmin,
                vmax=vmax,
                cmap="viridis",
            )
            if not opts.nocolorbar:
                fig.colorbar(im, ax=ax)
            ax.set_ylabel(name)
        ax.set_xlabel("(%7g, %7g)" % (fmin, fmax))
    return fig


def decode_subspace(token, names):
    """A --subspace entry: a dof index or a field name."""
    try:
        return int(token)
    except ValueError:
        pass
    if token in names:
        return names.index(token)
    raise SystemExit(
        "unknown field %r (have %s)" % (token, ", ".join(names))
    )


def main(argv=None):
    parser = argparse.ArgumentParser(description="render solution frames")
    parser.add_argument("-n", "--nframes", type=int, default=100,
                        help="number of interpolated frames")
    parser.add_argument("--steps", action="store_true",
                        help="use stored steps instead of interpolation")
    parser.add_argument("-p", "--param", action="append", default=[],
                        help="parameter names to print on each frame")
    parser.add_argument("--start", type=float, default=None)
    parser.add_argument("--end", type=float, default=None)
    parser.add_argument("-ss", "--subspace", action="append", default=None,
                        help="dof index or field name to plot "
                             "(repeatable; default: all fields)")
    parser.add_argument("--names", type=str, default=None,
                        help="comma-separated display names for the "
                             "plotted fields")
    parser.add_argument("--label", type=str, default="t",
                        help="parameter whose value labels each frame")
    parser.add_argument("--format_time", type=str, default="t",
                        help="when --label equals this, format the "
                             "value as H:MM:SS")
    parser.add_argument("--vmin", type=float, default=None,
                        help="color/axis floor (never widens the data "
                             "range)")
    parser.add_argument("--vmax", type=float, default=None,
                        help="color/axis ceiling")
    parser.add_argument("-d", "--dpi", type=int, default=100)
    parser.add_argument("-c", "--nocolorbar", action="store_true",
                        help="no colorbar on 2D images")
    parser.add_argument("prefix", help="solution prefix (--save value)")
    parser.add_argument("frameprefix", help="output PNG prefix")
    args = parser.parse_args(argv)
    plt = _pyplot()
    soln = Solution(args.prefix, device="cpu")
    t0 = args.start if args.start is not None else soln.tmin
    t1 = args.end if args.end is not None else soln.tmax
    if args.steps:
        times = [t for t in soln.tstimes if t0 <= t <= t1]
    else:
        times = np.linspace(t0, t1, args.nframes)
    names = field_names(soln)
    if args.subspace:
        idxs = [decode_subspace(tok, names) for tok in args.subspace]
    else:
        idxs = list(range(len(names)))
    shown = (
        args.names.split(",")
        if args.names
        else [names[i] for i in idxs]
    )
    if len(shown) != len(idxs):
        print(
            "error: --names gives %d name(s) for %d field(s) (%s)"
            % (len(shown), len(idxs), ",".join(names[i] for i in idxs)),
            file=sys.stderr,
        )
        return 2
    fields = list(zip(idxs, shown))
    outdir = os.path.dirname(args.frameprefix)
    if outdir:
        os.makedirs(outdir, exist_ok=True)
    for fnum, t in enumerate(times):
        fig = plot_frame(soln, t, fields, args, label_params=args.param)
        fname = "{p}{n:04d}.png".format(p=args.frameprefix, n=fnum)
        fig.savefig(fname, dpi=args.dpi)
        plt.close(fig)
        print(fname)
    soln.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
