"""Print the prefix of the newest checkpoint of a run.

Counterpart: tools/lastcheckpoint.py (the port's copy; it reads only
file names and zip archives).  Globs '<prefix>_<k>_s<size>r<rank>.h5'
files and prints the prefix of the max-k checkpoint, for scripted
resume pipelines.

Zip-mode runs (--check=<prefix>.zip) archive every checkpoint file
into '<prefix>s<size>r<rank>.zip' and delete the loose .h5
(ksfd_tpu_torch/io/monitors.py:make_checkpoint_monitor); this tool accepts either
the literal --check value (with '.zip') or the bare prefix, scans the
archives by member name, and — unless --no-extract — extracts the
newest checkpoint's files back to disk so the printed prefix is
directly usable by --resume/--restart and tsmerge.

Usage:
    python -m ksfd_tpu_torch.tools.lastcheckpoint checks/run
    python -m ksfd_tpu_torch.tools.lastcheckpoint checks/run.zip
    python -m ksfd_tpu_torch.tools.lastcheckpoint --gather checks/run
"""

import argparse
import glob
import os
import re
import sys
import zipfile


def last_checkpoint(prefix, extract=True):
    """Newest checkpoint prefix of --check=<prefix>, or None.
    Counterpart: tools/lastcheckpoint.py:last_checkpoint.

    Checkpoint k of a run lives at '<prefix>_<k>_s<size>r<rank>.h5',
    either loose on disk or archived in '<prefix>s<size>r<rank>.zip'.
    When the newest k exists only inside archives and ``extract`` is
    true, its member files (every rank's) are extracted next to the
    archives so the returned prefix points at real files.
    """
    if prefix.endswith(".zip"):
        prefix = prefix[:-4]
    pat = re.compile(
        re.escape(os.path.basename(prefix)) + r"_(\d+)_s\d+r\d+\.h5$"
    )
    best = None
    for f in glob.glob(prefix + "_*_s*r*.h5"):
        m = pat.fullmatch(os.path.basename(f))
        if m:
            k = int(m.group(1))
            if best is None or k > best:
                best = k
    zbest = None
    for zf in glob.glob(prefix + "s*r*.zip"):
        try:
            names = zipfile.ZipFile(zf).namelist()
        except (OSError, zipfile.BadZipFile):
            continue
        for name in names:
            m = pat.fullmatch(os.path.basename(name))
            if m:
                k = int(m.group(1))
                if zbest is None or k > zbest:
                    zbest = k
    if zbest is not None and (best is None or zbest > best):
        best = zbest
        if extract:
            target_dir = os.path.dirname(os.path.abspath(prefix))
            for zfname in glob.glob(prefix + "s*r*.zip"):
                try:
                    with zipfile.ZipFile(zfname) as z:
                        for name in z.namelist():
                            m = pat.fullmatch(os.path.basename(name))
                            if not (m and int(m.group(1)) == best):
                                continue
                            dest = os.path.join(
                                target_dir, os.path.basename(name)
                            )
                            if os.path.exists(dest):
                                continue
                            with z.open(name) as src, open(dest, "wb") as out:
                                out.write(src.read())
                except (OSError, zipfile.BadZipFile):
                    continue
    if best is None:
        return None
    return prefix + "_" + str(best) + "_"


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="find the last checkpoint of a run"
    )
    parser.add_argument("--gather", action="store_true",
                        help="print in '@' gather syntax")
    parser.add_argument("--no-extract", action="store_true",
                        help="do not extract zipped checkpoints to disk")
    parser.add_argument("prefix", help="checkpoint prefix (--check value)")
    args = parser.parse_args(argv)
    result = last_checkpoint(args.prefix, extract=not args.no_extract)
    if result is None:
        print("no checkpoints found for " + args.prefix, file=sys.stderr)
        return 1
    print(result + "@" if args.gather else result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
