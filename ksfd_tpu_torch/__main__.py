"""``python -m ksfd_tpu_torch @<optionsfile>``: the port's driver
(ksfd_tpu_torch/ksfdsolver.py:main)."""

import sys

from .ksfdsolver import main

if __name__ == "__main__":
    sys.exit(main())
