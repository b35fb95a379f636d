"""Command-line tools and measurement probes of the port.

Counterpart: the reference's tools/ directory.  ``problems`` holds the
problem definitions the probes and chip_smoke.py build (the port's
copy of the reference's bench problem); ``probe_coeff_kernel`` is the
counterpart of tools/probe_coeff_kernel.py; ``validate`` of
tools/validate.py (the options93 gate through the Solver); ``flagship``
runs an example through the Solver and ``peakstats`` counts its
aggregates (tools/peakstats.py).
"""
