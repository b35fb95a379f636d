"""The operations the block pc's basis transforms need in a step.

An application of the basis-GEMM pc (solvers/linalg.py:
``forward_products``, ``inverse_products``) transforms every field
forward and back along each axis: along an axis of ``n_d`` points each
output point is a dot product of length ``n_d``, so a transform costs
``2 fields points n_d`` operations an axis and an application ``4
fields points sum_d n_d`` (``8 n^3 fields`` on an ``n^2`` grid, ``12
n^4 fields`` on an ``n^3`` one), whatever kernel runs the products
(cuBLAS, the fused pc of ops/fused_pc.py).  A Rosenbrock step applies
the pc ``stages x sweeps`` times with Richardson or Chebyshev sweeps.
The least time of that work is its operations over the tensor cores'
float32-accurate rate, TF32 split three ways (3xTF32, as the fused pc
runs it).
"""

import json
import math

from bench_cells import ROOT, load_benchmark
from reference.ks import eval_params
from yardstick import TF32_OPS_PER_S

__all__ = ["F32_ACCURATE_OPS_PER_S", "transform_ops", "pc_ops_per_step",
           "grid_dim"]

#: float32-accurate products on the tensor cores: three TF32 products
F32_ACCURATE_OPS_PER_S = TF32_OPS_PER_S / 3


def transform_ops(fields, extents):
    """Operations of one pc application (forward and inverse products
    along every axis) on a grid of ``extents`` points per axis."""
    return 4 * fields * math.prod(extents) * sum(extents)


def pc_ops_per_step(numerics, fields, extents, stages=4):
    """Operations of a step's basis transforms with the block or spectral
    pc, ``numerics.ksp_iters`` applications a stage with Richardson or
    Chebyshev sweeps; None with no pc or with a solve whose count the
    data decides (GMRES).  (The FFT form runs no product: the reader
    finds no GEMM time there.)"""
    if (numerics.pc_type not in ("block", "spectral")
            or numerics.ksp_type not in ("richardson", "chebyshev")):
        return None
    return stages * int(numerics.ksp_iters) * transform_ops(fields, extents)


def grid_dim(config):
    """The grid's dimension of configuration ``config`` (its ``dim``
    line), from its file in BENCHMARK.json; None where it is not
    there."""
    entry = next((c for c in load_benchmark()["configs"]
                  if c["name"] == config), None)
    if entry is None:
        return None
    with open(ROOT / entry["file"]) as fh:
        return int(eval_params(json.load(fh)["params"]).get("dim", 2))
