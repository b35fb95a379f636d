"""On the card: at each cell's own size, the program's check numbers
stay within the cell's limits and the control's (the float32 fast mode
in the program's place, control.py) pass at least one of them.

    python -m pytest benchmark/tests/test_bench_control.py -q   # on the card
"""

import pytest
import torch

import control
from bench_cells import load_benchmark, load_cell


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  load_benchmark()["workloads"]])
def test_the_control_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")
    torch.backends.cuda.matmul.allow_tf32 = False
    limits = load_cell(cell)[1]["limits"]
    res = control.readings(cell, 2 ** 31 + 4242, 3.0, device="cuda",
                           out=lambda s: None)
    assert all(res["program"][k] <= limits[k] for k in limits)
    assert any(res["control"][k] > limits[k] for k in limits)
