"""The control comes out not correct: the reference computed in bfloat16,
the precision below the configurations' float32, put in the program's place.

On the CPU at a small size; and, marked ``cuda``, on the card at each
cell's own size and load over three seeds, printing the program's and the
control's readings of every number compared (the readings the limits in
``benchmark/limits/`` were set from):

    python -m pytest benchmark/tests/test_bench_control.py -m cuda -s
"""

import json

import pytest
import torch

from benchmark.core import spec
from benchmark.run import run_cell

CELLS = ["oak4-640x400-deployed.cadence30-map", "oak4-1280x720-flagship.replay-vo"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_cpu(small_cell, name):
    cell, cfg, mix, limits, bench = small_cell(name)
    result = run_cell(cell, cfg, mix, limits, bench, 3000000023, 3.0, False, torch.device("cpu"),
                      log=lambda m: None, control=torch.bfloat16)
    assert result["correct"], result["checks"]
    assert not result["control_correct"], result["control_checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_card(cuda_device, name):
    bench = spec.load_benchmark()
    cell = spec.cell(name, bench)
    cfg, mix, limits = spec.config(cell["config"], bench), spec.traffic(cell["traffic"]), spec.limits(name)
    for seed in (3100000001, 3100000002, 3100000003):
        result = run_cell(cell, cfg, mix, limits, bench, seed, 10.0, False, cuda_device, log=lambda m: None,
                          control=torch.bfloat16)
        print(json.dumps({"cell": name, "seed": seed, "program": result["readings"], "control": result["control_readings"]}))
        assert not result["control_correct"]
