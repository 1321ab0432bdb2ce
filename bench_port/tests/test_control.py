"""The control of each cell, at a size a test run holds: the plain
reference put in the program's place in the precision below the
configuration's (bf16 for the f32 search scoring, fp8 for the bf16 models)
fails at least one of the cell's limits. The card's readings at the cells'
own sizes are in PERF.md; the benchmark's own runs do not run the control."""

from __future__ import annotations

import pytest

from bench_port.lib import common
from bench_port.tests import tiny


@pytest.mark.parametrize("workload", ["colqwen25.search.b1024", "colqwen25.train.b4",
                                      "colsmol.ingest.b8"])
def test_control_fails_a_limit(workload):
    """(On the CPU the training control reads step 1's embeddings only; its
    change after three fp8 steps is read on the card.)"""
    cell = tiny.cell(workload)
    readings = cell.kind_module().control(
        common.RunContext(cell, tiny.SEED, 1.0, False, tiny.CPU))
    limits = cell.traffic["limits"]
    assert readings and set(readings) <= set(limits)
    assert any(readings[k] > limits[k] for k in limits), readings
