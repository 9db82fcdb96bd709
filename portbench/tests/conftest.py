"""Shared helpers of the harness's tests: cells of BENCHMARK.json at sizes
the CPU runs in seconds."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import harness

# the harness's runs on the CPU: a few threads each, as several test
# workers share the machine
torch.set_num_threads(2)

TINY = {"uhd1": {"width": 192, "height": 112, "ring": 3}}
# no warm-up in the CPU runs of the tests
harness.WARM_SECONDS = 0.0


def tiny_cell(name: str) -> harness.Cell:
    """BENCHMARK.json's cell `name` with its traffic cut to TINY."""
    cell = harness.resolve(harness.load_benchmark(), name)
    cell.traffic.update(TINY[cell.traffic["name"]])
    return cell


def cpu_run(cell: harness.Cell, seed: int = 7, seconds: float = 4.0):
    return harness.run_cell(cell, seed, seconds, False, time.perf_counter(),
                            device="cpu")


@pytest.fixture
def cuda_absent():
    if torch.cuda.is_available():
        pytest.skip("checks the run without a card")
