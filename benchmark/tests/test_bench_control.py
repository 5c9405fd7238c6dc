"""The control of each cell's check: the program's own lower-precision
path (the configuration's ``control_dtype``) on the cell's seeded inputs
fails the cell's limit, and the program in the configuration's precision
passes it. On the card, at sizes a test run holds; the cells' own sizes
are read by ``benchmark/calibrate.py``."""

import time

import pytest

from benchmark import harness

SIZES = {"jacobi7_512.long": [64, 64, 64], "jacobi7_512.step": [64, 64, 64],
         "poisson_511.pcg": [63, 63, 63]}


def limit_of(cell):
    return float(cell.limits.get("relax_err", cell.config.get("tolerance")))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SIZES))
def test_control_fails_and_program_passes(name, cuda_device):
    cell = harness.find_cell(name).with_config(interior=SIZES[name])
    driver = harness.load_driver(cell)
    for seed in (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13):
        ctx = harness.Context(cell=cell, seed=seed, seconds=0.0, trace=False,
                              device=cuda_device,
                              t_origin=time.perf_counter())
        assert driver.reading(ctx) <= limit_of(cell)
        assert driver.reading(ctx, cell.config["control_dtype"]) \
            > limit_of(cell)
