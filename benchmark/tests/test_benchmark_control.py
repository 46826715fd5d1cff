"""What decides ``correct`` fails what it has to: the control (the
reference holding its map in bfloat16) and every fault planted in the
program underneath a whole run, at the tests' size on the CPU; a sound run
passes. On the card the same readings come from ``benchmark/control.py``
at the cells' own sizes."""

import pytest
import torch

from benchmark import control as C
from benchmark import harness as H
from benchmark import run as RUN
from benchmark.tests.small import CELLS, context


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_and_the_reference_passes(name):
    ctx = context(name, 2**31 + 101, seconds=1.0)
    driver = H.load_driver(ctx.traffic["driver"])
    rec = driver.run(ctx)
    limits = ctx.traffic["limits"]
    sound = driver.judge(ctx, rec)
    control = driver.judge(ctx, rec, storage=torch.bfloat16)
    assert all(v <= limits[k] for k, v in sound.items()), sound
    assert any(v > 3 * limits[k] for k, v in control.items()), control


@pytest.mark.parametrize("kind", C.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_a_run_with_a_fault_underneath_is_not_correct(name, kind):
    ctx = context(name, 2**31 + 202, seconds=1.0)
    with C.fault(kind):
        correct, _, _, checks, _ = RUN.execute(ctx)
    assert not correct, checks


def test_the_fault_is_taken_out_again():
    from elevation_mapping_cupy_torch import core

    real = core.update_batch_aux
    with C.fault("unchanged"):
        assert core.update_batch_aux is not real
    assert core.update_batch_aux is real
