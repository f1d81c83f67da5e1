"""The precision control comes out not correct: the reference computed with
float8 operands, in the program's place, judged by the fp32 reference at
every position of the same prompts and served tokens. At the smoke presets'
sizes on the CPU, with the program in fp32 (which reads next to nothing)
and the smoke cells' limits. On the card, ``perfbench/calibrate.py`` reads
the same control at each cell's own size (``PERF.md``)."""

import pytest
import torch
from conftest import SMOKE, SMOKE_LIMITS

from yardstick import runner

CPU = torch.device("cpu")


@pytest.mark.parametrize("cell", list(SMOKE))
def test_control_is_not_correct(smoke_root, cell):
    c = runner.load_cell(cell, root=smoke_root)
    with torch.inference_mode():
        driver = runner.setup(c, 2**31 + 7, CPU)
        driver.run(0.3)
        checked = driver.check(c.reference, control=True)
    sound, _ = runner.compare(checked["numbers"], SMOKE_LIMITS)
    control, compared = runner.compare(checked["control"], SMOKE_LIMITS)
    assert sound is True
    assert control is False, compared
