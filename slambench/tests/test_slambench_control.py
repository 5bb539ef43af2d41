"""The control on the card: the plain reference computed in bfloat16 in
the program's place must come out not correct, at each cell's own size,
on three seeds.  (TF32 products, the step below the program's float32
with TF32 off, read as the program does: ``PERF.md``.)  The benchmark's
own runs never run it."""

import pytest

from slambench import harness

SEEDS = (1003, 1006, 2 ** 31 + 11)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["console320-explore", "console320-look"])
@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_not_correct(card, cell, seed):
    out = harness.run_cell(cell, seed, 10.0, False, device=card,
                           control="bf16")
    assert not out["correct"], out["checks"]
