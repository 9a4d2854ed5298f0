"""On the card, at each cell's own size: the control (the plain reference
in the program's place with its products in the precision below the
configuration's: TF32 for float32, fp8 for bfloat16) comes out not
correct against the cell's limits, on three seeds, while the program
comes out correct.

    python3 -m pytest benchmark/tests -m card

runs these on a machine with a card; elsewhere they skip."""

import json

import pytest

import calibrate
import correct
import tiny

from run import BENCH

SEEDS = (2 ** 31 + 501, 2 ** 31 + 502, 2 ** 31 + 503)
CELLS = {"train.csd.f32.long": calibrate.train_readings,
         "synth.csd.f32.batch": calibrate.synth_readings,
         "train.csd.bf16.long": calibrate.train_readings}


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_control_is_not_correct(cell, card):
    from visinger_tpu_torch.ops import cuda_build

    cuda_build.build_all()
    limits = correct.load_limits(BENCH, cell)
    for seed in SEEDS:
        got = CELLS[cell](tiny.spec(), cell, seed, True)
        print(json.dumps({"seed": seed, **got}))
        assert correct.judge(got["program"], limits)[0], got["program"]
        assert not correct.judge(got["control"], limits)[0], got["control"]
