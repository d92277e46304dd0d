"""The control of each cell comes out not correct on the card: the plain
reference a precision below the configuration's (float8 e4m3 operands for
bf16, TF32 products for float32, int4 codes for W8A8 int8), at the cell's
own size, on three seeds, held to the cell's limits; readings of context
are not held. The training cell's planted faults likewise."""

import pytest

from portbench import check, control, spec

SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["vitb14-classify-b64", "vitl14-features-518-b8",
                                  "vitb14-classify-q4_0-b64", "vitb14-classify-int8-b64"])
def test_lower_precision_fails_the_inference_limits(card, name):
    cell = spec.load_cell(name)
    for seed in SEEDS:
        for kind, numbers in control._inference_control(cell, seed, card).items():
            if kind.startswith("control:"):
                assert not check.judge(numbers, cell.limits["limits"]), (seed, kind, numbers)


@pytest.mark.cuda
def test_tf32_and_the_faults_fail_the_training_limits(card):
    cell = spec.load_cell("vitb14-train-f32-b32")
    for seed in SEEDS:
        for kind, numbers in control._training_control(cell, seed, card).items():
            assert not check.judge(numbers, cell.limits["limits"]), (seed, kind, numbers)
