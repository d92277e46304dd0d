"""The plain reference against the port's CPU path at tiny sizes, both in
float32: what the benchmark's comparison stands on."""

import dataclasses

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.reference import q4_0

CELLS = ["vitb14-classify-b64", "vitl14-features-518-b8", "vitb14-classify-q4_0-b64",
         "vitb14-classify-int8-b64", "vitb14-train-f32-b32"]


@pytest.mark.parametrize("name", CELLS)
def test_reference_follows_the_port_in_f32(tiny_cell, name):
    cell = tiny_cell(name)
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic, dtype="f32"))
    result = harness.run_cell(cell, 2**31 + 12345, 0.05, False, "cpu")
    numbers = {k: v["value"] for k, v in result["checks"].items()}
    assert result["failed"] == 0
    assert all(v < 5e-5 for v in numbers.values()), numbers


def test_q4_0_blocks_are_ggml_bytes():
    """The reference encoder writes the bytes the port's ggml codec writes,
    and decodes them to d * (q - 8)."""
    from dinov2_tpu_torch.io.gguf import GGMLType
    from dinov2_tpu_torch.quant.blocks import dequantize, quantize

    w = (torch.randn(48, 256, generator=torch.Generator().manual_seed(3)) * 0.02).half().float()
    d, qs = q4_0.encode(w)
    raw = q4_0.to_bytes(d, qs)
    assert np.array_equal(raw, quantize(w.numpy(), GGMLType.Q4_0))
    np.testing.assert_array_equal(q4_0.decode(d, qs).numpy(),
                                  dequantize(raw, GGMLType.Q4_0, (48, 256)))


def test_cubic_matrix_is_opencv_inter_cubic():
    """Rows sum to 1; a same-size resize is the identity; a 2x upscale
    samples at (i + 0.5) / 2 - 0.5 with the A = -0.75 kernel."""
    from portbench.reference.model import cubic_matrix

    m = cubic_matrix(7, 13)
    np.testing.assert_allclose(m.sum(axis=1), 1.0, atol=1e-6)
    np.testing.assert_array_equal(cubic_matrix(9, 9), np.eye(9, dtype=np.float32))
    up = cubic_matrix(4, 8)
    # output 4 sits at 1.75: taps 0..3 at distances 1.75, 0.75, 0.25, 1.25
    a = -0.75
    k_near = lambda s: ((a + 2) * s - (a + 3)) * s * s + 1
    k_far = lambda s: ((a * s - 5 * a) * s + 8 * a) * s - 4 * a
    expect = [k_far(1.75), k_near(0.75), k_near(0.25), k_far(1.25)]
    np.testing.assert_allclose(up[4], expect, atol=1e-6)
