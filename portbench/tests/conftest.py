"""The benchmark's own tests: run them from the root of the checkout with
`python -m pytest portbench/tests`. Card tests carry the `cuda` marker and
skip without a card, decided inside the test."""

import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import spec  # noqa: E402


def tiny(cell: spec.Cell, matrix_std: float | None = None) -> spec.Cell:
    """The cell at a size a CPU test holds: width 64, two layers, ten
    classes, a fifth of each image side and an eighth of the batch
    (features: a quarter of each), the traffic's shapes and mix kept;
    `matrix_std` in place of the configuration's, if given."""
    config = dict(cell.config, hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                  intermediate_size=256, num_labels=10 if cell.config["num_labels"] else 0)
    if matrix_std is not None:
        config["weights"] = dict(cell.config["weights"], matrix_std=matrix_std)
    t = dict(cell.traffic)
    side, share = (4, 4) if t["entry"] == "extract_features" else (5, 8)
    t["images"] = [dict(s, height=s["height"] // side, width=s["width"] // side,
                        count=max(1, s["count"] // share)) for s in t["images"]]
    t["batch"] = sum(s["count"] for s in t["images"])
    return dataclasses.replace(cell, config=config, traffic=t)


@pytest.fixture
def tiny_cell():
    return lambda name, matrix_std=None: tiny(spec.load_cell(name), matrix_std)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
