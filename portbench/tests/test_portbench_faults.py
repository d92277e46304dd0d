"""The comparison catches what a broken timed path gives. A whole run of
each cell at a tiny size on the CPU (the look for a card skipped), with a
fault planted in the program underneath, must come out not correct; the
same run without the fault must come out correct, under the cell's own
limits."""

import pytest
import torch

from portbench import harness

SEED = 2**31 + 77
# classify at the tiny width: matrices drawn 4x wider, so that two images'
# log-probabilities differ about as much as at the published widths
WIDE = 0.08


def _run(cell):
    return harness.run_cell(cell, SEED, 0.05, False, "cpu")


@pytest.mark.parametrize("name", ["vitb14-classify-b64", "vitl14-features-518-b8",
                                  "vitb14-classify-q4_0-b64", "vitb14-classify-int8-b64",
                                  "vitb14-train-f32-b32"])
def test_sound_run_is_correct(tiny_cell, name):
    result = _run(tiny_cell(name, None if name.endswith("f32-b32") else WIDE))
    assert result["correct"], result["checks"]


def _alter_answer(monkeypatch):
    """One image's answer altered where it is produced: its row of the
    model's output takes another image's."""
    from dinov2_tpu_torch.runtime import engine as engine_module

    real = engine_module.DinoEngine._forward

    def forward(self, x, classify):
        out = dict(real(self, x, classify))
        for key in ("probs", "cls_token", "patch_tokens"):
            if key in out:
                t = out[key].clone()
                t[0] = t[1]
                out[key] = t
        return out

    monkeypatch.setattr(engine_module.DinoEngine, "_forward", forward)


def _misorder_groups(monkeypatch):
    """The engine's grouping by size hands back its rows in another order."""
    from dinov2_tpu_torch.runtime import engine as engine_module

    real = engine_module.DinoEngine._group_by_shape

    def group(images):
        return [(list(reversed(idxs)), batch) for idxs, batch in real(images)]

    monkeypatch.setattr(engine_module.DinoEngine, "_group_by_shape", staticmethod(group))


@pytest.mark.parametrize("name, fault", [
    ("vitb14-classify-b64", _alter_answer), ("vitb14-classify-b64", _misorder_groups),
    ("vitb14-classify-q4_0-b64", _alter_answer), ("vitb14-classify-q4_0-b64", _misorder_groups),
    ("vitb14-classify-int8-b64", _alter_answer), ("vitb14-classify-int8-b64", _misorder_groups),
    ("vitl14-features-518-b8", _alter_answer),
])
def test_inference_faults_are_caught(tiny_cell, monkeypatch, name, fault):
    fault(monkeypatch)
    result = _run(tiny_cell(name, WIDE))
    assert not result["correct"], result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["vitb14-classify-b64", "vitl14-features-518-b8",
                                  "vitb14-classify-q4_0-b64", "vitb14-classify-int8-b64"])
def test_a_wrong_answer_is_caught_at_cell_size(card, monkeypatch, name):
    """At the published widths and the cell's own batch on the card, one
    image's answer taking another's fails the cell's limits."""
    from portbench import spec

    _alter_answer(monkeypatch)
    result = harness.run_cell(spec.load_cell(name), SEED, 2.0, False, card)
    assert not result["correct"], result["checks"]


def _unchanged_state(monkeypatch):
    from dinov2_tpu_torch.parallel import train

    monkeypatch.setattr(train.AdamW, "update_", lambda self, params, grads, state: None)


def _half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from dinov2_tpu_torch.parallel import train

    real = train.Trainer.loss_fn

    def loss_fn(self, params, images, labels):
        half = images.shape[0] // 2
        return real(self, params, images[:half], labels[:half])

    monkeypatch.setattr(train.Trainer, "loss_fn", loss_fn)


def _alter_token(monkeypatch):
    """One image's CLS token altered where the forward produces it."""
    from dinov2_tpu_torch.parallel import train

    real = train.forward_features

    def forward_features(*args, **kwargs):
        tokens = real(*args, **kwargs)
        bump = torch.zeros_like(tokens)
        bump[0, 0] = 1.0
        return tokens + bump

    monkeypatch.setattr(train, "forward_features", forward_features)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch, _alter_token])
def test_training_faults_are_caught(tiny_cell, monkeypatch, fault):
    fault(monkeypatch)
    result = _run(tiny_cell("vitb14-train-f32-b32"))
    assert not result["correct"], result["checks"]
