"""The port's DinoEngine on torch's profiler (CPU, f32, a tiny GGUF): its
five host spans, the counters of uploaded and padded rows, and the one
bracket of last_compute_ms, in each entry."""

import re
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

from dinov2_tpu_torch.io.synthetic import write_synthetic_gguf
from dinov2_tpu_torch.models.config import DinoConfig
from dinov2_tpu_torch.runtime.engine import DinoEngine
from dinov2_tpu_torch.utils.timing import span

TINY = DinoConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                  num_classes=4, patch_size=14, img_size=70)
PORT = Path(__file__).resolve().parent.parent / "dinov2_tpu_torch"
STAGES = ("gather", "pad", "upload", "launch", "fetch")
OUTER = "test.call"


def _images(rng, n, h, w):
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]


def _classify(engine):
    """48 landscape and 16 portrait images in one call: groups of 48 and 16,
    merged into the bucket of 64."""
    rng = np.random.default_rng(0)
    imgs = _images(rng, 48, 28, 42) + _images(rng, 16, 42, 28)
    order = rng.permutation(len(imgs))
    engine.classify_probs([imgs[i] for i in order])


def _features(engine):
    """3 images of one size, padded to the bucket of 4 on the device."""
    engine.extract_features(np.stack(_images(np.random.default_rng(1), 3, 42, 56)))


def _pca(engine):
    """3 images of one size and 2 of another: buckets 4 and 2, padded on the
    device."""
    rng = np.random.default_rng(2)
    engine.pca_visualizations(_images(rng, 3, 42, 56) + _images(rng, 2, 56, 42))


# entry -> (call, the rows it uploads, the padding rows among them: none, the
# padding is made on the device)
ENTRIES = {"classify": (_classify, 64, 0), "features": (_features, 3, 0),
           "pca": (_pca, 5, 0)}


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    path = write_synthetic_gguf(tmp_path_factory.mktemp("ckpt") / "tiny.gguf", TINY, seed=3)
    return DinoEngine(path, dtype=torch.float32, device="cpu")


def _host_events(call):
    """The profiler's host events of `call`, and the range around it."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span(OUTER):
            call()
    events = prof.profiler.kineto_results.events()
    outer = next(e for e in events if e.name() == OUTER)
    return outer, events


def _inside(e, outer):
    return (outer.start_ns() <= e.start_ns()
            and e.start_ns() + e.duration_ns() <= outer.start_ns() + outer.duration_ns())


@pytest.mark.parametrize("entry", ENTRIES)
def test_engine_spans_on_the_profiler(engine, entry):
    """Each stage is an ordinary host operation (not a user annotation, which
    trace readers drop) on the calling thread; pad and upload lie inside a
    launch, gather and fetch outside every launch."""
    outer, events = _host_events(lambda: ENTRIES[entry][0](engine))
    spans = {stage: [e for e in events if e.name() == f"dinov2_tpu_torch.engine.{stage}"]
             for stage in STAGES}
    for stage, found in spans.items():
        assert found, stage
        for e in found:
            assert not e.is_user_annotation(), stage
            assert e.device_type() == torch.autograd.DeviceType.CPU
            assert e.start_thread_id() == outer.start_thread_id(), stage
            assert _inside(e, outer), stage
    launches = spans["launch"]
    for stage in ("pad", "upload"):
        assert all(any(_inside(e, launch) for launch in launches) for e in spans[stage]), stage
    for stage in ("gather", "fetch"):
        assert not any(_inside(e, launch) or _inside(launch, e)
                       for e in spans[stage] for launch in launches), stage


@pytest.mark.parametrize("entry", ENTRIES)
def test_row_counters_advance_by_the_upload(engine, entry):
    call, uploaded, padded = ENTRIES[entry]
    before = (DinoEngine.uploaded_rows, DinoEngine.padded_rows)
    call(engine)
    assert (DinoEngine.uploaded_rows - before[0], DinoEngine.padded_rows - before[1]) == (
        uploaded, padded)


@pytest.mark.parametrize("entry", ENTRIES)
def test_last_compute_ms_brackets_the_padding(engine, entry, monkeypatch):
    """One bracket in every entry: from the start of launch, around the pad,
    to the synchronize."""
    real = DinoEngine._pad_rows

    def slow(batch, target):
        time.sleep(0.05)
        return real(batch, target)

    monkeypatch.setattr(DinoEngine, "_pad_rows", staticmethod(slow))
    engine.last_compute_ms = 0.0
    ENTRIES[entry][0](engine)
    assert engine.last_compute_ms >= 50


@pytest.mark.parametrize("package", ["models", "ops"])
def test_no_span_in_code_that_export_traces(package):
    """torch.export traces models/ and ops/: no span goes there."""
    for path in sorted((PORT / package).rglob("*.py")):
        assert not re.search(r"\bspan\(|_RecordFunctionFast|record_function", path.read_text()), path
