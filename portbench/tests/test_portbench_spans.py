"""The readers of the program's host spans and row counters: their
arithmetic on a fixture trace, nothing read from a program without them,
and the port's own spans through a traced run of each cell at a tiny size
on the CPU."""

from types import SimpleNamespace

import pytest
import torch

from portbench import harness, spans
from portbench.trace import Activity, Trace

SEED = 2**31 + 91
ENGINE = "dinov2_tpu_torch.engine."


def _span_trace():
    """Two calls in a 10000 ns window; the device busy in four intervals,
    idle in five gaps: [0, 1000] in gather (a gather nested in it ends
    before the gap's middle), [2000, 3000] in pad inside launch (an aten
    operation inside pad), [4000, 6000] in launch alone, [7000, 8000] in
    fetch (a port operator, not a span, inside it), [9000, 10000] in no
    span. No gap's middle lies in upload."""
    device = [Activity("kernel", lo, lo + 1000) for lo in (1000, 3000, 6000, 8000)]
    host = [Activity(ENGINE + "gather", 0, 900), Activity(ENGINE + "gather", 100, 400),
            Activity(ENGINE + "launch", 1000, 5200), Activity(ENGINE + "pad", 2200, 2800),
            Activity("aten::copy_", 2300, 2700), Activity(ENGINE + "upload", 5300, 5900),
            Activity(ENGINE + "fetch", 7200, 7800),
            Activity("dinov2_tpu_torch::slab_layer_block", 7400, 7600)]
    return Trace(calls=2, start_ns=0, end_ns=10000, device=device, host=host)


def _read(name, trace):
    return harness.load_reader(name)(SimpleNamespace(trace=trace))


@pytest.mark.parametrize("kind", ["infer", "features"])
def test_engine_host_ms_is_the_union_of_the_spans(kind):
    """gather 900 (its nested gather not counted twice) + pad 600 + upload
    600 + fetch 600 over 2 calls; launch is not an engine host span."""
    assert _read(f"engine_host_ms.{kind}", _span_trace()) == pytest.approx(2700 / 2 / 1e6)


@pytest.mark.parametrize("kind", ["infer", "features"])
def test_engine_idle_ms_takes_the_innermost_span(kind):
    """The gaps in gather, pad and fetch: 3000 ns over 2 calls. The gap in
    pad counts for pad and not for the launch around it; the operator in
    fetch and the aten operation in pad are not spans."""
    assert _read(f"engine_idle_ms.{kind}", _span_trace()) == pytest.approx(3000 / 2 / 1e6)


def test_launch_idle_ms_leaves_out_the_spans_nested_in_it():
    """Only the gap whose innermost span is launch itself: 2000 ns."""
    assert _read("launch_idle_ms.infer", _span_trace()) == pytest.approx(2000 / 2 / 1e6)


def test_span_idle_never_passes_the_idle_time():
    tr = _span_trace()
    idle = tr.window_ns - tr.busy_ns()
    assert [hi - lo for lo, hi in spans.idle_gaps(tr)] == [ns for _, ns in tr.idle_gaps()]
    both = _read("engine_idle_ms.infer", tr) + _read("launch_idle_ms.infer", tr)
    assert both * 1e6 * tr.calls == 5000 < idle == 6000


@pytest.mark.parametrize("name", ["engine_host_ms.infer", "engine_host_ms.features",
                                  "engine_idle_ms.infer", "engine_idle_ms.features",
                                  "launch_idle_ms.infer"])
def test_span_readers_find_nothing_without_spans(name):
    """No trace; a trace without spans; a trace with a port operator but no
    span (a program that has no spans)."""
    assert _read(name, None) is None
    plain = Trace(calls=1, start_ns=0, end_ns=100, device=[Activity("kernel", 10, 20)],
                  host=[Activity("aten::to", 0, 50)])
    assert _read(name, plain) is None
    plain.host.append(Activity("dinov2_tpu_torch::flash_attention", 20, 40))
    assert _read(name, plain) is None


def test_padded_rows_pct_reads_the_engine_counters(monkeypatch):
    from dinov2_tpu_torch.runtime.engine import DinoEngine

    monkeypatch.setattr(DinoEngine, "uploaded_rows", 80)
    monkeypatch.setattr(DinoEngine, "padded_rows", 16)
    assert _read("padded_rows_pct.infer", None) == pytest.approx(20.0)
    monkeypatch.setattr(DinoEngine, "uploaded_rows", 0)
    assert _read("padded_rows_pct.infer", None) is None
    monkeypatch.delattr(DinoEngine, "uploaded_rows")
    assert _read("padded_rows_pct.infer", None) is None


NEW = {"vitb14-classify-b64": ["engine_host_ms.infer", "engine_idle_ms.infer",
                               "launch_idle_ms.infer", "padded_rows_pct.infer"],
       "vitb14-classify-q4_0-b64": ["engine_host_ms.infer", "engine_idle_ms.infer",
                                    "launch_idle_ms.infer", "padded_rows_pct.infer"],
       "vitb14-classify-int8-b64": ["engine_host_ms.infer", "engine_idle_ms.infer",
                                    "launch_idle_ms.infer", "padded_rows_pct.infer"],
       "vitl14-features-518-b8": ["engine_host_ms.features", "engine_idle_ms.features"],
       "vitb14-train-f32-b32": []}


@pytest.mark.parametrize("name", NEW)
def test_a_traced_run_reads_the_port_spans(tiny_cell, monkeypatch, name):
    """A --trace 1 run of the cell at a tiny size on the CPU (the card's
    synchronize made a no-op): the port's spans reach the trace's host
    operations, and the cell's line carries exactly its new metrics; the
    engine uploads the tiny classify batch (6 + 2 images) unpadded and
    makes the size buckets' padding on the device, so the share of padded
    rows it uploads reads 0, as in the cell's 48 + 16."""
    from dinov2_tpu_torch.runtime.engine import DinoEngine

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *args: None)
    monkeypatch.setattr(DinoEngine, "uploaded_rows", 0)  # this run's rows alone
    monkeypatch.setattr(DinoEngine, "padded_rows", 0)
    result = harness.run_cell(tiny_cell(name), SEED, 0.05, True, "cpu")
    new = {m for m in result["metrics"]
           if m.split(".")[0] in {"engine_host_ms", "engine_idle_ms", "launch_idle_ms",
                                  "padded_rows_pct"}}
    assert new == set(NEW[name])
    if "padded_rows_pct.infer" in new:
        assert result["metrics"]["padded_rows_pct.infer"]["value"] == 0.0
    for m in new:
        assert result["metrics"][m]["value"] >= 0
