"""The work counters, the metric arithmetic on a fixture trace, the traffic
generator, and the run's refusal without a card."""

import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import harness, spec, trace, traffic, work
from portbench.readers import roofline
from portbench.trace import Activity, Trace

ROOT = spec.ROOT


def test_forward_flops_by_hand():
    """ViT-B/14 at T=257 with its head: 46.33 GFLOP an image; ViT-L/14 at
    T=1370: 1013.6 GFLOP (GEMMs and attention products, two a multiply-add)."""
    b = spec.load_json(ROOT / "portbench/configs/dinov2-vitb14.json")
    l14 = spec.load_json(ROOT / "portbench/configs/dinov2-vitl14.json")
    assert work.forward_flops(b, 257, True) == 46_325_526_528
    assert work.forward_flops(l14, 1370, False) == 1_013_607_653_376


def test_tokens_of_each_mix():
    b = spec.load_cell("vitb14-classify-b64")
    f = spec.load_cell("vitl14-features-518-b8")
    tr = spec.load_cell("vitb14-train-f32-b32")
    assert work.tokens_of(b.config, b.traffic) == 257
    assert work.tokens_of(f.config, f.traffic) == 1370
    assert work.tokens_of(tr.config, tr.traffic) == 257


def test_function_bounds_by_hand():
    """K1 at B=64, T=257, D=768, bf16: 90.6 GFLOP, 0.0916 ms at 989 TFLOP/s.
    K4 at B=8, T=1370, ViT-L: 61.5 GFLOP, 0.0622 ms. fc1 + fc2 of ViT-B on
    q4_0 at B=64: 2 x 77.6 GFLOP. K1 f32 at B=32: 45.3 GFLOP at 495."""
    b = spec.load_json(ROOT / "portbench/configs/dinov2-vitb14.json")
    l14 = spec.load_json(ROOT / "portbench/configs/dinov2-vitl14.json")
    k1 = work.attention_half_layer(64, 257, b, "bf16", "bf16")
    assert k1[0][0] == 2 * 64 * 257 * 768 * 4 * 768 + 4 * 64 * 257 * 257 * 768
    assert work.bound_seconds(k1, "bf16") == pytest.approx(91.6e-6, rel=1e-3)
    k4 = work.attention_core(8, 1370, l14, "bf16", "bf16")
    assert work.bound_seconds(k4, "bf16") == pytest.approx(62.2e-6, rel=1e-3)
    k7 = work.mlp_linears(64, 257, b, "bf16", "q4_0")
    assert sum(ops for ops, _ in k7) == 2 * 2 * 64 * 257 * 768 * 3072
    assert work.bound_seconds(k7, "bf16") == pytest.approx(2 * 78.47e-6, rel=1e-3)
    k1f = work.attention_half_layer(32, 257, b, "f32", "f32")
    assert work.bound_seconds(k1f, "f32") == pytest.approx(91.5e-6, rel=2e-3)


def _fixture_trace():
    """Two calls: a copy in, a port kernel, a cuBLAS kernel, a lead kernel
    and its K7 GEMM, a copy out; 1000 ns idle between the calls."""
    act = []
    t = 0
    for _ in range(2):
        for name, ns in [("Memcpy HtoD (Pageable -> Device)", 300),
                         ("void dinov2::(anonymous namespace)::flash_forward_kernel<2, false>", 400),
                         ("sm90_xmma_gemm_bf16bf16_bf16f32", 200),
                         ("void dinov2::(anonymous namespace)::dequant_weight_kernel<dinov2::(anonymous namespace)::Bf16Rows>", 50),
                         ("void dinov2::(anonymous namespace)::wgmma_gemm_kernel<dinov2::ActEpilogue<1>, true>", 250),
                         ("Memcpy DtoH (Device -> Pageable)", 100)]:
            act.append(Activity(name, t, t + ns))
            t += ns
        t += 1000
    return Trace(calls=2, start_ns=0, end_ns=t, device=act,
                 host=[Activity("aten::to", 1300, 3000)])


def _reader(name):
    return harness.load_reader(name)


@pytest.mark.parametrize("kind", ["infer", "features", "train"])
def test_trace_metrics_on_a_fixture(kind):
    tr = _fixture_trace()
    ctx = SimpleNamespace(trace=tr)
    copy = {"infer": "copy_ms", "features": "copy_ms.features"}.get(kind)
    if copy:
        assert _reader(copy)(ctx) == pytest.approx(400 / 1e6)
    assert _reader(f"plain_ops_ms.{kind}")(ctx) == pytest.approx(200 / 1e6)
    assert tr.busy_ns() == 2 * 1300
    assert tr.window_ns == 4600
    assert _reader(f"idle_pct.{kind}")(ctx) == pytest.approx(100 * (1 - 2600 / 4600))
    gaps = dict(trace.top_idle_gaps(tr))
    assert gaps == {"aten::to": 1000 / 1e9, "python": 1000 / 1e9}
    k7 = roofline.assigned(tr.kernels, ["wgmma_gemm_kernel<.*ActEpilogue"],
                           ["dequant_weight_kernel<.*Bf16Rows"])
    assert sum(k.ns for k in k7) == 2 * 300
    k4 = roofline.assigned(tr.kernels, ["flash_forward_kernel"], [])
    assert sum(k.ns for k in k4) == 2 * 400


def test_readers_find_nothing_without_a_trace():
    ctx = SimpleNamespace(trace=None)
    for name in ["copy_ms", "copy_ms.features", "plain_ops_ms.train", "idle_pct.infer",
                 "k1_roofline", "mfu.infer", "mfu.features", "mfu.train"]:
        assert _reader(name)(ctx) is None


def test_every_metric_has_a_reader():
    bench = spec.load_json(ROOT / "BENCHMARK.json")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(_reader(m["name"]))


def test_the_same_seed_gives_the_same_images():
    t = dict(spec.load_cell("vitb14-classify-b64").traffic, pool=2)
    t["images"] = [dict(s, height=s["height"] // 5, width=s["width"] // 5) for s in t["images"]]
    a = traffic.image_pool(t, 2**33 + 1, "cpu")
    b = traffic.image_pool(t, 2**33 + 1, "cpu")
    c = traffic.image_pool(t, 2**33 + 2, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a[0] + a[1], b[0] + b[1]))
    assert not all(x.shape == y.shape and np.array_equal(x, y) for x, y in zip(a[0], c[0]))
    for batch in a + c:  # every seed: 48 landscape and 16 portrait, in its own order
        shapes = [img.shape for img in batch]
        assert shapes.count((75, 100, 3)) == 48 and shapes.count((100, 75, 3)) == 16
    assert [x.shape for x in a[0]] != [x.shape for x in c[0]]


def test_train_pool_labels():
    t = dict(spec.load_cell("vitb14-train-f32-b32").traffic, pool=2)
    t["images"] = [dict(s, height=32, width=32) for s in t["images"]]
    a = traffic.train_pool(t, 99, 1000, "cpu")
    b = traffic.train_pool(t, 99, 1000, "cpu")
    assert a[0][0].shape == (32, 32, 32, 3) and a[0][0].dtype == np.uint8
    assert np.array_equal(a[1][1], b[1][1]) and a[1][1].max() < 1000


def test_run_refuses_without_a_card(tmp_path):
    """No card: exit 1 and no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "vitb14-classify-b64",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1
    assert "{" not in proc.stdout
    assert "CUDA" in proc.stderr


def test_mfu_arithmetic():
    """Images of the window times the forward's operations over its wall,
    against the peak of the compute type; training counts three forwards."""
    cell = spec.load_cell("vitb14-classify-b64")
    window = SimpleNamespace(images=1000, wall_s=1.0)
    ctx = SimpleNamespace(trace=_fixture_trace(), config=cell.config, traffic=cell.traffic,
                          tokens=257, window=window)
    assert _reader("mfu.infer")(ctx) == pytest.approx(100 * 1000 * 46_325_526_528 / 989e12)
    feats = spec.load_cell("vitl14-features-518-b8")
    ctx = SimpleNamespace(trace=_fixture_trace(), config=feats.config, traffic=feats.traffic,
                          tokens=1370, window=window)
    assert _reader("mfu.features")(ctx) == pytest.approx(100 * 1000 * 1_013_607_653_376 / 989e12)
    train = spec.load_cell("vitb14-train-f32-b32")
    ctx = SimpleNamespace(trace=_fixture_trace(), config=train.config, traffic=train.traffic,
                          tokens=257, window=window)
    assert _reader("mfu.train")(ctx) == pytest.approx(100 * 3000 * 46_325_526_528 / 495e12)


@pytest.mark.parametrize("name", ["call_p95_ms", "call_p95_ms.classify"])
def test_call_p95_of_the_window(name):
    """The 95th percentile of every call of the measured window, in ms."""
    window = SimpleNamespace(latencies=[i / 1e3 for i in range(1, 101)])
    assert _reader(name)(SimpleNamespace(window=window, trace=None)) == pytest.approx(95.05)
