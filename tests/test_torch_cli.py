"""The port's CLIs (CPU, f32), each called in-process as main(argv) beside
the JAX package's on the same tiny GGUF and images, and the host helpers
they share (cli/_common.py, utils/logging.py, utils/timing.py,
io/convert.py)."""

import contextlib
import io
import json
import logging
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

from dinov2_tpu.cli import benchmark as jbenchmark
from dinov2_tpu.cli import eval as jeval
from dinov2_tpu.cli import inference as jinference
from dinov2_tpu.cli import quantize as jquantize
from dinov2_tpu.cli import realtime as jrealtime
from dinov2_tpu.cli import serve as jserve
from dinov2_tpu.cli._common import resolve_asset as jresolve_asset
from dinov2_tpu.io import convert as jconvert
from dinov2_tpu.io.synthetic import write_synthetic_gguf
from dinov2_tpu.models.config import DinoConfig
from dinov2_tpu.utils import logging as jlogging
from dinov2_tpu_torch.cli import benchmark, eval as eval_cli, inference, quantize, realtime, serve
from dinov2_tpu_torch.cli import convert as convert_cli
from dinov2_tpu_torch.cli._common import load_image_rgb, resolve_asset, save_image_rgb
from dinov2_tpu_torch.io import convert
from dinov2_tpu_torch.utils import logging as port_logging
from dinov2_tpu_torch.utils.timing import time_blocked

ROOT = Path(__file__).resolve().parent.parent
TINY = DinoConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                  num_classes=4, patch_size=14, img_size=70)
PROB_ATOL = 1e-5  # eval probs, port f32 against JAX f32
PRINTED_ATOL = 0.01  # inference -c prints probs to two decimals
U8_AGREE = 0.99  # share of pixels at most one u8 level apart (PCA, realtime)
PORT = ["--device", "cpu", "--dtype", "f32"]
JAX = ["--dtype", "f32"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return write_synthetic_gguf(tmp_path_factory.mktemp("cli") / "tiny.gguf", TINY, seed=3)


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(11)
    for i in range(6):
        img = rng.integers(0, 256, (64 + 4 * i, 96, 3), dtype=np.uint8)
        cv2.imwrite(str(d / f"im{i}.png"), img)
    return d


def _run(main, argv):
    """(return code, stdout) of main(argv) in this process."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def _agree_u8(a, b):
    return float((np.abs(a.astype(np.int32) - b.astype(np.int32)) <= 1).mean())


def test_inference_classify_matches_jax(ckpt, image_dir):
    img = str(image_dir / "im0.png")
    rc, got = _run(inference.main, ["-m", str(ckpt), "-i", img, "-c", *PORT])
    jrc, want = _run(jinference.main, ["-m", str(ckpt), "-i", img, "-c", *JAX])
    assert rc == jrc == 0
    line = re.compile(r"^ > (\S+) : ([0-9.]+)$")
    got, want = ([line.match(s).groups() for s in text.splitlines()] for text in (got, want))
    assert len(got) == len(want) == 4  # top-k capped at num_classes
    assert [label for label, _ in got] == [label for label, _ in want]
    np.testing.assert_allclose([float(p) for _, p in got], [float(p) for _, p in want],
                               atol=PRINTED_ATOL, rtol=0)


def test_inference_pca_matches_jax_and_profiles(ckpt, image_dir, tmp_path, capsys):
    img = str(image_dir / "im1.png")
    ours, theirs, trace = tmp_path / "a.png", tmp_path / "b.png", tmp_path / "trace"
    assert inference.main(["-m", str(ckpt), "-i", img, "-o", str(ours),
                           "--profile", str(trace), *PORT]) == 0
    assert "graph computation took" in capsys.readouterr().err
    assert jinference.main(["-m", str(ckpt), "-i", img, "-o", str(theirs), *JAX]) == 0
    a, b = cv2.imread(str(ours)), cv2.imread(str(theirs))
    assert a.shape == b.shape == (68, 96, 3)
    assert _agree_u8(a, b) >= U8_AGREE
    events = json.loads((trace / "trace.json").read_text())["traceEvents"]
    assert len(events) > 0


def _eval(main, ckpt, image_dir, out, extra):
    rc, _ = _run(main, ["-m", str(ckpt), "--dir", str(image_dir), "--batch", "4",
                        "--output", str(out), *extra])
    assert rc == 0
    return [json.loads(line) for line in out.read_text().splitlines()]


def test_eval_matches_jax(ckpt, image_dir, tmp_path, capsys):
    """The same JSONL records (paths, top-k labels, probs within 1e-5), and
    the same top-1/top-5 with -k 1: every label is the argmax's neighbour, so
    top-1 is 0 and, with 4 classes, top-5 is 1 whatever -k prints."""
    names = sorted(p.name for p in image_dir.iterdir())
    labels = tmp_path / "labels.json"
    labels.write_text(json.dumps({n: i % 4 for i, n in enumerate(names)}))
    got = _eval(eval_cli.main, ckpt, image_dir, tmp_path / "a.jsonl", PORT)
    want = _eval(jeval.main, ckpt, image_dir, tmp_path / "b.jsonl", JAX)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g["path"] == w["path"]
        assert [label for label, _ in g["topk"]] == [label for label, _ in w["topk"]]
        np.testing.assert_allclose([p for _, p in g["topk"]], [p for _, p in w["topk"]],
                                   atol=PROB_ATOL, rtol=0)
    top1 = {Path(r["path"]).name: int(r["topk"][0][0].removeprefix("class_")) for r in got}
    labels.write_text(json.dumps({n: (top1[n] + 1) % 4 for n in names}))
    capsys.readouterr()
    _eval(eval_cli.main, ckpt, image_dir, tmp_path / "c.jsonl",
          [*PORT, "-k", "1", "--labels", str(labels)])
    ours = capsys.readouterr().err
    _eval(jeval.main, ckpt, image_dir, tmp_path / "d.jsonl",
          [*JAX, "-k", "1", "--labels", str(labels)])
    theirs = capsys.readouterr().err
    assert "top-1 0.0000  top-5 1.0000  (n=6)" in ours
    assert "top-1 0.0000  top-5 1.0000  (n=6)" in theirs
    assert all(len(r["topk"]) == 1 for r in map(json.loads, (tmp_path / "c.jsonl").open()))


def test_eval_empty_dir_returns_1(ckpt, tmp_path):
    assert _run(eval_cli.main, ["-m", str(ckpt), "--dir", str(tmp_path), *PORT])[0] == 1


@pytest.mark.parametrize("mode", [[], ["--pipeline"], ["--no-pipeline"]],
                         ids=["auto", "on", "off"])
def test_realtime_matches_jax(ckpt, tmp_path, capsys, mode):
    """15 synthetic 854x480 frames (T = 2171) in each loop; the PCA half of
    the last composed frame within one u8 level of JAX's on >= 99% of its
    pixels, and the frame half equal."""
    ours, theirs = tmp_path / "a.png", tmp_path / "b.png"
    argv = ["-m", str(ckpt), "--synthetic", "--no-display", "--frames", "15", *mode]
    assert realtime.main([*argv, "--save-last", str(ours), *PORT]) == 0
    err = capsys.readouterr().err
    assert "frame 15:" in err and "FPS" in err and "frame 16:" not in err
    assert jrealtime.main([*argv, "--save-last", str(theirs), *JAX]) == 0
    a, b = cv2.imread(str(ours)), cv2.imread(str(theirs))
    assert a.shape == b.shape == (480, 2 * 854, 3)
    np.testing.assert_array_equal(a[:, :854], b[:, :854])
    assert a[:, 854:].std() > 10  # a picture, not a constant
    assert _agree_u8(a[:, 854:], b[:, 854:]) >= U8_AGREE


def test_realtime_pipeline_calls_the_engine_off_the_main_thread(ckpt, monkeypatch, capsys):
    """The double-buffered loop runs every frame's engine call on one device
    thread, so the main thread makes and shows frames meanwhile."""
    from dinov2_tpu_torch.runtime.engine import DinoEngine

    threads, real = [], DinoEngine.pca_visualization_async

    def spy(self, frame):
        threads.append(threading.get_ident())
        return real(self, frame)

    monkeypatch.setattr(DinoEngine, "pca_visualization_async", spy)
    assert realtime.main(["-m", str(ckpt), "--synthetic", "--no-display", "--frames", "4",
                          "--pipeline", *PORT]) == 0
    assert "frame 4:" in capsys.readouterr().err
    assert len(threads) == 4 and len(set(threads)) == 1
    assert threads[0] != threading.get_ident()


def _bench_rows(main, argv):
    rc, out = _run(main, argv)
    assert rc == 0
    return json.loads(out)


def test_benchmark_rows(ckpt, tmp_path, monkeypatch):
    """The JAX row keys; the memory columns are None on the CPU; the
    temporary directory of the quantized file is removed."""
    made, real = [], tempfile.mkdtemp

    def spy(*args, **kwargs):
        made.append(real(dir=tmp_path))
        return made[-1]

    monkeypatch.setattr(tempfile, "mkdtemp", spy)
    got = _bench_rows(benchmark.main, ["-m", str(ckpt), "--batch-sizes", "1,2", "--iters", "1",
                                       "--json", "--quant", "q8_0", *PORT])
    want = _bench_rows(jbenchmark.main, ["-m", str(ckpt), "--batch-sizes", "1", "--iters", "1",
                                         "--json", *JAX])
    assert set(got) == {"f16", "q8_0"} and set(want) == {"f16"}
    for rows in got.values():
        assert [r["batch"] for r in rows] == [1, 2]
        for r in rows:
            assert list(r) == list(want["f16"][0])
            assert r["hbm_peak_mb"] is None and r["hbm_temp_mb"] is None
            assert r["hbm_weights_mb"] > 0 and r["images_per_sec"] > 0
    assert got["f16"][0]["hbm_weights_mb"] == want["f16"][0]["hbm_weights_mb"]
    assert made and not any(Path(d).exists() for d in made)


def test_quantize_same_bytes_as_jax(ckpt, tmp_path):
    ours, theirs = tmp_path / "a.gguf", tmp_path / "b.gguf"
    assert _run(quantize.main, [str(ckpt), str(ours), "q5_0"])[0] == 0
    assert _run(jquantize.main, [str(ckpt), str(theirs), "q5_0"])[0] == 0
    assert ours.read_bytes() == theirs.read_bytes()
    assert _run(quantize.main, [str(ckpt), str(tmp_path / "c.gguf"), "8"])[0] == 0  # q8_0 by id


@pytest.mark.parametrize("bad", ["q4_k", "0", "1"])
def test_quantize_refuses_unknown_types(ckpt, tmp_path, bad):
    with pytest.raises(SystemExit):
        quantize.main([str(ckpt), str(tmp_path / "o.gguf"), bad])


def _hf_classifier():
    from transformers import Dinov2Config, Dinov2ForImageClassification

    torch.manual_seed(1234)
    cfg = Dinov2Config(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                       intermediate_size=64, image_size=28, patch_size=7, num_labels=5)
    return Dinov2ForImageClassification(cfg).eval()


def test_convert_hf_model_same_bytes_as_jax(tmp_path):
    model = _hf_classifier()
    ours = convert.convert_hf_model(model, tmp_path / "a.gguf")
    theirs = jconvert.convert_hf_model(model, tmp_path / "b.gguf")
    assert ours.read_bytes() == theirs.read_bytes()


def test_convert_cli_from_a_local_checkpoint(tmp_path, monkeypatch):
    """--model_name a save_pretrained directory ("imagenet" in its name
    loads the classifier): the JAX converter's bytes, from disk alone."""
    import huggingface_hub.constants
    import transformers.utils.hub

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setattr(huggingface_hub.constants, "HF_HUB_OFFLINE", True)
    monkeypatch.setattr(transformers.utils.hub, "_is_offline_mode", True)
    local = tmp_path / "dinov2-tiny-imagenet-local"
    _hf_classifier().save_pretrained(local)
    ours = tmp_path / "a.gguf"
    rc, out = _run(convert_cli.main, ["--model_name", str(local), "--output", str(ours)])
    assert rc == 0 and f"Output file: {ours}" in out
    theirs = jconvert.convert_hf_name(str(local), tmp_path / "b.gguf")
    assert ours.read_bytes() == theirs.read_bytes()


def _banner(logger, config, path):
    records = []
    handler = logging.Handler()
    handler.emit = lambda record: records.append(record.getMessage())
    logger.get_logger().addHandler(handler)
    try:
        logger.log_model_banner(config, path)
    finally:
        logger.get_logger().removeHandler(handler)
    return records


def test_model_banner_lines_match_jax():
    from dinov2_tpu_torch.models.config import PRESETS

    got = _banner(port_logging, PRESETS["base"], "m.gguf")
    assert got == _banner(jlogging, PRESETS["base"], "m.gguf")
    assert got[1] == "hidden_size            = 768" and len(got) == 8
    fmt = port_logging.get_logger().handlers[0].formatter
    record = logging.LogRecord("dinov2_tpu_torch", logging.INFO, "", 0, got[0], None, None)
    assert fmt.format(record) == "dinov2_tpu_torch: loading model from 'm.gguf'"


def test_engine_prints_the_banner(ckpt):
    from dinov2_tpu_torch.runtime.engine import DinoEngine

    records = []
    handler = logging.Handler()
    handler.emit = lambda record: records.append(record.getMessage())
    port_logging.get_logger().addHandler(handler)
    try:
        DinoEngine(ckpt, dtype=torch.float32, device="cpu")
    finally:
        port_logging.get_logger().removeHandler(handler)
    assert records[0] == f"loading model from '{ckpt}'"
    assert records[1:3] == ["hidden_size            = 64", "num_hidden_layers      = 2"]


@pytest.mark.parametrize("device", [None, "cpu"])
def test_timer_brackets_the_block(device):
    out, elapsed_ms = time_blocked(lambda: time.sleep(0.02) or "done", device=device)
    assert out == "done" and 15 <= elapsed_ms < 2000


def test_resolve_asset_follows_the_jax_rule(tmp_path, monkeypatch):
    """Only a missing relative `assets/...` path falls back to
    $DINOV2_TPU_ASSETS (by its relative path, then its basename)."""
    root = tmp_path / "ref" / "assets"
    root.mkdir(parents=True)
    (root / "tench.jpg").write_bytes(b"x")
    monkeypatch.setenv("DINOV2_TPU_ASSETS", str(root))
    monkeypatch.chdir(tmp_path)
    local = tmp_path / "local.jpg"
    local.write_bytes(b"y")
    for path in ("assets/tench.jpg", "assets/sub/tench.jpg", "assets/missing.jpg",
                 "photos/tench.jpg", "tench.jpg", str(local), "/nowhere/tench.jpg"):
        assert resolve_asset(path) == jresolve_asset(path), path
    assert resolve_asset("assets/tench.jpg") == str(root / "tench.jpg")
    monkeypatch.delenv("DINOV2_TPU_ASSETS")
    assert resolve_asset("assets/tench.jpg") == "assets/tench.jpg"


def test_image_helpers(tmp_path):
    img = np.random.default_rng(2).integers(0, 256, (8, 10, 3), dtype=np.uint8)
    save_image_rgb(str(tmp_path / "ok.png"), img)
    np.testing.assert_array_equal(load_image_rgb(str(tmp_path / "ok.png")), img)
    with pytest.raises(OSError, match="failed to write"):
        save_image_rgb(str(tmp_path / "nodir" / "out.png"), img)
    with pytest.raises(FileNotFoundError):
        load_image_rgb(str(tmp_path / "missing.png"))


@pytest.mark.parametrize("spec,max_batch", [
    ("0", 32), ("1", 32), ("8,1,8", 32), ("full", 32), ("full", 20), ("full", 1),
    ("64", 32), ("8,64", 20),
])
def test_warmup_buckets_match_jax(spec, max_batch):
    assert serve._warmup_buckets(spec, max_batch) == jserve._warmup_buckets(spec, max_batch)


@pytest.mark.parametrize("spec,message", [("fast", "comma list"), ("0,4", ">= 1")])
def test_warmup_bucket_errors(spec, message):
    with pytest.raises(SystemExit, match=message):
        serve._warmup_buckets(spec, 32)


def test_serve_answers_until_terminated(ckpt, image_dir):
    """`python -m dinov2_tpu_torch.cli.serve` on port 0 prints its address,
    classifies one request, and exits on SIGTERM."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "dinov2_tpu_torch.cli.serve", "-m", str(ckpt), "--port", "0",
         "--warmup", "1", *PORT],
        cwd=ROOT, stderr=subprocess.PIPE, text=True,
        env={k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"},
    )
    try:
        deadline = time.monotonic() + 120
        address = None
        while address is None and time.monotonic() < deadline:
            line = proc.stderr.readline()
            if not line:
                break
            match = re.search(r"serving on (http://\S+)", line)
            address = match and match.group(1)
        assert address, "the server never printed its address"
        data = (image_dir / "im2.png").read_bytes()
        req = urllib.request.Request(f"{address}/classify", data=data, method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert len(json.loads(resp.read())["topk"]) == 4
        assert proc.poll() is None
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == -signal.SIGTERM
    finally:
        proc.kill()
        proc.wait(timeout=30)
        proc.stderr.close()


def _argv(name, ckpt, image_dir):
    return {
        "serve": [],
        "inference": ["-i", str(image_dir / "im0.png"), "-c"],
        "eval": ["--dir", str(image_dir)],
        "realtime": ["--synthetic", "--no-display", "--frames", "1"],
    }[name] + ["-m", str(ckpt)]


CLIS = {"serve": serve, "inference": inference, "eval": eval_cli, "realtime": realtime}


@pytest.mark.parametrize("name", list(CLIS))
def test_no_fallback_without_a_gpu(ckpt, image_dir, monkeypatch, name):
    """Without --device cpu and with no CUDA device, each CLI fails with the
    engine's error and never runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CLIS[name].main(_argv(name, ckpt, image_dir))


def test_benchmark_has_no_fallback(ckpt, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        benchmark.main(["-m", str(ckpt), "--batch-sizes", "1"])


def _plain_engine(ckpt, **kw):
    from dinov2_tpu_torch.runtime.engine import DinoEngine

    return DinoEngine(ckpt, dtype=torch.float32, device="cpu", **kw)


def _int8_engine(ckpt):
    return _plain_engine(ckpt, quant_mode="int8")


def _topk_of(probs_row, engine, k=4):
    order = np.argsort(-probs_row, kind="stable")[:k]
    return [engine.id2label.get(int(i), str(int(i))) for i in order], probs_row[order]


def _serve_check(ckpt, image_dir, monkeypatch, flags, engine):
    """serve with `flags` on port 0: one /classify, then the server stops
    (serve_forever is replaced by a start, a request and a stop); the reply
    is `engine`'s top-k."""
    from dinov2_tpu_torch.runtime.server import BatchingServer

    replies = []

    def once(server):
        server.start()
        data = (image_dir / "im2.png").read_bytes()
        req = urllib.request.Request(f"http://127.0.0.1:{server.port}/classify", data=data,
                                     method="POST")
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                replies.append(json.loads(resp.read()))
        finally:
            server.stop()

    monkeypatch.setattr(BatchingServer, "serve_forever", once)
    assert serve.main(["-m", str(ckpt), "--port", "0", "--warmup", "1", *flags, *PORT]) == 0
    labels, probs = _topk_of(engine.classify_probs(load_image_rgb(str(image_dir / "im2.png")))[0],
                             engine)
    (reply,) = replies
    assert [label for label, _ in reply["topk"]] == labels
    np.testing.assert_allclose([p for _, p in reply["topk"]], probs, atol=PROB_ATOL, rtol=0)


def _inference_check(ckpt, image_dir, flags, engine):
    img = str(image_dir / "im0.png")
    rc, out = _run(inference.main, ["-m", str(ckpt), "-i", img, "-c", *flags, *PORT])
    assert rc == 0
    line = re.compile(r"^ > (\S+) : ([0-9.]+)$")
    got = [line.match(s).groups() for s in out.splitlines()]
    labels, probs = _topk_of(engine.classify_probs(load_image_rgb(img))[0], engine)
    assert [label for label, _ in got] == labels
    np.testing.assert_allclose([float(p) for _, p in got], probs, atol=PRINTED_ATOL, rtol=0)


def _eval_check(ckpt, image_dir, tmp_path, flags, engine):
    from dinov2_tpu_torch.runtime.loader import BatchLoader, list_images

    rows = _eval(eval_cli.main, ckpt, image_dir, tmp_path / "a.jsonl", [*flags, *PORT])
    paths = list_images(image_dir)
    direct = np.concatenate([engine.classify_probs(batch) for _, batch in BatchLoader(
        paths, batch_size=4, size=(256, 256), interpolation="cubic-float")])
    assert [r["path"] for r in rows] == [str(p) for p in paths]
    for row, probs in zip(rows, direct):
        labels, top = _topk_of(probs, engine, k=len(row["topk"]))
        assert [label for label, _ in row["topk"]] == labels
        np.testing.assert_allclose([p for _, p in row["topk"]], top, atol=PROB_ATOL, rtol=0)


def _realtime_check(ckpt, tmp_path, flags, engine, frames):
    """realtime --synthetic for `frames` frames: the last composed frame's
    halves are the frame and, within one u8 level, `engine`'s PCA of it."""
    import argparse
    import itertools

    out = tmp_path / "last.png"
    assert realtime.main(["-m", str(ckpt), "--synthetic", "--no-display", "--frames",
                          str(frames), "--save-last", str(out), *flags, *PORT]) == 0
    frame = next(itertools.islice(realtime._frame_source(argparse.Namespace(synthetic=True)),
                                  frames - 1, None))
    last = cv2.cvtColor(cv2.imread(str(out)), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(last[:, : frame.shape[1]], frame)
    assert _agree_u8(last[:, frame.shape[1]:], engine.pca_visualization(frame)) >= U8_AGREE


def _cli_check(name, ckpt, image_dir, tmp_path, monkeypatch, flags, engine, frames):
    """Run CLI `name` with `flags` on the CPU and hold its output against
    `engine` on the same inputs."""
    if name == "serve":
        _serve_check(ckpt, image_dir, monkeypatch, flags, engine)
    elif name == "inference":
        _inference_check(ckpt, image_dir, flags, engine)
    elif name == "eval":
        _eval_check(ckpt, image_dir, tmp_path, flags, engine)
    else:
        _realtime_check(ckpt, tmp_path, flags, engine, frames)


@pytest.mark.parametrize("flag", [["--mesh", "2,2"], ["--data-parallel"]])
@pytest.mark.parametrize("name", list(CLIS))
def test_multi_device_flags_exit(ckpt, image_dir, tmp_path, monkeypatch, name, flag):
    """--mesh and --data-parallel run each CLI to exit 0 on the CPU with the
    unsharded engine's output: --mesh 2,2 builds a {"data": 2, "model": 2}
    mesh (every position the CPU, the dense TP forward), --data-parallel on
    the one CPU device builds none."""
    from dinov2_tpu_torch.runtime.engine import DinoEngine

    unsharded = _plain_engine(ckpt)
    built = []
    init = DinoEngine.__init__

    def spy(self, *args, **kwargs):
        init(self, *args, **kwargs)
        built.append(self)

    monkeypatch.setattr(DinoEngine, "__init__", spy)
    _cli_check(name, ckpt, image_dir, tmp_path, monkeypatch, flag, unsharded, frames=1)
    (engine,) = built
    if flag[0] == "--mesh":
        assert engine.mesh.shape == {"data": 2, "model": 2}
        assert engine._placed[0]["layers"]["qkv"]["kernel"].shape[-1] == 3 * TINY.hidden_size // 2
    else:
        assert engine.mesh is None


def _int8_benchmark(ckpt, monkeypatch):
    """With -m, the file's own label; without it, JAX's "f16-int8" variant
    of the synthetic file (its preset cut to the tiny config here). The
    weights' bytes are the int8 engine's."""
    from dinov2_tpu_torch.models import config as port_config
    from dinov2_tpu_torch.models.params import tree_leaves

    got = _bench_rows(benchmark.main, ["-m", str(ckpt), "--batch-sizes", "1", "--iters", "1",
                                       "--json", "--quant-mode", "int8", *PORT])
    engine = _int8_engine(ckpt)
    weights = sum(t.numel() * t.element_size() for leaf in tree_leaves(engine.loaded.params)
                  for t in (leaf.tensors().values() if hasattr(leaf, "tensors") else [leaf]))
    assert set(got) == {"f16"} and got["f16"][0]["images_per_sec"] > 0
    assert got["f16"][0]["hbm_weights_mb"] == round(weights / 2**20, 1)  # the column is in MiB
    monkeypatch.setitem(port_config.PRESETS, "small", TINY)
    synthetic = _bench_rows(benchmark.main, ["--size", "small", "--batch-sizes", "1", "--iters",
                                             "1", "--json", "--quant-mode", "int8", *PORT])
    assert set(synthetic) == {"f16-int8"} and synthetic["f16-int8"][0]["images_per_sec"] > 0


@pytest.mark.parametrize("name", [*CLIS, "benchmark"])
def test_int8_mode_runs(ckpt, image_dir, tmp_path, monkeypatch, name):
    """--quant-mode int8 (the W8A8 mode: Int8Linear weights, K9's plain
    version here) runs through each CLI, and its output is the int8
    engine's on the same inputs."""
    if name == "benchmark":
        _int8_benchmark(ckpt, monkeypatch)
    else:
        _cli_check(name, ckpt, image_dir, tmp_path, monkeypatch, ["--quant-mode", "int8"],
                   _int8_engine(ckpt), frames=2)
