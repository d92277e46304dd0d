"""The configuration and traffic keys that select the SwiGLU FFN
(use_swiglu_ffn) and W8A8 int8 (a traffic's "int8" scheme), on the CPU at
tiny sizes: the weights the harness writes load into the port, the plain
reference follows the port in float32, and the counts of work are the ones
worked out by hand. The cells without those keys are pinned to what they
read before the keys existed: tensor specs, GGUF bytes, the reference's
outputs, operations and every roofline bound."""

import dataclasses
import hashlib
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from conftest import tiny
from portbench import control, harness, spec, traffic, weights, work
from portbench.readers import roofline
from portbench.reference import int8
from portbench.reference import model as reference
from portbench.trace import Activity, Trace

ROOT = spec.ROOT
SEED = 2**31 + 4242

# Read from the tree before use_swiglu_ffn and the int8 scheme were keys:
# sha256 of repr(tensor_specs) at full size and of the GGUF of the tiny
# cell, the forward's operations, the roofline bounds (seconds a call) and
# the sum of |x| over the tiny reference's outputs on SEED (classify:
# log-probabilities of the first batch; features: CLS and patch tokens;
# training: the 3 losses and each tensor's change).
BEFORE = {
    "vitb14-classify-b64": {
        "specs": "56a4092b86e30e7acead6604a83d8f4865c6b94f4a508bd25d94c6bf235c48cf",
        "gguf": "daec48a1c9b26905b9faaef60ca34f7d3deefd878ffcb7595ecaff448473dac0",
        "flops": 46325526528, "bounds": {"k1_roofline": 0.0010992577918058646},
        "ref_sum": 185.22912340847247},
    "vitl14-features-518-b8": {
        "specs": "6a756859c56ee33af2b504d4d35782b8f6c188f04a5dd165a53b3d146a83a870",
        "gguf": "7fef1198ce973cc8fedbb3b2338092bfd71b115d54c1c85a200d6f7072d73a2f",
        "flops": 1013607653376, "bounds": {"k4_roofline": 0.0014924714062689586},
        "ref_sum": 10495.649486400944},
    "vitb14-train-f32-b32": {
        "specs": "56a4092b86e30e7acead6604a83d8f4865c6b94f4a508bd25d94c6bf235c48cf",
        "gguf": "daec48a1c9b26905b9faaef60ca34f7d3deefd878ffcb7595ecaff448473dac0",
        "flops": 46325526528, "bounds": {"k1_f32_roofline": 0.0021962948608},
        "ref_sum": 7.075719384767581},
    "vitb14-classify-q4_0-b64": {
        "specs": "56a4092b86e30e7acead6604a83d8f4865c6b94f4a508bd25d94c6bf235c48cf",
        "gguf": "71990e66991eba3ea53e66f9f42e036728992a98f62ae407c49aab514b4200f9",
        "flops": 46325526528, "bounds": {"k7_roofline": 0.0018833909294074824},
        "ref_sum": 185.08507534322902},
}


def _roofline_bounds(cell):
    """Seconds a program call of every roofline metric the cell reports."""
    tokens = work.tokens_of(cell.config, cell.traffic)
    out = {}
    for m in cell.per_layer:
        path = spec.HERE / "metrics" / f"{m['name']}.json"
        table = spec.load_json(path) if path.exists() else {}
        if table.get("reader") == "roofline":
            parts = work.FUNCTIONS[table["function"]](cell.traffic["batch"], tokens, cell.config,
                                                      table["precision"], table["weights"])
            calls = table["calls_per_layer"] * cell.config["num_hidden_layers"]
            out[m["name"]] = calls * work.bound_seconds(parts, table["precision"])
    return out


def _reference_sum(cell):
    tensors, four_bit = harness._reference_tensors(cell, SEED, "cpu")
    t = cell.traffic
    with reference.precision("f32"):
        if t["entry"] == "train_step":
            pool = traffic.train_pool(t, SEED, cell.config["num_labels"], "cpu")
            opt = {**t["trainer"], **t["optimizer"]}
            r = reference.train_steps(cell.config, tensors, pool[:3], opt, t["parity"], "f32",
                                      "cpu")
            vals = np.array(r["losses"] + [float(torch.linalg.vector_norm(v))
                                           for v in r["changes"].values()])
        else:
            pool = traffic.image_pool(t, SEED, "cpu")
            model = reference.Model(cell.config, tensors, t["engine"]["parity"], "f32", four_bit,
                                    harness.act_rows(cell))
            if t["entry"] == "classify_probs":
                vals = reference.classify_log_probs(model, pool[0], "cpu").numpy()
            else:
                cls, patch = reference.features(model, pool[0], "cpu")
                vals = torch.cat([cls.flatten(), patch.flatten()]).double().numpy()
    return float(np.abs(vals).sum())


@pytest.mark.parametrize("name", BEFORE)
def test_existing_cells_read_as_before(tmp_path, name):
    """Exact: specs, GGUF bytes, operations, roofline bounds. The
    reference's outputs to a millionth (float32 products on the CPU may
    round apart with the thread count; the tree before the keys and this
    one gave the same bits on one machine)."""
    cell = spec.load_cell(name)
    before = BEFORE[name]
    assert hashlib.sha256(repr(weights.tensor_specs(cell.config)).encode()).hexdigest() \
        == before["specs"]
    small = tiny(cell)
    path = tmp_path / "model.gguf"
    weights.write_model(path, small.config, weights.model_arrays(small.config, SEED, "cpu"),
                        small.traffic["weights"])
    assert hashlib.sha256(path.read_bytes()).hexdigest() == before["gguf"]
    tokens = work.tokens_of(cell.config, cell.traffic)
    head = cell.traffic["entry"] != "extract_features"
    assert work.forward_flops(cell.config, tokens, head) == before["flops"]
    assert _roofline_bounds(cell) == before["bounds"]
    assert _reference_sum(small) == pytest.approx(before["ref_sum"], rel=1e-6)


# -- SwiGLU ----------------------------------------------------------------------

def _swiglu(config: dict, **changes) -> dict:
    return dict(config, use_swiglu_ffn=True, **changes)


def test_swiglu_hidden_by_the_hugging_face_rule():
    b = spec.load_json(ROOT / "portbench/configs/dinov2-vitb14.json")
    assert weights.swiglu_hidden(b) == 0
    assert weights.swiglu_hidden(_swiglu(b, hidden_size=1536)) == 4096
    assert weights.swiglu_hidden(_swiglu(b, hidden_size=64)) == 176  # 170.67 -> 170 -> 176


def test_giant_specs_are_the_shapes_the_port_writes_and_loads(monkeypatch):
    """tensor_specs at ViT-g/14's widths and 40 layers names and shapes
    every tensor as the port's own writer does for PRESETS["giant"] (zeros
    in place of random values); weights_in's rows, which the port's loader
    halves for the SwiGLU width, give the preset's 4096."""
    from dinov2_tpu_torch.io import synthetic
    from dinov2_tpu_torch.models.config import PRESETS, DinoConfig

    written = {}

    class Writer:
        def __init__(self, *args, **kwargs):
            pass

        def add_tensor(self, name, data):
            written[name] = tuple(data.shape)

        def add_string(self, *args):
            pass

        def add_uint32(self, *args):
            pass

        def write(self):
            pass

    class Zeros:
        def standard_normal(self, shape):
            return np.broadcast_to(np.float32(0), shape)

    monkeypatch.setattr(synthetic, "GGUFWriter", Writer)
    monkeypatch.setattr(synthetic.np.random, "default_rng", lambda seed: Zeros())
    giant = PRESETS["giant"]
    synthetic.write_synthetic_gguf("unused", giant, with_classifier=True)
    b = spec.load_json(ROOT / "portbench/configs/dinov2-vitb14.json")
    config = _swiglu(b, hidden_size=1536, num_hidden_layers=40, num_attention_heads=24)
    specs = {name: shape for name, shape, _ in weights.tensor_specs(config)}
    assert specs == written
    assert specs["encoder.layer.39.mlp.weights_in.weight"] == (8192, 1536)
    assert specs["encoder.layer.39.mlp.weights_out.weight"] == (1536, 4096)
    inferred = specs["encoder.layer.0.mlp.weights_in.weight"][0] // 2
    assert inferred == giant.swiglu_hidden_dim == DinoConfig(
        hidden_size=1536, num_hidden_layers=40).swiglu_hidden_dim


def _swiglu_cell(tmp_path, name, matrix_std=None, dtype=None):
    """The mix of cell `name` on a configuration file with use_swiglu_ffn,
    at a tiny size; no file of the benchmark edited."""
    bench = spec.load_json(ROOT / "BENCHMARK.json")
    config = _swiglu(spec.load_json(ROOT / "portbench/configs/dinov2-vitb14.json"))
    path = tmp_path / "swiglu.json"
    path.write_text(json.dumps(config))
    bench["configs"] = [dict(bench["configs"][0], file=str(path))]
    cell = tiny(spec.load_cell(name, bench), matrix_std)
    if dtype:
        cell = dataclasses.replace(cell, traffic=dict(cell.traffic, dtype=dtype))
    return cell


@pytest.mark.parametrize("name, dtype, limit", [
    ("vitb14-classify-b64", "f32", 5e-5), ("vitb14-classify-b64", None, None),
    ("vitb14-train-f32-b32", None, None)])
def test_a_swiglu_configuration_runs_through_the_harness(tmp_path, monkeypatch, name, dtype,
                                                         limit):
    """The port loads the harness's SwiGLU GGUF and runs SwiGLU in every
    layer; in float32 the reference follows it within 5e-5, and in the
    classify cell's own bf16 and through the training cell's checked steps
    (the weights_in and weights_out leaves compared) the run is correct
    under the cell's limits."""
    from dinov2_tpu_torch.models import vit

    calls = []
    real = vit.swiglu_block
    monkeypatch.setattr(vit, "swiglu_block", lambda *a, **k: calls.append(1) or real(*a, **k))
    classify = name.startswith("vitb14-classify")
    cell = _swiglu_cell(tmp_path, name, 0.08 if classify and not dtype else None, dtype)
    result = harness.run_cell(cell, 2**31 + 31, 0.05, False, "cpu")
    assert result["failed"] == 0 and result["correct"], result["checks"]
    assert calls and len(calls) % cell.config["num_hidden_layers"] == 0
    if limit:
        assert result["checks"]["logp_gap"]["value"] < limit


def test_swiglu_reference_is_hugging_faces_ffn():
    """One block's MLP half: x + ls2 * weights_out(silu(x1) * x2), x1 and x2
    the halves of weights_in(LN2(x)) in that order."""
    b = spec.load_json(ROOT / "portbench/configs/dinov2-vitb14.json")
    config = _swiglu(b, hidden_size=64, num_hidden_layers=1, num_attention_heads=2)
    tensors = {k: v.float() for k, v in weights.model_arrays(config, 9, "cpu").items()}
    model = reference.Model(config, tensors, "hf")
    x = torch.randn(2, 5, 64, generator=torch.Generator().manual_seed(1))
    layer = "encoder.layer.0."
    t = {k[len(layer):]: v for k, v in tensors.items() if k.startswith(layer)}
    with torch.no_grad():
        y = model.block(x, 0)
        h = reference.layer_norm(x, t["norm1.weight"], t["norm1.bias"], model.eps)
        qkv = h @ t["attention.attention.qkv.weight"].T + t["attention.attention.qkv.bias"]
        q, k, v = qkv.reshape(2, 5, 3, 2, 32).permute(2, 0, 3, 1, 4)
        att = torch.softmax(q @ k.transpose(-1, -2) / 32**0.5, dim=-1) @ v
        att = att.transpose(1, 2).reshape(2, 5, 64)
        x1 = x + t["layer_scale1.lambda1"] * (att @ t["attention.output.dense.weight"].T
                                              + t["attention.output.dense.bias"])
        h = reference.layer_norm(x1, t["norm2.weight"], t["norm2.bias"], model.eps)
        hin = h @ t["mlp.weights_in.weight"].T + t["mlp.weights_in.bias"]
        gated = torch.nn.functional.silu(hin[..., :176]) * hin[..., 176:]
        expect = x1 + t["layer_scale2.lambda1"] * (gated @ t["mlp.weights_out.weight"].T
                                                   + t["mlp.weights_out.bias"])
    torch.testing.assert_close(y, expect, rtol=1e-5, atol=1e-5)


def test_swiglu_work_by_hand():
    """ViT-g/14 at T=257, B=16: weights_in 2 * 16 * 257 * 1536 * 8192 and
    weights_out 2 * 16 * 257 * 4096 * 1536 operations; bytes: the input,
    the output, the weight and the f32 bias of each, activations at 2
    bytes; the forward counts the MLP from these shapes."""
    b = spec.load_json(ROOT / "portbench/configs/dinov2-vitb14.json")
    g = _swiglu(b, hidden_size=1536, num_hidden_layers=40, num_attention_heads=24)
    m = 16 * 257
    parts = work.swiglu_linears(16, 257, g, "bf16", "bf16")
    assert parts == [
        (2 * m * 1536 * 8192, (m * 1536 + m * 8192) * 2 + 1536 * 8192 * 2 + 4 * 8192),
        (2 * m * 4096 * 1536, (m * 4096 + m * 1536) * 2 + 4096 * 1536 * 2 + 4 * 1536),
    ]
    assert work.bound_seconds(parts, "bf16") == pytest.approx(
        (2 * m * 1536 * 8192 + 2 * m * 4096 * 1536) / 989e12)
    per_layer = 2 * 257 * 1536 * (4 * 1536 + 3 * 4096) + 4 * 257 * 257 * 1536
    patches = 2 * 256 * 3 * 14 * 14 * 1536
    assert work.forward_flops(g, 257, True) == patches + 40 * per_layer + 2 * 2 * 1536 * 1000
    # the GELU pair of the same width: equal operations at giant (3 x 4096
    # = 2 x 6144), and unchanged by the key
    gelu = dict(g, use_swiglu_ffn=False, mlp_ratio=4)
    assert work.forward_flops(gelu, 257, True) == work.forward_flops(g, 257, True)
    assert work.forward_flops(b, 257, True) == 46_325_526_528


# -- W8A8 int8 ---------------------------------------------------------------------

def test_int8_peak_and_mlp_bound_by_hand():
    """ViT-B/14's fc1 + fc2 at B=64, T=257 in int8: 2 x 77.6 GOP at 1979
    TOP/s, activations and weights at one byte: 0.0392 ms each, bound by
    the operations."""
    b = spec.load_json(ROOT / "portbench/configs/dinov2-vitb14.json")
    assert work.PEAK_FLOPS["int8"] == 1979e12 and work.BYTES["int8"] == 1
    m = 64 * 257
    parts = work.mlp_linears(64, 257, b, "int8", "int8")
    assert parts == [(2 * m * 768 * 3072, m * 768 + m * 3072 + 768 * 3072 + 4 * 3072),
                     (2 * m * 3072 * 768, m * 3072 + m * 768 + 3072 * 768 + 4 * 768)]
    assert work.bound_seconds(parts, "int8") == pytest.approx(2 * 2 * m * 768 * 3072 / 1979e12)
    assert work.bound_seconds(parts, "int8") == pytest.approx(2 * 39.19e-6, rel=1e-3)
    coded = work.int8_flops(b, 257, True, ["mlp.fc1", "mlp.fc2", "classifier"])
    assert coded == 12 * 2 * 2 * 257 * 768 * 3072 + 2 * 2 * 768 * 1000


def test_mfu_holds_the_w8a8_linears_against_the_int8_peak():
    cell = spec.load_cell("vitb14-classify-int8-b64")
    window = SimpleNamespace(images=1000, wall_s=1.0)
    ctx = SimpleNamespace(trace=object(), config=cell.config, traffic=cell.traffic, tokens=257,
                          window=window)
    total = 46_325_526_528
    coded = 12 * 2 * 2 * 257 * 768 * 3072 + 2 * 2 * 768 * 1000
    expect = 100 * 1000 * ((total - coded) / 989e12 + coded / 1979e12)
    assert harness.load_reader("mfu.infer")(ctx) == pytest.approx(expect)


def test_k9_roofline_takes_fc1_and_fc2_with_their_quantize():
    """The bf16 quantize + GEMM pairs (fc1's GELU epilogue, fc2's) count;
    the head's f32 pair and K1 do not."""
    table = spec.load_json(spec.HERE / "metrics" / "k9_roofline.json")
    ns = "void dinov2::(anonymous namespace)::"
    gemm = "int8_gemm_kernel<dinov2::(anonymous namespace)::Int8RescaleEpilogue"
    names = [("int8_quantize_rows_kernel<__nv_bfloat16, 4>", 10),
             (f"{gemm}<1, __nv_bfloat16> >", 100),
             ("int8_quantize_rows_kernel<__nv_bfloat16, 12>", 20),
             (f"{gemm}<0, __nv_bfloat16> >", 50),
             ("layer_norm_rows_kernel", 7),
             ("int8_quantize_rows_kernel<float, 8>", 3),
             (f"{gemm}<0, float> >", 5)]
    kernels, t = [], 0
    for name, n in names:
        kernels.append(Activity(ns + name, t, t + n))
        t += n
    got = roofline.assigned(kernels, table["kernels"], table["lead"])
    assert [k.ns for k in got] == [10, 100, 20, 50]
    cell = spec.load_cell("vitb14-classify-int8-b64")
    tr = Trace(calls=1, start_ns=0, end_ns=t, device=kernels)
    ctx = SimpleNamespace(trace=tr, traffic=cell.traffic, tokens=257, config=cell.config)
    bound = 12 * work.bound_seconds(work.mlp_linears(64, 257, cell.config, "int8", "int8"), "int8")
    assert roofline.read(ctx, table) == pytest.approx(100 * bound / (180 / 1e9))


def test_k1_roofline_in_the_int8_cell_takes_k1_alone():
    """In the int8 cell K1 runs qkv and proj on their dequantized weights:
    k1_roofline takes its four launches and neither the dequantize, nor
    K9's quantize + GEMM pairs."""
    table = spec.load_json(spec.HERE / "metrics" / "k1_roofline.json")
    ns = "void dinov2::(anonymous namespace)::"
    gemm = "int8_gemm_kernel<dinov2::(anonymous namespace)::Int8RescaleEpilogue"
    names = [("void at::native::elementwise_kernel<128, 2, MulFunctor<float> >", 9),
             (ns + "layer_norm_rows_kernel(__nv_bfloat16 const*)", 7),
             (ns + "wgmma_gemm_kernel<dinov2::BiasEpilogue, false>", 100),
             (ns + "flash_forward_kernel<2, false>", 80),
             (ns + "wgmma_gemm_kernel<dinov2::ResidualEpilogue, false>", 40),
             (ns + "int8_quantize_rows_kernel<__nv_bfloat16, 12>", 20),
             (ns + f"{gemm}<1, __nv_bfloat16> >", 100),
             (ns + "int8_quantize_rows_kernel<__nv_bfloat16, 4>", 10),
             (ns + f"{gemm}<0, __nv_bfloat16> >", 50)]
    kernels, t = [], 0
    for name, n in names:
        kernels.append(Activity(name, t, t + n))
        t += n
    got = roofline.assigned(kernels, table["kernels"], table["lead"])
    assert [k.ns for k in got] == [7, 100, 80, 40]
    assert "vitb14-classify-int8-b64" in next(
        m for m in spec.load_json(ROOT / "BENCHMARK.json")["per_layer"]
        if m["name"] == "k1_roofline")["workloads"]


def test_int8_rules_are_the_programs():
    """The reference's codes are the port's: weights requantized per row at
    load (models/params.py), activations per row (ops/qmatmul.py), bit for
    bit; a NumPy copy of the weight rule agrees."""
    from dinov2_tpu_torch.io.gguf import GGUFTensor, GGMLType
    from dinov2_tpu_torch.models.params import _int8_from_tensor
    from dinov2_tpu_torch.ops.qmatmul import quantize_rows_int8

    gen = torch.Generator().manual_seed(5)
    w = (torch.randn(96, 128, generator=gen) * 0.02).half()
    w[3] = 0  # a row of zeros takes the scale's floor
    raw = w.numpy()
    il = _int8_from_tensor(GGUFTensor(name="w", shape=raw.shape, ggml_type=GGMLType.F16,
                                      data=raw.view(np.uint8).ravel()))
    assert torch.equal(int8.weight_rows(w), il.codes.float() * il.s.unsqueeze(-1))
    x = torch.randn(7, 128, generator=gen) * 3
    x[2] = 0
    codes, sx = quantize_rows_int8(x)
    assert torch.equal(int8.activation_rows(x), codes.float() * sx)
    codes, sx = quantize_rows_int8(x.bfloat16())
    assert torch.equal(int8.activation_rows(x.bfloat16()), codes.float() * sx)


def test_int8_reference_follows_the_port(tmp_path):
    """The port's int8 engine (plain versions of K9, f32 activations) on the
    harness's GGUF against the reference with its codes, at a tiny size:
    within 1e-4 in log-probability; the reference without the activation
    codes reads at least 3x farther, so the codes are what it follows."""
    from dinov2_tpu_torch.runtime.engine import DinoEngine

    cell = tiny(spec.load_cell("vitb14-classify-int8-b64"), 0.08)
    t = cell.traffic
    path = tmp_path / "model.gguf"
    weights.write_model(path, cell.config, weights.model_arrays(cell.config, SEED, "cpu"),
                        t["weights"])
    engine = DinoEngine(path, dtype=torch.float32, device="cpu", **t["engine"])
    batch = traffic.image_pool(t, SEED, "cpu")[0]
    probs = engine.classify_probs(batch)
    tensors, coded = harness._reference_tensors(cell, SEED, "cpu")
    assert coded == {n for n in tensors if n.endswith(".weight") and tensors[n].dim() == 2}
    gaps = {}
    with reference.precision("f32"):
        for kind, acts in (("codes", harness.act_rows(cell)), ("no codes", ())):
            model = reference.Model(cell.config, tensors, t["engine"]["parity"], "f32", coded, acts)
            ref = reference.classify_log_probs(model, batch, "cpu")
            logp = torch.from_numpy(np.asarray(probs, dtype=np.float64)).log()
            gaps[kind] = float((logp - ref).abs().max())
    assert gaps["codes"] < 1e-4, gaps
    assert gaps["no codes"] >= 3 * gaps["codes"], gaps


def test_int8_controls_read_farther_than_the_program():
    """At a tiny size on the CPU the int8 mix's control (int4 codes) and
    its reading of context (6-bit activation codes) read far from the int8
    reference, int4 the farthest and past the cell's limit; a mix without
    the scheme keeps its float8 control alone."""
    cell = tiny(spec.load_cell("vitb14-classify-int8-b64"), 0.08)
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic, pool=1))
    out = control._inference_control(cell, SEED, "cpu")
    assert set(out) == {"control:int4", "context:a6"}
    assert out["control:int4"]["logp_gap"] > out["context:a6"]["logp_gap"] > 0.01
    assert out["control:int4"]["logp_gap"] > cell.limits["limits"]["logp_gap"]
    plain = tiny(spec.load_cell("vitb14-classify-b64"), 0.08)
    plain = dataclasses.replace(plain, traffic=dict(plain.traffic, pool=1))
    assert set(control._inference_control(plain, SEED, "cpu")) == {"control:fp8"}
