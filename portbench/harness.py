"""One run of one cell: set-up, the measured window, the traced window (with
--trace 1), the comparison with the plain reference, and the result.

Set-up makes the weights from the seed, writes them as the GGUF the program
loads (a file in memory: nothing goes to disk), builds the program (DinoEngine, or make_trainer's Trainer), makes the
traffic's pool of inputs and warms up: two calls of the cell's own shape,
or the training mix's checked steps, which the reference follows. setup_s
runs from the process's start to the end of set-up. The window then calls
the program back to back (one client, closed loop) for `seconds` and is
closed by the last call's result on the host (training: a synchronize).
A uniform sample of the window's outputs, drawn from the seed, is kept and
compared once the program is freed.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import contextlib
import os
import resource
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from portbench import check, seeds, spec, trace, traffic, weights, work
from portbench.reference import model as reference
from portbench.reference import int8, q4_0

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
FORBIDDEN = ("jax", "jaxlib", "flax", "dinov2_tpu")


def forbidden_modules() -> list[str]:
    """Top-level names of sys.modules that the benchmark must not load,
    compared whole (dinov2_tpu_torch is not dinov2_tpu)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def process_start() -> float:
    """time.time() of this process's start (Linux), else of this call."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - uptime + int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


class SetupClock:
    """Set-up's phases, for standard error: the wall seconds of each, with
    the CPU seconds, page faults and preemptions (involuntary context
    switches) of the process in it. The first phase runs from the
    process's start."""

    def __init__(self, started: float):
        self.started, self.phases = started, []
        self._last = (started, 0.0, 0, 0)

    def mark(self, name: str) -> None:
        ru = resource.getrusage(resource.RUSAGE_SELF)
        now = (time.time(), ru.ru_utime + ru.ru_stime, ru.ru_minflt + ru.ru_majflt, ru.ru_nivcsw)
        self.phases.append((name, *(a - b for a, b in zip(now, self._last))))
        self._last = now

    def seconds(self) -> float:
        """From the process's start to the last mark."""
        return self._last[0] - self.started

    def line(self) -> str:
        return "setup: " + ", ".join(f"{n} {w:.3f} s (cpu {c:.3f} s, {f} faults, {v} preempted)"
                                     for n, w, c, f, v in self.phases)


@contextlib.contextmanager
def memory_file(name: str):
    """A path to a new file that lives in memory (memfd): the program opens
    it as any file, and nothing is written to disk."""
    fd = os.memfd_create(name)
    try:
        yield Path(f"/proc/self/fd/{fd}")
    finally:
        os.close(fd)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Reservoir:
    """A uniform sample of k of the items offered, drawn from `rng`."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.k:
                self.items[j] = item


def _reference_tensors(cell: spec.Cell, seed: int, device,
                       weight_max: int = int8.INT8_MAX) -> tuple[dict, frozenset]:
    """The weights again from the seed, float32; q4_0 weights decoded from
    the blocks the reference encoder makes of them; under a traffic's int8
    scheme the weights it names rounded to their per-row codes of at most
    `weight_max` (int8: 127)."""
    fmt = cell.traffic["weights"]
    coded = cell.traffic.get("int8", {}).get("weights", ())
    tensors, four_bit = {}, set()
    for name, t in weights.model_arrays(cell.config, seed, device).items():
        if weights.quantized(name, tuple(t.shape), fmt):
            tensors[name] = q4_0.decode(*q4_0.encode(t.float()))
            four_bit.add(name)
        elif coded and name.endswith(".weight") and int8.covers(name[:-len(".weight")], coded):
            tensors[name] = int8.weight_rows(t, weight_max)
            four_bit.add(name)
        else:
            tensors[name] = t.float()
    return tensors, frozenset(four_bit)


def act_rows(cell: spec.Cell) -> tuple:
    """The linears whose input rows the traffic's int8 scheme codes."""
    return tuple(cell.traffic.get("int8", {}).get("activations", ()))


def _free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


# -- inference -----------------------------------------------------------------

def _inference(cell, seed, seconds, tracing, device, clock, out):
    t = cell.traffic
    from dinov2_tpu_torch.runtime.engine import DinoEngine

    clock.mark("program import")
    arrays = weights.model_arrays(cell.config, seed, device)
    _sync(device)
    clock.mark("weights")
    with memory_file("model.gguf") as path:
        weights.write_model(path, cell.config, arrays, t["weights"])
        del arrays
        clock.mark("gguf")
        engine = DinoEngine(path, dtype=DTYPES[t["dtype"]], device=device, **t["engine"])
    _sync(device)
    clock.mark("load")
    pool = traffic.image_pool(t, seed, device)
    clock.mark("pool")
    call = getattr(engine, t["entry"])
    for i in range(t["warmup_calls"]):
        call(pool[i % len(pool)])
        _sync(device)
        clock.mark(f"warm-up {i + 1}")
    out.setup_s = clock.seconds()

    sample = Reservoir(t["sample_calls"], seeds.rng(seed, "sample"))
    latencies, images, failed, errors = [], 0, 0, []
    t0 = time.perf_counter()
    end = t0
    while not latencies or end - t0 < seconds:
        i = len(latencies)
        start = time.perf_counter()
        try:
            result = call(pool[i % len(pool)])
        except Exception as e:  # a call that fails is counted, and fails the run
            failed += 1
            errors.append(repr(e))
            result = None
        end = time.perf_counter()
        latencies.append(end - start)
        if result is not None:
            images += len(pool[i % len(pool)])
            sample.offer((i % len(pool), result))
    out.window = SimpleNamespace(wall_s=end - t0, latencies=latencies, images=images,
                                 steps=len(latencies), batch=t["batch"])
    out.attempted, out.failed, out.errors = len(latencies), failed, errors
    if tracing:
        n = len(latencies)
        out.trace = trace.record(lambda j: call(pool[(n + j) % len(pool)]), t["trace_calls"])
    out.memory_peak = (torch.cuda.max_memory_allocated(device)
                       if torch.device(device).type == "cuda" else 0)
    out.forbidden = forbidden_modules()
    del engine, call
    _free(device)

    tensors, four_bit = _reference_tensors(cell, seed, device)
    with reference.precision("f32"):
        model = reference.Model(cell.config, tensors, t["engine"]["parity"], "f32", four_bit,
                                act_rows(cell))
        refs = {}
        pairs = []
        for idx, result in sample.items:
            if idx not in refs:
                if t["entry"] == "classify_probs":
                    refs[idx] = reference.classify_log_probs(model, pool[idx], device)
                else:
                    refs[idx] = reference.features(model, pool[idx], device)
            pairs.append((result, refs[idx]))
    if t["entry"] == "classify_probs":
        return check.classify_numbers(pairs)
    return check.features_numbers(pairs)


# -- training ------------------------------------------------------------------

def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _training(cell, seed, seconds, tracing, device, clock, out):
    t = cell.traffic
    from dinov2_tpu_torch.models.params import load_params
    from dinov2_tpu_torch.parallel.train import make_trainer

    clock.mark("program import")
    arrays = weights.model_arrays(cell.config, seed, device)
    _sync(device)
    clock.mark("weights")
    with memory_file("model.gguf") as path:
        weights.write_model(path, cell.config, arrays, t["weights"])
        del arrays
        clock.mark("gguf")
        loaded = load_params(path, dtype=torch.float32, device=device)
    trainer = make_trainer(loaded.config, device=device, **t["trainer"])
    state = list(trainer.place(loaded.params))
    del loaded
    _sync(device)
    clock.mark("load")
    pool = traffic.train_pool(t, seed, cell.config["num_labels"], device)
    clock.mark("pool")
    step = 0

    def one_step():
        nonlocal step
        images, labels = pool[step % len(pool)]
        state[0], state[1], metrics = trainer.step(state[0], state[1], images, labels)
        step += 1
        return metrics

    # the checked steps: set-up's warm-up, and what the reference follows
    start = _tree_map(lambda p: p.detach().cpu().clone(), state[0])
    losses, grad_norms = [], None
    for i in range(t["checked_steps"]):
        losses.append(float(one_step()["loss"]))
        if grad_norms is None:  # the first gradient, from Adam's first moment
            b1 = t["optimizer"]["b1"]
            grad_norms = check.leaf_norms(_tree_map(lambda m: m / (1 - b1), state[1]["mu"]))
        clock.mark(f"step {i + 1}")
    change_norms = check.leaf_norms(
        _tree_map(lambda p, p0: p.detach() - p0.to(p.device), state[0], start))
    del start
    _sync(device)
    clock.mark("change")
    out.setup_s = clock.seconds()

    failed, errors = 0, []
    first = step
    t0 = time.perf_counter()
    while step == first or time.perf_counter() - t0 < seconds:
        try:
            metrics = one_step()
            if step % t["log_every"] == 0:
                float(metrics["loss"])
        except Exception as e:  # the state is lost: the window ends
            failed, errors = 1, [repr(e)]
            break
    _sync(device)
    wall = time.perf_counter() - t0
    out.window = SimpleNamespace(wall_s=wall, latencies=[], images=(step - first) * t["batch"],
                                 steps=step - first, batch=t["batch"])
    out.attempted, out.failed, out.errors = step - first + failed, failed, errors
    if tracing and not failed:
        out.trace = trace.record(lambda j: one_step(), t["trace_calls"])
    out.memory_peak = (torch.cuda.max_memory_allocated(device)
                       if torch.device(device).type == "cuda" else 0)
    out.forbidden = forbidden_modules()
    del trainer, state, one_step
    _free(device)

    tensors, _ = _reference_tensors(cell, seed, device)
    opt = {**t["trainer"], **t["optimizer"]}
    with reference.precision("f32"):
        ref = reference.train_steps(cell.config, tensors, pool[: t["checked_steps"]], opt,
                                    t["parity"], "f32", device)
    program = {"losses": losses, "grad_norms": grad_norms, "change_norms": change_norms}
    return check.train_numbers(program, ref)


# -- the run -------------------------------------------------------------------

def load_reader(name: str):
    """The reader of metric `name` as read(ctx): metrics/<name>.py's own, or
    the shared reader that metrics/<name>.json names under "reader"
    (readers/<reader>.py), given that file's entries."""
    path = spec.HERE / "metrics" / f"{name}.py"
    if path.exists():
        module_spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
        module = importlib.util.module_from_spec(module_spec)
        module_spec.loader.exec_module(module)
        return module.read
    table = spec.load_json(spec.HERE / "metrics" / f"{name}.json")
    shared = importlib.import_module(f"portbench.readers.{table['reader']}")
    return lambda ctx: shared.read(ctx, table)


def run_cell(cell: spec.Cell, seed: int, seconds: float, tracing: bool, device="cuda",
             started: float | None = None, clock: SetupClock | None = None) -> dict:
    """Run the cell once; the result line as a dict, its "checks" last.
    Set-up is timed from `started` (by default the process's start), or
    by `clock`, which may hold phases already."""
    clock = clock or SetupClock(process_start() if started is None else started)
    out = SimpleNamespace(trace=None, errors=[])
    run = _training if cell.traffic["entry"] == "train_step" else _inference
    _sync(device)
    clock.mark("device")
    numbers = run(cell, seed, seconds, tracing, device, clock, out)
    limits = cell.limits["limits"]
    correct = check.judge(numbers, limits) and out.failed == 0

    ctx = SimpleNamespace(cell=cell, config=cell.config, traffic=cell.traffic,
                          tokens=work.tokens_of(cell.config, cell.traffic),
                          setup_s=out.setup_s, window=out.window, trace=out.trace)
    metrics = {}
    for m in (cell.per_layer if tracing else cell.end_to_end):
        value = load_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    on_card = torch.device(device).type == "cuda"
    result = {
        "correct": correct,
        "attempted": out.attempted,
        "failed": out.failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
            "count": 1,
            "memory_peak_bytes": out.memory_peak,
        },
    }
    if out.trace is not None:
        result["device"]["busy_s"] = out.trace.busy_ns() / 1e9
        result["device"]["window_s"] = out.trace.window_ns / 1e9
        result["breakdown"] = {"device_ops": trace.top_device_ops(out.trace),
                               "idle_gaps": trace.top_idle_gaps(out.trace)}
    result["setup_phases"] = clock.line()
    result["forbidden"] = out.forbidden + forbidden_modules()
    result["errors"] = out.errors[:3]
    result["checks"] = {k: {"value": numbers.get(k), "limit": v} for k, v in limits.items()}
    return result
