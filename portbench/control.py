"""The readings that the limits of workloads/<cell>.json are set from, at the
cell's own size, in one process:

    python3 portbench/control.py --workload <cell> --seeds 1 2 ... \\
        --control-seeds 7 8 9 [--seconds 2] [--out build/control]

  - the program's: a whole run of the cell (set-up, a window of `seconds`,
    the comparison) for each of --seeds; the largest of each number is its
    lower reading;
  - the control's: the reference put in the program's place, computed a
    precision below the configuration's (bf16: float8 e4m3 operands of
    every linear layer; float32: TF32 products; a W8A8 int8 mix: int4
    codes of weights and activations, with 6-bit activation codes beside
    int8 weights as context), against the float32 reference on the same
    inputs, for each of --control-seeds;
  - for a training cell also the faults planted in the reference put in
    the program's place: half of the batch left out, the mean taken over
    the rest; one image's CLS token altered. A step that leaves its state
    unchanged reads 1 by change_gap and needs no run.
Each reading is a JSON line on standard output and in <out>/<cell>.jsonl.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


# W8A8 int8 mixes: (weights' largest code, activations' largest code) of
# the reference in the program's place. int4 (W4A4), the precision below
# int8, is the control; 6-bit activation codes beside int8 weights are a
# reading of context: they read under three times the program's own gap,
# so they set no upper reading and the limit need not fail them.
INT8_CONTROLS = {"control:int4": (7, 7), "context:a6": (127, 31)}


def _numbers(cell, low, exact, pool, device):
    """The comparison's numbers of the model `low` in the program's place,
    against the model `exact`, on every batch of the pool."""
    from portbench import check
    from portbench.reference import model as reference

    pairs = []
    for batch in pool:
        if cell.traffic["entry"] == "classify_probs":
            probs = reference.classify_log_probs(low, batch, device).exp().cpu().numpy()
            pairs.append((probs, reference.classify_log_probs(exact, batch, device)))
        else:
            cls, patch = reference.features(low, batch, device)
            out = {"cls_token": cls.cpu().numpy(), "patch_tokens": patch.cpu().numpy()}
            pairs.append((out, reference.features(exact, batch, device)))
    return (check.classify_numbers(pairs) if cell.traffic["entry"] == "classify_probs"
            else check.features_numbers(pairs))


def _inference_control(cell, seed, device):
    from portbench import harness, traffic
    from portbench.reference import model as reference

    t = cell.traffic
    pool = traffic.image_pool(t, seed, device)
    tensors, four_bit = harness._reference_tensors(cell, seed, device)
    parity = t["engine"]["parity"]
    acts = harness.act_rows(cell)
    out = {}
    with reference.precision("f32"):
        exact = reference.Model(cell.config, tensors, parity, "f32", four_bit, acts)
        if "int8" in t:
            for kind, (weight_max, act_max) in INT8_CONTROLS.items():
                coded, _ = harness._reference_tensors(cell, seed, device, weight_max)
                low = reference.Model(cell.config, coded, parity, "f32", four_bit, acts, act_max)
                out[kind] = _numbers(cell, low, exact, pool, device)
                del coded, low
        else:
            low = reference.Model(cell.config, tensors, parity, "fp8", four_bit)
            out["control:fp8"] = _numbers(cell, low, exact, pool, device)
    del tensors
    harness._free(device)
    return out


def _training_control(cell, seed, device):
    from portbench import check, harness, traffic
    from portbench.reference import model as reference

    t = cell.traffic
    pool = traffic.train_pool(t, seed, cell.config["num_labels"], device)
    tensors, _ = harness._reference_tensors(cell, seed, device)
    opt = {**t["trainer"], **t["optimizer"]}
    batches = pool[: t["checked_steps"]]

    def steps(prec, fault=None):
        with reference.precision(prec):
            return reference.train_steps(cell.config, tensors, batches, opt, t["parity"], prec,
                                         device, fault)

    exact = steps("f32")
    out = {}
    for kind, prec, fault in (("control:tf32", "tf32", None),
                              ("fault:half_batch", "f32", "half_batch"),
                              ("fault:token", "f32", "token")):
        r = steps(prec, fault)
        program = {"losses": r["losses"],
                   "grad_norms": check.reference_norms(r["first_grads"]),
                   "change_norms": check.reference_norms(r["changes"])}
        out[kind] = check.train_numbers(program, exact)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="portbench/control.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--out", default="build/control")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness, spec

    if not torch.cuda.is_available():
        print("portbench/control.py: no CUDA card", file=sys.stderr)
        return 1
    cell = spec.load_cell(args.workload)
    out_dir = ROOT / args.out
    out_dir.mkdir(parents=True, exist_ok=True)
    log = open(out_dir / f"{args.workload}.jsonl", "a")

    def emit(record):
        line = json.dumps(record)
        print(line, flush=True)
        log.write(line + "\n")
        log.flush()

    for seed in args.seeds:
        result = harness.run_cell(cell, seed, args.seconds, False, "cuda", started=time.time())
        emit({"seed": seed, "kind": "program", "correct": result["correct"],
              "failed": result["failed"], "errors": result["errors"],
              "numbers": {k: v["value"] for k, v in result["checks"].items()},
              "metrics": {k: v["value"] for k, v in result["metrics"].items()}})
    control = (_training_control if cell.traffic["entry"] == "train_step"
               else _inference_control)
    for seed in args.control_seeds:
        for kind, numbers in control(cell, seed, "cuda").items():
            emit({"seed": seed, "kind": kind, "numbers": numbers})
        torch.cuda.empty_cache()
    log.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
