"""A kernel's share of its roofline, from metrics/<metric>.json:

    {"reader": "roofline", "function": a name in work.FUNCTIONS, "precision": "bf16" | "f32",
     "weights": the weights' format, "calls_per_layer": calls a layer of
     one program call (or step), "kernels": [regular expressions of the
     kernels that compute it], "lead": [expressions of kernels that count
     for the function of the next kernel launched after them]}

The bound is work.bound_seconds of the function at the cell's shapes, times
its calls; the time is the device time of its kernels in the traced
window, per program call. The count stays the same whatever kernels
compute the function.
"""

from __future__ import annotations

import re

from portbench import work


def assigned(kernels, patterns: list[str], lead: list[str]) -> list:
    """The kernels of the function: those matching `patterns`, and each
    `lead` kernel whose next kernel outside `lead` matches them."""
    def matches(name, exprs):
        return any(re.search(e, name) for e in exprs)

    out, pending = [], []
    for k in kernels:
        if matches(k.name, lead):
            pending.append(k)
            continue
        if matches(k.name, patterns):
            out += pending + [k]
        pending = []
    return out


def read(ctx, table: dict) -> float | None:
    if ctx.trace is None:
        return None
    ns = sum(k.ns for k in assigned(ctx.trace.kernels, table["kernels"], table.get("lead", [])))
    if ns == 0:
        return None
    parts = work.FUNCTIONS[table["function"]](ctx.traffic["batch"], ctx.tokens, ctx.config,
                                              table["precision"], table["weights"])
    calls = table["calls_per_layer"] * ctx.config["num_hidden_layers"]
    bound = calls * work.bound_seconds(parts, table["precision"])
    return 100.0 * bound / (ns / 1e9 / ctx.trace.calls)
