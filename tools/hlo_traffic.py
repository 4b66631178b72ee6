"""Device-memory traffic of the compiled EC tick: where the EC core's time
beyond the DFT+MDF micros goes.

Compiles the production ec_only graph (same scan harness tools/mfu.py
times), dumps the OPTIMIZED HLO, and sums the operand/result buffer sizes
of every top-level instruction in the entry/while-body computations —
i.e. the bytes each kernel launch actually moves through device memory
(fusion internals stay in registers/shared memory; only fusion boundaries
touch device memory,
modulo input/output aliasing which we report separately).

Run:  python tools/hlo_traffic.py [batch]
"""
from __future__ import annotations

import json
import os
import re
import sys
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

S = 480
K_TICKS = 50

DTYPE_BYTES = {"f32": 4, "bf16": 2, "s32": 4, "u32": 4, "pred": 1,
               "s8": 1, "u8": 1, "f16": 2, "s64": 8, "u64": 8, "f64": 8}

_SHAPE_RE = re.compile(r"(f32|bf16|f16|s32|u32|s64|u64|f64|pred|s8|u8)"
                       r"\[([0-9,]*)\]")


def shape_bytes(sig: str) -> int:
    """Total bytes of every typed shape literal in an HLO signature chunk."""
    total = 0
    for m in _SHAPE_RE.finditer(sig):
        dt, dims = m.groups()
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * DTYPE_BYTES[dt]
    return total


def analyze(hlo_text: str, min_mb: float = 1.0) -> dict:
    """Per-instruction traffic in the while-body (the scanned tick)."""
    # find the computation that contains the scan body: the largest
    # computation by instruction count mentioning 'while' ancestors is
    # fine-grained; simpler: scan all computations, take the one with the
    # most fusion instructions (the tick body after XLA fusion).
    comps = re.split(r"\n(?=[%\w].*\{)", hlo_text)
    best, best_n = None, 0
    for c in comps:
        n = len(re.findall(r"fusion(?:\.\d+)?\s*=", c))
        if n > best_n:
            best, best_n = c, n
    if best is None:
        return {"error": "no fusion computation found"}
    rows = []
    total = 0
    by_kind = defaultdict(int)
    for line in best.splitlines():
        line = line.strip()
        m = re.match(r"%?[\w.-]+\s*=\s*(\([^)]*\)|\S+)\s+"
                     r"(fusion|dot|convolution|custom-call|copy|"
                     r"dynamic-update-slice|dynamic-slice|concatenate|"
                     r"transpose|broadcast|reduce|select|add|multiply)"
                     r"(?:\.\d+)?\(", line)
        if not m:
            continue
        kind = m.group(2)
        b = shape_bytes(line)
        # subtract in-fusion shapes listed in calls= / to_apply= suffixes?
        # signature lines carry result + operand shapes only; good enough.
        total += b
        by_kind[kind] += b
        if b >= min_mb * 1e6:
            label = line.split("=")[0].strip()
            fk = re.search(r'kind=(\w+)', line)
            rows.append({"inst": label[:48], "kind": kind,
                         "fusion_kind": fk.group(1) if fk else None,
                         "mb": round(b / 1e6, 1)})
    rows.sort(key=lambda r: -r["mb"])
    return {"per_tick_traffic_gb": round(total / 1e9, 3),
            "by_kind_mb": {k: round(v / 1e6, 1)
                           for k, v in sorted(by_kind.items(),
                                              key=lambda kv: -kv[1])},
            "n_fusions": best_n,
            "top": rows[:40]}


def main():
    import jax
    import jax.numpy as jnp
    from mediastreamer2_tpu.core.factory import Factory
    from mediastreamer2_tpu.core.graph import GraphBuilder
    from mediastreamer2_tpu.core.block import Format

    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 8192

    g = GraphBuilder(Factory(), batch=batch)
    mic = g.add("ext_source", "mic", fmt=Format(rate=48000))
    spk = g.add("ext_source", "spk_ref", fmt=Format(rate=48000))
    ec = g.add("echo_canceller", "ec", tail_ms=80, no_suppress=True)
    out = g.add("ext_sink", "out")
    g.link(mic, 0, ec, 0)
    g.link(spk, 0, ec, 1)
    g.chain(ec, out)
    cg = g.build()
    params = cg.init_params()
    state = cg.init_state()
    key = jax.random.key(0)
    mic0 = 0.1 * jax.random.normal(key, (batch, S), jnp.float32)

    def step(carry):
        st, t = carry
        ext = {"mic": jnp.roll(mic0, t, axis=1),
               "spk_ref": jnp.roll(mic0, t + 7, axis=1)}
        st, o, _ = cg.step(st, params, ext)
        return (st, t + 1)

    @jax.jit
    def run(carry):
        carry, _ = jax.lax.scan(lambda c, _: (step(c), 0.0), carry, None,
                                length=K_TICKS)
        return carry

    lowered = run.lower((state, jnp.asarray(0, jnp.int32)))
    compiled = lowered.compile()
    txt = compiled.as_text()
    res = analyze(txt)
    res["batch"] = batch
    try:
        ma = compiled.memory_analysis()
        res["hbm_argument_mb"] = round(ma.argument_size_in_bytes / 1e6, 1)
        res["hbm_output_mb"] = round(ma.output_size_in_bytes / 1e6, 1)
        res["hbm_temp_mb"] = round(ma.temp_size_in_bytes / 1e6, 1)
        res["hbm_alias_mb"] = round(ma.alias_size_in_bytes / 1e6, 1)
    except Exception as e:                              # noqa: BLE001
        res["memory_analysis_error"] = str(e)[:120]
    # traffic is for K_TICKS scanned ticks? No: the while-body runs ONCE
    # per tick, so per-tick = body traffic (already per tick).
    print(json.dumps(res, indent=1))
    # achieved-vs-roofline: body traffic / measured ec_only ms (pass as
    # argv[2] if known) -> GB/s
    if len(sys.argv) > 2:
        ms = float(sys.argv[2])
        gbps = res["per_tick_traffic_gb"] / (ms * 1e-3)
        print(f"# at {ms} ms/tick -> {gbps:.0f} GB/s vs 819 peak "
              f"({gbps / 819:.0%})", file=sys.stderr)


if __name__ == "__main__":
    main()
