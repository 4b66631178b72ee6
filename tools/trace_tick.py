"""Device time per graph node of the flagship tick, from a profiler trace.

    python tools/trace_tick.py [--legs 8192] [--ticks 20] [--out traces]

Runs the flagship graph as one scanned program of --ticks ticks, traces
one call with jax.profiler, and reduces the trace to device milliseconds
per tick for each graph node (ec, agc, rs, conf, ...), the device busy
time, and the idle share of the traced window.  Prints one JSON line.

Attribution: CompiledGraph.step wraps every node in jax.named_scope, so
each HLO instruction's op_name carries its node.  A device event names the
HLO instruction that launched it (its ``hlo_op`` stat, or for a fusion
kernel its own name, with ``_N`` for the instruction's ``.N``), which the
compiled module's text maps to an op_name.  XLA's GPU command buffers
(CUDA graphs) hide the launching instruction, so this tool turns them off
for the traced process (XLA_FLAGS --xla_gpu_enable_command_buffer=).  A
fusion is billed to the node of its root instruction, so a fusion that
spans two nodes counts once, for the later one.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_INST = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+) = .*?op_name="([^"]*)"')


def hlo_op_nodes(hlo_text: str, nodes) -> dict:
    """HLO instruction name -> graph node, from the op_name metadata.
    Each name is also keyed with '.' as '_' (GPU kernel names)."""
    nodes = set(nodes)
    out = {}
    for line in hlo_text.splitlines():
        m = _INST.match(line)
        if not m:
            continue
        for part in m.group(2).split("/"):
            if part in nodes:
                out[m.group(1)] = part
                out[m.group(1).replace(".", "_")] = part
                break
    return out


def _union_ns(intervals) -> int:
    busy, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def reduce_trace(xplane_path: str, op_nodes: dict) -> dict:
    """Per-node device ns, busy ns (union of event intervals) and window
    ns over the device planes (the host CPU plane on the CPU backend)."""
    import jax
    pd = jax.profiler.ProfileData.from_file(xplane_path)
    planes = [p for p in pd.planes if p.name.startswith("/device:")]
    if not planes:
        planes = [p for p in pd.planes if p.name == "/host:CPU"]
    per_node: dict = {}
    other: dict = {}                     # unattributed kernels, by name
    spans = []
    for plane in planes:
        for line in plane.lines:
            for ev in line.events:
                op = dict(ev.stats).get("hlo_op")
                if op is None:
                    continue
                s = int(ev.start_ns)
                e = s + int(ev.duration_ns)
                spans.append((s, e))
                node = op_nodes.get(op) or op_nodes.get(ev.name, "(other)")
                per_node[node] = per_node.get(node, 0) + (e - s)
                if node == "(other)":
                    other[ev.name] = other.get(ev.name, 0) + (e - s)
    if not spans:
        raise RuntimeError(f"no device events with hlo_op in {xplane_path}")
    window = max(e for _, e in spans) - min(s for s, _ in spans)
    top = sorted(other.items(), key=lambda kv: -kv[1])[:8]
    return {"per_node_ns": per_node, "busy_ns": _union_ns(spans),
            "window_ns": window, "events": len(spans),
            "other_top_ns": dict(top)}


def trace_flagship(legs: int, ticks: int, out_dir: str) -> dict:
    import jax
    import jax.numpy as jnp
    from mediastreamer2_tpu import Factory, enable_compile_cache, tick_samples
    from mediastreamer2_tpu.models.flagship import build_flagship

    enable_compile_cache()
    S = tick_samples(48000)
    cg, params = build_flagship(Factory(), batch=legs)
    mic0 = 0.1 * jax.random.normal(jax.random.key(0), (legs, S), jnp.float32)
    spk0 = 0.1 * jax.random.normal(jax.random.key(1), (legs, S), jnp.float32)

    def body(st, t):
        ext = {"mic": jnp.roll(mic0, t, axis=1),
               "spk_ref": jnp.roll(spk0, t + 7, axis=1)}
        st, out, _ = cg.step(st, params, ext)
        return st, out["out"][:, 0].sum()

    run = jax.jit(lambda st: jax.lax.scan(body, st, jnp.arange(ticks)))
    state = cg.init_state()
    compiled = run.lower(state).compile()
    state, _ = jax.block_until_ready(compiled(state))       # warm
    jax.profiler.start_trace(out_dir)
    state, _ = jax.block_until_ready(compiled(state))
    jax.profiler.stop_trace()
    path = max(glob.glob(os.path.join(out_dir, "plugins", "profile", "*",
                                      "*.xplane.pb")), key=os.path.getmtime)
    names = [n.name for n in cg.nodes]
    r = reduce_trace(path, hlo_op_nodes(compiled.as_text(), names))
    busy = r["busy_ns"]
    dev = jax.devices()[0]
    return {
        "platform": dev.platform, "device_kind": dev.device_kind,
        "legs": legs, "ticks": ticks, "trace": path,
        "device_busy_ms_per_tick": busy / 1e6 / ticks,
        "idle_share": 1.0 - busy / max(r["window_ns"], 1),
        "node_ms_per_tick": {k: v / 1e6 / ticks
                             for k, v in sorted(r["per_node_ns"].items())},
        # kernel-time share (kernels can overlap, so shares may sum > 1)
        "node_share_of_busy": {k: v / max(busy, 1)
                               for k, v in sorted(r["per_node_ns"].items())},
        "events": r["events"],
        "unattributed_top_ms_per_tick": {
            k[:60]: v / 1e6 / ticks for k, v in r["other_top_ns"].items()},
    }


def main(argv=None):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_gpu_enable_command_buffer=")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--legs", type=int, default=8192)
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--out", default="traces",
                    help="profiler output directory (git-ignored default)")
    args = ap.parse_args(argv)
    import jax
    platform = jax.devices()[0].platform
    if platform != "gpu" and os.environ.get("JAX_PLATFORMS") != "cpu":
        raise SystemExit(f"no GPU (JAX found {platform!r}); set "
                         f"JAX_PLATFORMS=cpu to trace the CPU backend")
    print(json.dumps(trace_flagship(args.legs, args.ticks, args.out)))


if __name__ == "__main__":
    main()
