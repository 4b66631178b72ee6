"""Five benchmark configs — legs per GPU at the 10 ms deadline.

Mirrors the reference test graphs:
  1. G.711 mu-law play -> encode -> decode -> record, 8 kHz
     (basic_audio tester graph)
  2. 48 kHz -> 16 kHz polyphase resample + MSVolume-equivalent AGC
  3. AEC echo cancellation, near+far replay (aec3 tester scenario shape)
  4. N-way conference: per-leg resample + AGC + AEC + mix-minus
     (the flagship; ALSO measured by bench.py incl. the e2e transport)
  5. YUV420 -> RGB + rescale video pipeline (msvideo.c scaler semantics)

Usage:  python tools/bench_configs.py [--configs 1,2,3,4,5]
Runs on the default backend (the GPU; JAX_PLATFORMS=cpu gives the CPU
comparison row) and prints legs-at-deadline per config, stamped with the
device it ran on.  Device time per tick ends in block_until_ready.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

DEADLINE_MS = 10.0
SAFETY = 0.9
K_TICKS = 20


def _build_config(factory, cfg: int, batch: int):
    import jax.numpy as jnp
    from mediastreamer2_tpu.core.block import Format, tick_samples
    from mediastreamer2_tpu.core.graph import GraphBuilder

    g = GraphBuilder(factory, batch=batch)
    if cfg == 1:
        src = g.add("ext_source", "in", fmt=Format(rate=8000))
        g.chain(src, g.add("ulaw_enc"), g.add("ulaw_dec"),
                g.add("ext_sink", "out"))
        rates = (8000,)
    elif cfg == 2:
        src = g.add("ext_source", "in", fmt=Format(rate=48000))
        agc = g.add("volume", "agc")
        rs = g.add("resample", "rs", out_rate=16000)
        g.chain(src, agc, rs, g.add("ext_sink", "out"))
        rates = (48000,)
    elif cfg == 3:
        mic = g.add("ext_source", "in", fmt=Format(rate=16000))
        far = g.add("ext_source", "far", fmt=Format(rate=16000))
        ec = g.add("echo_canceller", "ec", tail_ms=80)
        g.link(mic, 0, ec, 0)
        g.link(far, 0, ec, 1)
        g.chain(ec, g.add("ext_sink", "out"))
        rates = (16000, 16000)
    elif cfg == 4:
        from mediastreamer2_tpu.models.flagship import build_flagship
        cg, params = build_flagship(factory, batch=batch)
        return cg, params, {"mic": 48000, "spk_ref": 48000}
    elif cfg == 5:
        fmt = Format(kind="yuv420", width=320, height=240, fps=25.0)
        cam = g.add("ext_source", "in", fmt=fmt)
        sc = g.add("size_conv", "sc", out_w=160, out_h=120)
        g.chain(cam, sc, g.add("ext_sink", "out"))
        cg = g.build()
        return cg, cg.init_params(), ("video",)
    else:
        raise ValueError(cfg)
    cg = g.build()
    params = cg.init_params()
    if cfg == 2:
        params["agc"]["agc_enabled"] = jnp.ones((batch,), bool)
    return cg, params, rates


def measure(cfg: int, batch: int) -> float:
    """Device ms per tick at `batch` legs (inf when out of memory)."""
    import jax
    import jax.numpy as jnp
    from mediastreamer2_tpu.core.block import tick_samples
    from mediastreamer2_tpu.core.factory import Factory

    factory = Factory()
    try:
        cg, params, rates = _build_config(factory, cfg, batch)
        state = cg.init_state()
        key = jax.random.key(cfg)
        if rates == ("video",):
            shape = cg.ext_inputs["in"][0]
            x0 = {"in": 0.5 + 0.1 * jax.random.normal(key, shape, jnp.float32)}
        else:
            named = rates if isinstance(rates, dict) else dict(
                zip(["in", "far"], rates))
            x0 = {n: 0.1 * jax.random.normal(
                key, (batch, tick_samples(r)), jnp.float32)
                for n, r in named.items()}

        def body(st, t):
            ext = {k: jnp.roll(v, t, axis=-1) for k, v in x0.items()}
            st, out, _ = cg.step(st, params, ext)
            first = next(iter(out.values()))
            return st, first.reshape(first.shape[0], -1)[:, 0].sum()

        @jax.jit
        def run(st):
            st, sums = jax.lax.scan(body, st, jnp.arange(K_TICKS))
            return st, sums.sum()

        state, _ = jax.block_until_ready(run(state))
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            state, _ = jax.block_until_ready(run(state))
            best = min(best, (time.perf_counter() - t0) * 1e3)
        return best / K_TICKS
    except Exception as e:
        if "RESOURCE_EXHAUSTED" not in str(e):
            raise
        print(f"# cfg{cfg} batch={batch}: out of device memory",
              file=sys.stderr)
        return float("inf")


def legs_at_deadline(cfg: int, start: int = 256,
                     cap: int = 1 << 18) -> tuple:
    budget = DEADLINE_MS * SAFETY
    lo, hi, b = 0, None, start
    best_ms = None
    while hi is None:
        ms = measure(cfg, b)
        print(f"# cfg{cfg} batch={b}: {round(ms, 3)} ms/tick",
              file=sys.stderr)
        if ms <= budget:
            lo, best_ms = b, ms
            if b >= cap:
                break
            b *= 2
        else:
            hi = b
    while hi is not None and hi - lo > max(start // 2, lo // 4):
        mid = (lo + hi) // 2 // 64 * 64
        if mid <= lo or mid >= hi:
            break
        ms = measure(cfg, mid)
        print(f"# cfg{cfg} batch={mid}: {round(ms, 3)} ms/tick",
              file=sys.stderr)
        if ms <= budget:
            lo, best_ms = mid, ms
        else:
            hi = mid
    return lo, best_ms


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default="1,2,3,4,5")
    ap.add_argument("--start", type=int, default=256)
    args = ap.parse_args()
    import jax
    from mediastreamer2_tpu import enable_compile_cache
    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu" and os.environ.get("JAX_PLATFORMS") != "cpu":
        raise SystemExit(f"no GPU (JAX found {dev.platform!r}); set "
                         f"JAX_PLATFORMS=cpu for the CPU comparison row")
    results = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                          "count": len(jax.devices())},
               "unit": "legs@10ms", "configs": {}}
    starts = {5: 4}                       # video frames are big; start low
    for cfg in [int(c) for c in args.configs.split(",")]:
        legs, ms = legs_at_deadline(cfg, start=starts.get(cfg, args.start))
        results["configs"][cfg] = {"legs": legs, "ms_per_tick": ms}
    print(json.dumps(results))


if __name__ == "__main__":
    main()
