#!/usr/bin/env python3
"""Smoke test of the main path on an NVIDIA GPU.

    python chip_smoke.py            # one GPU: phases (a)-(e)
    python chip_smoke.py --multi    # four GPUs: the sharded path only

Phases, each of which must pass (any failure raises and exits non-zero):

(a) preflight: the card's name and power limit (nvidia-smi), JAX version,
    devices and the compile-cache directory;
(b) flagship: the 48 kHz AEC + AGC + resample + 4-way mix-minus graph at
    8192 legs through GraphBuilder -> Ticker.warm_up() -> 100 paced ticks
    fed by set_io; late ticks, load, the compiled step's memory analysis,
    peak device memory, and device ms/tick of a 50-tick lax.scan;
(c) reference: the flagship at 256 legs x 100 ticks on the GPU and on the
    CPU backend of this process against the quality bar, plus the rfft.py
    transforms and the resampler against numpy float64
    (models/device_check.py);
(d) served path: E2EConferenceBench at 2048 legs, G.711 over localhost UDP
    through the native edge, per-tick dispatch (K=1), ~3 s paced; gated on
    fidelity >= 0.9 and loss < 2%;
(e) the tests marked ``gpu``, in this process.

--multi runs mediastreamer2_tpu/parallel/check.py on 4 GPUs at 8192 legs
(sharded vs unsharded, cross-shard mix-minus, a co-resident second graph
class, per-shard native SRTP edge) and nothing else.

The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Without a GPU the script exits non-zero and prints no such line.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

FLAGSHIP_LEGS = 8192
PACED_TICKS = 100
SCAN_TICKS = 50
REF_LEGS = 256
REF_TICKS = 100
SERVED_LEGS = 2048
SERVED_SECONDS = 3.0
MULTI_DEVICES = 4


def card_line() -> str:
    """`name, power.limit` of the first card as nvidia-smi reports it."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def log(card: str, msg: str) -> None:
    print(f"[{card}] {msg}", flush=True)


def phase_preflight(card: str) -> dict:
    import jax
    import mediastreamer2_tpu
    cache = mediastreamer2_tpu.enable_compile_cache()
    devs = jax.devices()
    log(card, f"jax {jax.__version__}; devices {[str(d) for d in devs]}; "
              f"kind {devs[0].device_kind!r}; compile cache {cache}")
    return {"cache": cache}


def phase_flagship(card: str, legs: int = FLAGSHIP_LEGS,
                   ticks: int = PACED_TICKS,
                   scan_ticks: int = SCAN_TICKS) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from mediastreamer2_tpu import Factory, tick_samples
    from mediastreamer2_tpu.core.ticker import Ticker
    from mediastreamer2_tpu.models.flagship import build_flagship

    S = tick_samples(48000)
    cg, params = build_flagship(Factory(), batch=legs)
    tk = Ticker(cg, realtime=True)
    tk.params = params
    rng = np.random.default_rng(0)
    blocks = (0.1 * rng.standard_normal((4, 2, legs, S))).astype(np.float32)
    bad = []

    def pull(t):
        mic, spk = blocks[t % len(blocks)]
        return {"mic": mic, "spk_ref": spk}

    def push(t, ext_out):
        out = ext_out["out"]
        if out.shape != (legs, S // 3) or not np.isfinite(out).all():
            bad.append(t)

    tk.set_io(pull, push)
    t0 = time.perf_counter()
    tk.warm_up()
    compile_s = time.perf_counter() - t0
    tk.run(ticks)
    st = tk.stats
    if st.ticks != ticks or bad:
        raise AssertionError(f"paced run: {st.ticks}/{ticks} ticks, "
                             f"bad outputs at ticks {bad[:8]}")
    log(card, f"flagship {legs} legs: warm-up {compile_s:.1f} s; "
              f"{ticks} paced ticks: late {st.late_ticks}, "
              f"load {st.avg_load:.3f}, host step mean "
              f"{st.mean_step_ms:.3f} ms max {st.max_step_ms:.3f} ms")

    ext0 = pull(0)
    mem = tk._step.lower(tk.state, tk.params, ext0).compile() \
        .memory_analysis()
    mem_d = {k: getattr(mem, k) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "alias_size_in_bytes", "temp_size_in_bytes",
        "generated_code_size_in_bytes") if hasattr(mem, k)}
    log(card, f"flagship step memory_analysis: {mem_d}")

    key = jax.random.key(0)
    mic0 = 0.1 * jax.random.normal(key, (legs, S), jnp.float32)
    spk0 = 0.1 * jax.random.normal(jax.random.key(1), (legs, S), jnp.float32)

    def body(carry, t):
        ext = {"mic": jnp.roll(mic0, t, axis=1),
               "spk_ref": jnp.roll(spk0, t + 7, axis=1)}
        carry, out, _ = cg.step(carry, params, ext)
        return carry, out["out"][:, 0].sum()

    @jax.jit
    def run(state):
        return jax.lax.scan(body, state, jnp.arange(scan_ticks))

    state, sums = jax.block_until_ready(run(tk.state))
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        state, sums = jax.block_until_ready(run(state))
        times.append((time.perf_counter() - t0) * 1e3 / scan_ticks)
    if not np.isfinite(np.asarray(sums)).all():
        raise AssertionError("flagship scan produced non-finite output")
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    log(card, f"flagship {legs} legs: device {min(times):.4f} ms/tick "
              f"(best of 3 {scan_ticks}-tick scans; all {times}); "
              f"peak_bytes_in_use {peak}")
    return {"late_ticks": st.late_ticks, "load": st.avg_load,
            "device_ms_per_tick": min(times), "peak_bytes_in_use": peak,
            "memory_analysis": mem_d}


def phase_reference(card: str, legs: int = REF_LEGS,
                    ticks: int = REF_TICKS) -> dict:
    import jax
    from mediastreamer2_tpu.models.device_check import device_vs_cpu
    res = device_vs_cpu(jax.devices()[0], batch=legs, ticks=ticks)
    worst = sorted(res["spectral_rel_err"].items(), key=lambda kv: -kv[1])
    log(card, f"reference {legs} legs x {ticks} ticks, GPU vs CPU: "
              f"audio_diff_min {res['audio_diff_min']:.6f} (all legs), "
              f"{res['audio_diff_min_same_decisions']:.6f} (groups with "
              f"the same AEC transfer decisions), diverged groups "
              f"{res['diverged_group_share']:.4f}, "
              f"rms_err {res['rms_err']:.3e}, "
              f"max_abs_err {res['max_abs_err']:.3e}, "
              f"energy_gap_db_max {res['energy_gap_db_max']:.4f}")
    log(card, f"spectral/resampler vs float64, worst rel RMS err: "
              f"{worst[:6]}; all {res['spectral_rel_err']}")
    if not res["pass"]:
        raise AssertionError(f"device-vs-CPU check failed: {res}")
    return res


def phase_served(card: str, legs: int = SERVED_LEGS,
                 seconds: float = SERVED_SECONDS) -> dict:
    from mediastreamer2_tpu import Factory
    from mediastreamer2_tpu.core.rtgc import paused_gc
    from mediastreamer2_tpu.models.e2e_bench import E2EConferenceBench
    b = E2EConferenceBench(Factory(), legs, k_block=1, pipeline_depth=2)
    try:
        t0 = time.perf_counter()
        b.warm()
        compile_s = time.perf_counter() - t0
        n_blocks = b.default_warmup_blocks() + int(seconds * 100)
        with paused_gc():
            r = b.run(n_blocks, paced=True, trace=True)
    finally:
        b.close()
    log(card, f"served {legs} legs K=1 D=2: warm-up {compile_s:.1f} s; "
              f"{r.ticks} ticks at {r.ms_per_tick:.4f} ms/tick, late "
              f"{r.late_ticks}, loss {r.loss_rate:.5f}, fidelity "
              f"{r.fidelity:.4f}, added latency {r.mouth_to_ear_ms} ms, "
              f"phases {r.phases_ms}")
    if not (r.fidelity >= 0.9 and r.loss_rate < 0.02):
        raise AssertionError(f"served path failed: {r}")
    return {"ms_per_tick": r.ms_per_tick, "late_ticks": r.late_ticks,
            "loss_rate": r.loss_rate, "fidelity": r.fidelity}


def phase_gpu_tests(card: str) -> None:
    import pytest
    rc = pytest.main([os.path.join(ROOT, "tests"), "-m", "gpu", "-q",
                      "-p", "no:cacheprovider", "-p", "no:xdist",
                      "-p", "no:randomly", "-rs"])
    log(card, f"pytest -m gpu: exit {int(rc)}")
    if int(rc) != 0:
        raise AssertionError(f"gpu-marked tests failed (exit {int(rc)})")


def phase_multi(card: str, n: int = MULTI_DEVICES,
                legs: int = FLAGSHIP_LEGS) -> dict:
    import jax
    from mediastreamer2_tpu.parallel.check import check_sharded
    devs = jax.devices()
    if len(devs) < n:
        raise RuntimeError(f"--multi needs {n} GPUs, found {len(devs)}")
    t0 = time.perf_counter()
    res = check_sharded(devs[:n], batch=legs)
    log(card, f"sharded flagship on {n} GPUs, {legs} legs: {res} "
              f"({time.perf_counter() - t0:.1f} s incl. compile)")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the sharded path on 4 GPUs")
    args = ap.parse_args(argv)

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU, JAX found "
              f"{devs[0].platform!r}", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    card = card_line()
    print(card, flush=True)
    phase_preflight(card)
    if args.multi:
        phase_multi(card)
    else:
        phase_flagship(card)
        phase_reference(card)
        phase_served(card)
        phase_gpu_tests(card)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
