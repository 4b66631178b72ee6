"""Tone synthesis (DTMF / custom tones) and Goertzel-style detection.

Reference: MSDtmfGen (src/audiofilters/dtmfgen.c:356-374 — dual-tone with
envelope, interleaved into the passing stream) and MSToneDetector
(src/audiofilters/tonedetector.cpp + utils/goertzel_state.cpp — per-sample
Goertzel recursions).

Batched: tone synthesis is a batched phase ramp; detection replaces the
sequential Goertzel recursion with an **exact DFT projection per tick**
(|sum x[n] e^{-j2πfn/fs}|² over the block — same quantity Goertzel
computes) evaluated as einsum so all legs × all scan frequencies go through
one batched matmul.  Detection energy is smoothed over ticks to reach the
reference's typical 20-40 ms decision windows.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from mediastreamer2_tpu.core.filter import FilterDef, register_filter

# standard DTMF pairs, indexed 0-15: 123A 456B 789C *0#D
DTMF_ROWS = np.array([697.0, 770.0, 852.0, 941.0])
DTMF_COLS = np.array([1209.0, 1336.0, 1477.0, 1633.0])
DTMF_KEYS = "123A456B789C*0#D"


def dtmf_freqs(key: str):
    i = DTMF_KEYS.index(key.upper())
    return float(DTMF_ROWS[i // 4]), float(DTMF_COLS[i % 4])


def _gen_init(ctx):
    B = ctx.batch
    return {"phase1": jnp.zeros((B,), jnp.float32),
            "phase2": jnp.zeros((B,), jnp.float32)}


def _gen_params(ctx):
    B = ctx.batch
    return {
        "f1": jnp.zeros((B,), jnp.float32),
        "f2": jnp.zeros((B,), jnp.float32),       # 0 => single tone
        "amplitude": jnp.full((B,), 0.5, jnp.float32),
        "remaining": jnp.zeros((B,), jnp.int32),  # samples of tone left
        "silent_passthrough": jnp.zeros((B,), jnp.bool_),  # mute input while tone
    }


def _gen_process(state, ins, params, ctx):
    x = ins[0]
    B, S = x.shape
    rate = ctx.in_formats[0].rate
    n = jnp.arange(S, dtype=jnp.float32)[None, :]
    w1 = 2 * jnp.pi * params["f1"][:, None] / rate
    w2 = 2 * jnp.pi * params["f2"][:, None] / rate
    tone = jnp.sin(state["phase1"][:, None] + w1 * n)
    tone = tone + jnp.where(params["f2"][:, None] > 0,
                            jnp.sin(state["phase2"][:, None] + w2 * n), 0.0)
    # envelope: ramp in/out over 4 ms to avoid clicks
    ramp_len = max(1, rate * 4 // 1000)
    k = jnp.arange(S, dtype=jnp.float32)[None, :]
    rem = params["remaining"][:, None].astype(jnp.float32)
    env_on = jnp.minimum(1.0, k / ramp_len)
    env_off = jnp.clip((rem - k) / ramp_len, 0.0, 1.0)
    active = (k < rem)
    env = jnp.where(active, jnp.minimum(env_on, env_off), 0.0)
    tone = tone * env * params["amplitude"][:, None] * 0.5
    base = jnp.where(params["silent_passthrough"][:, None] & (rem > 0), 0.0, x)
    out = jnp.clip(base + tone, -1.0, 1.0)
    two_pi = 2 * jnp.pi
    new_state = {
        "phase1": jnp.mod(state["phase1"] + w1[:, 0] * S, two_pi),
        "phase2": jnp.mod(state["phase2"] + w2[:, 0] * S, two_pi),
    }
    finished = (params["remaining"] > 0) & (params["remaining"] <= S)
    return new_state, (out,), {"tone_done": finished}


register_filter(FilterDef(
    name="dtmf_gen", ninputs=1, noutputs=1,
    out_formats=lambda ctx: (ctx.in_formats[0],),
    init=_gen_init, runtime_params=_gen_params, process=_gen_process,
))


NUM_SCAN_FREQS = 8  # detector bank width (DTMF needs exactly 8)
DET_WINDOW_TICKS = 4  # 40 ms analysis window (typical DTMF minimum duration)


def _det_init(ctx):
    B = ctx.batch
    S = ctx.in_formats[0].samples_per_tick
    return {"power": jnp.zeros((B, NUM_SCAN_FREQS), jnp.float32),
            "above": jnp.zeros((B, NUM_SCAN_FREQS), jnp.bool_),
            "hist": jnp.zeros((B, (DET_WINDOW_TICKS - 1) * S), jnp.float32)}


def _det_params(ctx):
    B = ctx.batch
    freqs = np.concatenate([DTMF_ROWS, DTMF_COLS]).astype(np.float32)
    return {
        "freqs": jnp.broadcast_to(jnp.asarray(freqs), (B, NUM_SCAN_FREQS)),
        "threshold": jnp.full((B,), 0.05, jnp.float32),   # linear amplitude
        "enabled": jnp.ones((B,), jnp.bool_),
    }


def _det_process(state, ins, params, ctx):
    x = ins[0]
    B, S = x.shape
    rate = ctx.in_formats[0].rate
    win = jnp.concatenate([state["hist"], x], axis=1)          # [B, W]
    W = win.shape[1]
    hann = 0.5 - 0.5 * jnp.cos(2 * jnp.pi * jnp.arange(W, dtype=jnp.float32) / W)
    winx = win * hann[None, :]
    n = jnp.arange(W, dtype=jnp.float32)
    w = 2 * jnp.pi * params["freqs"] / rate                    # [B, F]
    ph = w[:, :, None] * n[None, None, :]                      # [B, F, W]
    re = jnp.einsum("bfs,bs->bf", jnp.cos(ph), winx,
                    precision=jax.lax.Precision.HIGHEST)
    im = jnp.einsum("bfs,bs->bf", jnp.sin(ph), winx,
                    precision=jax.lax.Precision.HIGHEST)
    # normalized amplitude: |DFT| / (coherent gain * W/2), Hann gain = 0.5
    amp = jnp.sqrt(re * re + im * im) * (4.0 / W)
    power = 0.5 * state["power"] + 0.5 * amp
    above = power > params["threshold"][:, None]
    hit = above & ~state["above"] & params["enabled"][:, None]  # rising edge
    new_state = {"power": power, "above": above, "hist": win[:, S:]}
    return new_state, (x,), {"tone_event": hit}


register_filter(FilterDef(
    name="tone_detector", ninputs=1, noutputs=1,
    out_formats=lambda ctx: (ctx.in_formats[0],),
    init=_det_init, runtime_params=_det_params, process=_det_process,
))


def classify_dtmf(hits: np.ndarray) -> str | None:
    """Host helper: map a [NUM_SCAN_FREQS] hit/power row to a DTMF key."""
    hits = np.asarray(hits)
    rows, cols = hits[:4], hits[4:8]
    if rows.any() and cols.any():
        return DTMF_KEYS[int(np.argmax(rows)) * 4 + int(np.argmax(cols))]
    return None
