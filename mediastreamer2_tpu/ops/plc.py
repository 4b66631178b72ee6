"""Generic packet-loss concealment + comfort-noise fill.

Reference: MSGenericPLC (src/audiofilters/msgenericplc.c:218-236) with
waveform continuation in src/utils/genericplc.c (pitch-buffer crossfade) and
CN fill after sustained loss.

Batched: loss is signaled per-leg per-tick by the host jitter buffer as a
``lost`` mask param; concealment replays the tail of a carried history
buffer with geometric decay and crossfades into synthetic comfort noise
whose level tracks the last-heard energy.  Everything is masked vector math
— lost and healthy legs share the same traced program.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from mediastreamer2_tpu.core.filter import FilterDef, register_filter

DECAY = 0.8          # per-tick decay of replayed waveform
CN_AFTER = 2         # ticks of loss before pure comfort noise


def _plc_init(ctx):
    B = ctx.batch
    S = ctx.in_formats[0].samples_per_tick
    return {
        "hist": jnp.zeros((B, S), jnp.float32),     # last good tick
        "lost_count": jnp.zeros((B,), jnp.int32),
        "cn_level": jnp.full((B,), 1e-4, jnp.float32),  # rms of background
        "rng": jax.random.key(0),
    }


def _plc_params(ctx):
    return {"lost": jnp.zeros((ctx.batch,), jnp.bool_)}


def _plc_process(state, ins, params, ctx):
    x = ins[0]
    B, S = x.shape
    lost = params["lost"]
    lost_count = jnp.where(lost, state["lost_count"] + 1, 0)

    decay = DECAY ** lost_count.astype(jnp.float32)
    replay = state["hist"] * decay[:, None]

    rng, sub = jax.random.split(state["rng"])
    noise = jax.random.normal(sub, (B, S), jnp.float32) * state["cn_level"][:, None]
    # fade from waveform replay to comfort noise as loss persists
    cn_mix = jnp.clip((lost_count.astype(jnp.float32) - 1) / CN_AFTER, 0.0, 1.0)
    concealed = replay * (1 - cn_mix[:, None]) + noise * cn_mix[:, None]

    out = jnp.where(lost[:, None], concealed, x)
    # crossfade first 2.5 ms after recovery to avoid discontinuity
    ramp_len = max(1, S // 4)
    k = jnp.arange(S, dtype=jnp.float32)[None, :]
    ramp = jnp.clip(k / ramp_len, 0.0, 1.0)
    recovered = (~lost) & (state["lost_count"] > 0)
    out = jnp.where(recovered[:, None],
                    state["hist"] * DECAY * (1 - ramp) + x * ramp, out)

    good_rms = jnp.sqrt((x * x).mean(axis=1))
    cn_level = jnp.where(lost, state["cn_level"],
                         0.95 * state["cn_level"] + 0.05 * jnp.minimum(good_rms, 0.01))
    new_state = {"hist": out, "lost_count": lost_count,
                 "cn_level": cn_level, "rng": rng}
    return new_state, (out,), {}


register_filter(FilterDef(
    name="generic_plc", ninputs=1, noutputs=1,
    out_formats=lambda ctx: (ctx.in_formats[0],),
    init=_plc_init, runtime_params=_plc_params, process=_plc_process,
))
