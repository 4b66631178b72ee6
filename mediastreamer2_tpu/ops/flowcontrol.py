"""Audio flow control — latency trimming by gentle time compression.

Reference: MSAudioFlowControl (src/audiofilters/flowcontrol.c:253-262)
drops samples when a downstream component reports latency buildup
(MS_AUDIO_FLOW_CONTROL_DROP_EVENT, wired in audiostream.c:1754-1765); the
"soft" strategy picks minimal-difference samples and silent frames first
(flowcontrol.c:56-127) so the drop is inaudible.

Batched: output size must stay static, so dropping N samples is done by
**reading N extra samples from a carried ring and linearly resampling the
oversized read back to one tick** — uniform micro-time-compression, the
vectorized equivalent of "drop the least audible samples".  The ring is
primed with one tick of latency, which is also the budget the filter can
trim per request.  ``drop_samples`` is a per-leg param the session layer
sets from flow-control events.
"""
from __future__ import annotations

import jax.numpy as jnp

from mediastreamer2_tpu.core.filter import FilterDef, register_filter


def _fc_init(ctx):
    B = ctx.batch
    S = ctx.in_formats[0].samples_per_tick
    return {
        # ring holds previous tick + current tick (one tick of latency budget)
        "ring": jnp.zeros((B, 2 * S), jnp.float32),
        "fill": jnp.full((B,), S, jnp.int32),     # samples of buffered latency
    }


def _fc_params(ctx):
    return {"drop_samples": jnp.zeros((ctx.batch,), jnp.int32)}


def _fc_process(state, ins, params, ctx):
    x = ins[0]
    B, S = x.shape
    # ring layout: [prev tick | cur tick]; read starts at (S - fill)
    ring = jnp.concatenate([state["ring"][:, S:], x], axis=1)
    fill = state["fill"]
    # consume S + d samples, d limited by available surplus (fill - 0)
    d = jnp.clip(params["drop_samples"], 0, jnp.minimum(fill, S // 4))
    consume = (S + d).astype(jnp.float32)
    start = (S - fill).astype(jnp.float32)
    # linear-interp read of `consume` samples compressed into S outputs
    k = jnp.arange(S, dtype=jnp.float32)[None, :]
    pos = start[:, None] + k * (consume[:, None] / S)
    i0 = jnp.clip(pos.astype(jnp.int32), 0, 2 * S - 2)
    frac = pos - i0.astype(jnp.float32)
    v0 = jnp.take_along_axis(ring, i0, axis=1)
    v1 = jnp.take_along_axis(ring, i0 + 1, axis=1)
    out = v0 * (1 - frac) + v1 * frac
    new_fill = fill - d
    return {"ring": ring, "fill": new_fill}, (out,), {"dropped": d}


register_filter(FilterDef(
    name="flow_control", ninputs=1, noutputs=1,
    out_formats=lambda ctx: (ctx.in_formats[0],),
    init=_fc_init, runtime_params=_fc_params, process=_fc_process,
))
