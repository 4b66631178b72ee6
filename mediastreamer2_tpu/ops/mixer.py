"""Conference mixing — the batch-native MSAudioMixer.

Reference: src/audiofilters/audiomixer.c — an N-pin filter doing int32
accumulate + saturate with **mix-minus** (each output channel gets the sum
minus its own contribution, :113-130), per-channel gain, max 50 channels
(:29).  The conference layer splices streams into mixer pins
(src/voip/audioconference.c:119-178).

Batched re-design: conference members are **rows of the batch**, not
pins.  One ``conf_mixer`` node mixes *all conferences of the deployment at
once*: ``group_id[b]`` says which conference leg *b* belongs to, a
segment-sum computes every conference's sum in one op, and mix-minus is
``sum[group[b]] - x[b]``.  Adding/removing a member is a params update
(group/active masks) — no graph surgery, no 50-channel cap (capacity =
batch size).  Saturation matches the reference's int16 clamp
(audiomixer.c:40-44) as a [-1,1] clip.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from mediastreamer2_tpu.core.filter import FilterDef, register_filter


def _conf_init(ctx):
    return None


def _conf_params(ctx):
    B = ctx.batch
    return {
        "group_id": jnp.arange(B, dtype=jnp.int32),   # default: everyone alone
        "gain": jnp.ones((B,), jnp.float32),          # per-member input gain
        "active": jnp.ones((B,), jnp.bool_),          # member contributes
        "mix_minus": jnp.ones((B,), jnp.bool_),       # remove own contribution
        "out_gain": jnp.ones((B,), jnp.float32),
    }


def _conf_process(state, ins, params, ctx):
    x = ins[0]                                        # [B, S]
    B, S = x.shape
    contrib = jnp.where(params["active"][:, None], x * params["gain"][:, None], 0.0)
    k = int(ctx.params.get("uniform_group_size", 0))
    if k > 0 and B % k == 0:
        # uniform contiguous conferences (host bucketing guarantees layout):
        # reshape-sum instead of scatter — no segment ids
        sums_g = contrib.reshape(B // k, k, S).sum(axis=1)
        mix = jnp.repeat(sums_g, k, axis=0)
    else:
        sums = jax.ops.segment_sum(
            contrib, params["group_id"], num_segments=B,
            indices_are_sorted=bool(ctx.params.get("sorted_groups", False)))
        mix = sums[params["group_id"]]
    out = jnp.where(params["mix_minus"][:, None], mix - contrib, mix)
    out = jnp.clip(out * params["out_gain"][:, None], -1.0, 1.0)
    return state, (out,), {}


register_filter(FilterDef(
    name="conf_mixer", ninputs=1, noutputs=1,
    out_formats=lambda ctx: (ctx.in_formats[0],),
    runtime_params=_conf_params, process=_conf_process,
    interfaces=("conference",),
))


# --- small explicit mixers (graph-local, e.g. dtmf interleave, local play) --
def _mk_mixN(n):
    def process(state, ins, params, ctx):
        acc = ins[0] * params["gains"][0][:, None]
        for i in range(1, n):
            acc = acc + ins[i] * params["gains"][i][:, None]
        return state, (jnp.clip(acc, -1.0, 1.0),), {}

    def rparams(ctx):
        return {"gains": jnp.ones((n, ctx.batch), jnp.float32)}

    register_filter(FilterDef(
        name=f"mix{n}", ninputs=n, noutputs=1,
        out_formats=lambda ctx: (ctx.in_formats[0],),
        runtime_params=rparams, process=process,
    ))


_mk_mixN(2)
_mk_mixN(3)
_mk_mixN(4)


# --- RFC6464/6465-style per-member levels for SFU speaker selection ---------
def _levels_process(state, ins, params, ctx):
    x = ins[0]
    e = (x * x).mean(axis=1)
    sm = 0.7 * state["energy"] + 0.3 * e
    return {"energy": sm}, (x,), {"level": sm}


register_filter(FilterDef(
    name="audio_levels", ninputs=1, noutputs=1,
    out_formats=lambda ctx: (ctx.in_formats[0],),
    init=lambda ctx: {"energy": jnp.zeros((ctx.batch,), jnp.float32)},
    process=_levels_process,
))
