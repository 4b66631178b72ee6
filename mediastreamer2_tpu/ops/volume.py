"""MSVolume equivalent: gain / RMS metering / AGC / noise gate / DC removal.

Reference: src/audiofilters/msvolume.c (state struct :48-84, desc :539-551)
— per-sample scalar loops with speex-preprocess-assisted AGC.  Batched:
one fused block computation per tick over all legs; gains evolve per *tick*
with a linear intra-block ramp (click-free, equivalent to the reference's
gain smoothing `gain += (target-gain)*coef` applied per sample).

Echo-limiter peer coupling (volsend ducked by volrecv energy) is expressed
functionally: the session builder wires ``peer_energy`` from the paired
volume filter's emitted energy (see models/audio_leg.py) instead of the
reference's cross-filter pointer.
"""
from __future__ import annotations

import jax.numpy as jnp

from mediastreamer2_tpu.core.filter import FilterDef, register_filter

EN_EWMA = 0.3          # block-energy smoothing
AGC_SPEED_UP = 0.12    # gain decrease speed (attack, fast)
AGC_SPEED_DOWN = 0.02  # gain increase speed (release, slow)
MIN_GAIN = 0.01
MAX_GAIN = 30.0


def _vol_init(ctx):
    B = ctx.batch
    return {
        "energy": jnp.zeros((B,), jnp.float32),        # smoothed RMS^2
        "gain": jnp.ones((B,), jnp.float32),           # current applied gain
        "dc": jnp.zeros((B,), jnp.float32),            # DC estimate
        "level_db": jnp.full((B,), -120.0, jnp.float32),
    }


def _vol_params(ctx):
    B = ctx.batch
    return {
        "static_gain": jnp.ones((B,), jnp.float32),      # MS_VOLUME_SET_GAIN
        "agc_enabled": jnp.zeros((B,), jnp.bool_),       # MS_VOLUME_ENABLE_AGC
        "agc_target": jnp.full((B,), 0.05, jnp.float32),  # target RMS (linear)
        "ng_enabled": jnp.zeros((B,), jnp.bool_),        # MS_VOLUME_ENABLE_NOISE_GATE
        "ng_threshold": jnp.full((B,), 0.003, jnp.float32),  # linear RMS thresh
        "ng_floorgain": jnp.full((B,), 0.0, jnp.float32),
        "dc_removal": jnp.zeros((B,), jnp.bool_),
        # echo limiter: duck send gain when peer (speaker) is active
        "ea_enabled": jnp.zeros((B,), jnp.bool_),
        "ea_threshold": jnp.full((B,), 0.01, jnp.float32),
        "ea_gain": jnp.full((B,), 0.02, jnp.float32),
        "peer_energy": jnp.zeros((B,), jnp.float32),
        "mute": jnp.zeros((B,), jnp.bool_),              # MS_VOLUME_SET_MUTE
    }


def fused_volume(x, gain_start, gain_end, dc, dc_enabled):
    """The per-sample path of one tick: y = clip((x - dc*dcen) * ramp(g0->g1)).

    x [B,S]; per-leg scalars [B]. Returns (y [B,S], block energy of the
    DC-removed input [B], block mean of the raw input [B] — feeds the DC
    tracker). Plain jnp: XLA fuses the elementwise chain and both row
    reductions into one pass over x."""
    S = x.shape[1]
    mean = x.mean(axis=1)
    x = x - (dc * dc_enabled)[:, None]
    ramp = jnp.arange(S, dtype=jnp.float32)[None, :] / S
    g = gain_start[:, None] * (1 - ramp) + gain_end[:, None] * ramp
    return jnp.clip(x * g, -1.0, 1.0), (x * x).mean(axis=1), mean


def _vol_process(state, ins, params, ctx):
    x = ins[0]
    # gain decisions use the previous tick's smoothed energy, so the whole
    # sample path (DC removal + gain ramp + clip + metering) is one fused
    # pass — the reference's per-sample msvolume loop shape.
    energy_prev = state["energy"]
    rms = jnp.sqrt(energy_prev)
    level_db = 10.0 * jnp.log10(energy_prev + 1e-12)

    # AGC: drive rms * gain toward target
    tgt = jnp.clip(params["agc_target"] / (rms + 1e-9), MIN_GAIN, MAX_GAIN)
    agc_gain = jnp.where(params["agc_enabled"], tgt, 1.0)

    # noise gate
    gate = jnp.where(params["ng_enabled"] & (rms < params["ng_threshold"]),
                     params["ng_floorgain"], 1.0)

    # echo limiter: peer active -> duck
    duck = jnp.where(params["ea_enabled"]
                     & (params["peer_energy"] > params["ea_threshold"] ** 2),
                     params["ea_gain"], 1.0)

    target_gain = params["static_gain"] * agc_gain * gate * duck
    target_gain = jnp.where(params["mute"], 0.0, target_gain)
    # asymmetric smoothing: fast to reduce, slow to raise (anti-pump)
    speed = jnp.where(target_gain < state["gain"], AGC_SPEED_UP, AGC_SPEED_DOWN)
    new_gain = state["gain"] + speed * (target_gain - state["gain"])

    dc_en = params["dc_removal"].astype(jnp.float32)
    out, e_block, mean = fused_volume(x, state["gain"], new_gain,
                                      state["dc"], dc_en)
    dc = 0.9 * state["dc"] + 0.1 * mean
    energy = (1 - EN_EWMA) * energy_prev + EN_EWMA * e_block

    new_state = {"energy": energy, "gain": new_gain, "dc": dc, "level_db": level_db}
    return new_state, (out,), {}


register_filter(FilterDef(
    name="volume", ninputs=1, noutputs=1,
    out_formats=lambda ctx: (ctx.in_formats[0],),
    init=_vol_init, runtime_params=_vol_params, process=_vol_process,
    interfaces=("volume",),
))
