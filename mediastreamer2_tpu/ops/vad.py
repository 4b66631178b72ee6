"""Energy VAD + DTX/comfort-noise signaling.

Reference: MSVadDtx (src/audiofilters/msvaddtx.c:176-192) — energy VAD
(bcg729's VAD when available) that emits silence-detected events and CN
payload parameters so the RTP sender can stop media and send RFC3389 CN.

Batched: smoothed block energy vs adaptive noise-floor estimate; the
``vad_update``/``silence_start``/``noise_level`` outputs surface as event
tensors the host RTP layer turns into DTX decisions and CN packets.
"""
from __future__ import annotations

import jax.numpy as jnp

from mediastreamer2_tpu.core.filter import FilterDef, register_filter

HANGOVER_TICKS = 30     # keep "voice" for 300 ms after last activity


def _vad_init(ctx):
    B = ctx.batch
    return {
        "floor": jnp.full((B,), 1e-6, jnp.float32),   # noise floor (energy)
        "energy": jnp.zeros((B,), jnp.float32),
        "hangover": jnp.zeros((B,), jnp.int32),
        "voice": jnp.ones((B,), jnp.bool_),
        "sil_ticks": jnp.zeros((B,), jnp.int32),      # running silence length
    }


def _vad_params(ctx):
    B = ctx.batch
    return {
        "enabled": jnp.ones((B,), jnp.bool_),
        "threshold_ratio": jnp.full((B,), 4.0, jnp.float32),  # energy over floor
        # -- silence detection surface (MS_VAD_ENABLE_SILENCE_DETECTION /
        # MS_VAD_SET_SILENCE_DURATION_THRESHOLD, the mswebrtc vad filter's
        # method set exercised by the basic_audio silence tester) --
        "silence_detection": jnp.zeros((B,), jnp.bool_),
        "silence_duration_ticks": jnp.full((B,), 100, jnp.int32),   # 1000 ms
        # absolute energy gate for silence measurement (~ -40 dBov); the
        # MS_VAD_SET_MODE aggressiveness ladder maps onto this value
        "silence_energy": jnp.full((B,), 1e-4, jnp.float32),
    }


def _vad_process(state, ins, params, ctx):
    x = ins[0]
    e = (x * x).mean(axis=1)
    energy = 0.7 * state["energy"] + 0.3 * e
    # noise floor: fast down, slow up (classic minimum statistics lite)
    floor = jnp.where(e < state["floor"],
                      0.8 * state["floor"] + 0.2 * e,
                      state["floor"] * 1.02)
    floor = jnp.maximum(floor, 1e-9)
    # decide on instantaneous block energy so silence is caught within a tick
    active = e > params["threshold_ratio"] * floor
    hangover = jnp.where(active, HANGOVER_TICKS,
                         jnp.maximum(state["hangover"] - 1, 0))
    voice = active | (hangover > 0)
    voice = jnp.where(params["enabled"], voice, True)
    silence_start = state["voice"] & ~voice
    voice_start = ~state["voice"] & voice
    # -- silence-duration measurement (raw energy gate, no hangover: the
    # reported durations are the recording's actual quiet spans, like the
    # mswebrtc vad the basic_audio tester drives) ------------------------
    quiet = e <= params["silence_energy"]
    sil_ticks = jnp.where(quiet, state["sil_ticks"] + 1, 0)
    sd_on = params["silence_detection"]
    thr_t = params["silence_duration_ticks"]
    # MS_VAD_EVENT_SILENCE_DETECTED: fires once, when the quiet span
    # crosses the configured duration threshold
    silence_detected = sd_on & (sil_ticks == thr_t)
    # MS_VAD_EVENT_SILENCE_ENDED: voice resumed after a reported silence;
    # value = the span's length in ms (0 = no event this tick)
    ended = sd_on & ~quiet & (state["sil_ticks"] >= thr_t)
    silence_ended_ms = jnp.where(ended, state["sil_ticks"] * 10, 0)
    new_state = {"floor": floor, "energy": energy,
                 "hangover": hangover, "voice": voice,
                 "sil_ticks": sil_ticks}
    return new_state, (x,), {
        "silence_start": silence_start,    # cf. MS_VAD_DTX events
        "voice_start": voice_start,
        "noise_level": jnp.where(silence_start, jnp.sqrt(floor), 0.0),
        "silence_detected": silence_detected,
        "silence_ended_ms": silence_ended_ms,
    }


register_filter(FilterDef(
    name="vad_dtx", ninputs=1, noutputs=1,
    out_formats=lambda ctx: (ctx.in_formats[0],),
    init=_vad_init, runtime_params=_vad_params, process=_vad_process,
    interfaces=("vad",),
))
