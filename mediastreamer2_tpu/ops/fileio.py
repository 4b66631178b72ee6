"""Device-resident file player / recorder filters.

Reference: MSFilePlayer (src/audiofilters/msfileplayer.c:541-558 — WAV/raw
reader with loop/seek/EOF events) and MSFileRec (msfilerec.c:320-337).

Batched design: instead of per-tick host reads, the *whole decoded
signal* is uploaded once into device HBM as part of filter state; each tick
is a batched gather (player) or a dynamic-slice store (recorder).  This
keeps the hot loop free of host I/O — the host only touches the file at
open/close, exactly like the reference's async read thread keeps I/O off
the ticker (src/audiofilters/asyncrw.c).

Player state: data [B, T], pos [B] — per-leg position so legs can loop or
seek independently (params: playing, loop).  EOF is raised per leg as an
event tensor (parity: MS_PLAYER_EOF notify).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from mediastreamer2_tpu.core.block import Format
from mediastreamer2_tpu.core.filter import FilterDef, register_filter


def _player_formats(ctx):
    return (ctx.params["fmt"],)


def _player_init(ctx):
    sig = np.asarray(ctx.params["signal"], dtype=np.float32)
    if sig.ndim == 1:
        sig = np.broadcast_to(sig, (ctx.batch,) + sig.shape)
    assert sig.shape[0] == ctx.batch
    return {
        "data": jnp.asarray(sig),
        "length": jnp.full((ctx.batch,), sig.shape[1], jnp.int32),
        "pos": jnp.zeros((ctx.batch,), jnp.int32),
    }


def _player_params(ctx):
    return {
        "playing": jnp.ones((ctx.batch,), jnp.bool_),
        "loop": jnp.zeros((ctx.batch,), jnp.bool_),     # cf. MS_PLAYER_SET_LOOP
    }


def _player_process(state, ins, params, ctx):
    fmt: Format = ctx.params["fmt"]
    S = fmt.samples_per_tick
    pos, length = state["pos"], state["length"]
    idx = pos[:, None] + jnp.arange(S, dtype=jnp.int32)[None, :]
    valid = idx < length[:, None]
    safe_idx = jnp.where(valid, idx, 0)
    out = jnp.take_along_axis(state["data"], safe_idx, axis=1)
    out = jnp.where(valid & params["playing"][:, None], out, 0.0)
    new_pos = jnp.where(params["playing"], pos + S, pos)
    eof = (pos < length) & (new_pos >= length)
    new_pos = jnp.where((new_pos >= length) & params["loop"],
                        jnp.zeros_like(new_pos), new_pos)
    return {**state, "pos": new_pos}, (out,), {"eof": eof}


register_filter(FilterDef(
    name="file_player", ninputs=0, noutputs=1,
    out_formats=_player_formats, init=_player_init,
    runtime_params=_player_params, process=_player_process,
    interfaces=("player",),
))


# --- recorder ---------------------------------------------------------------
def _rec_init(ctx):
    max_ticks = int(ctx.params.get("max_ticks", 1000))
    S = ctx.in_formats[0].samples_per_tick
    return {
        "buf": jnp.zeros((ctx.batch, max_ticks * S), jnp.float32),
        "tick": jnp.zeros((), jnp.int32),
    }


def _rec_params(ctx):
    return {"recording": jnp.ones((), jnp.bool_)}


def _rec_process(state, ins, params, ctx):
    S = ctx.in_formats[0].samples_per_tick
    max_ticks = int(ctx.params.get("max_ticks", 1000))
    tick = jnp.minimum(state["tick"], max_ticks - 1)
    buf = jax.lax.dynamic_update_slice(state["buf"], ins[0], (0, tick * S))
    # freeze writes when stopped or full (keeps shapes static)
    buf = jnp.where(params["recording"] & (state["tick"] < max_ticks),
                    buf, state["buf"])
    new_tick = state["tick"] + jnp.where(params["recording"], 1, 0)
    return {"buf": buf, "tick": new_tick}, (), {}


register_filter(FilterDef(
    name="file_recorder", ninputs=1, noutputs=0,
    out_formats=lambda ctx: (), init=_rec_init,
    runtime_params=_rec_params, process=_rec_process,
    interfaces=("recorder",),
))


def recorder_get_audio(state_entry, n_ticks=None, tick_samples=None):
    """Host helper: pull recorded PCM from a file_recorder node's state."""
    buf = np.asarray(state_entry["buf"])
    if n_ticks is not None and tick_samples is not None:
        buf = buf[:, : n_ticks * tick_samples]
    return buf
