"""Polyphase resampler — re-designed as one matmul per tick.

Reference: MSResample wraps the speexdsp polyphase resampler
(src/audiofilters/msresample.c:114,237-254), which walks samples with a
fractional phase accumulator — a scalar inner loop.  Batched design:
because every tick converts a *fixed* number of input samples (rate_in/100)
to a *fixed* number of output samples (rate_out/100) and the phase pattern
repeats exactly every tick, the whole conversion is a **static linear map**:

    out[B, N_out] = x_ext[B, H + N_in] @ R.T

where ``R`` is a precomputed windowed-sinc (Kaiser) polyphase matrix and
``x_ext`` prepends H history samples carried in state.  One matmul per tick
runs the entire filter bank for every leg (f32 at ``Precision.HIGHEST``,
never TF32); quality matches speexdsp's high
settings (Kaiser-windowed sinc, ~16-tap-per-phase at unity ratio, stretched
for downsampling).  Fixed latency = ``support`` input samples.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import jax
import jax.numpy as jnp

from mediastreamer2_tpu.core.filter import FilterDef, register_filter
from mediastreamer2_tpu.core.block import tick_samples

HALF_TAPS = 16          # one-sided taps at unity ratio (speex quality ~7)
KAISER_BETA = 8.6       # ~80 dB stopband
ROLLOFF = 0.945


@functools.lru_cache(maxsize=None)
def resample_matrix(rate_in: int, rate_out: int):
    """Build (R [N_out, H+N_in], H, support) for one tick of conversion."""
    n_in = tick_samples(rate_in)
    n_out = tick_samples(rate_out)
    ratio = rate_in / rate_out                    # input samples per output sample
    stretch = max(1.0, ratio)                     # kernel stretch for downsampling
    support = HALF_TAPS * stretch                 # one-sided support, input samples
    # latency = whole number of OUTPUT samples (so converted streams stay
    # sample-aligned even for fractional ratios like 44100<->48000)
    delay_out = int(math.ceil(support / ratio))
    shift = delay_out * ratio                     # >= support, in input samples
    H = int(math.ceil(shift + support))
    fc = ROLLOFF * 0.5 / stretch                  # cutoff, cycles per input sample

    m = np.arange(H + n_in, dtype=np.float64)
    centers = (H - shift) + np.arange(n_out, dtype=np.float64) * ratio
    t = m[None, :] - centers[:, None]             # [n_out, H+n_in]
    x = t / support
    win = np.where(np.abs(x) < 1.0,
                   np.i0(KAISER_BETA * np.sqrt(np.maximum(0.0, 1 - x * x)))
                   / np.i0(KAISER_BETA), 0.0)
    core = 2 * fc * np.sinc(2 * fc * t)
    R = core * win
    R /= R.sum(axis=1, keepdims=True)             # exact DC gain of 1 per phase
    return R.astype(np.float32), H, support


def _resample_formats(ctx):
    fmt = ctx.in_formats[0]
    return (fmt.with_(rate=int(ctx.params["out_rate"])),)


def _resample_init(ctx):
    fmt = ctx.in_formats[0]
    _, H, _ = resample_matrix(fmt.rate, int(ctx.params["out_rate"]))
    return {"hist": jnp.zeros((ctx.batch, H * fmt.channels), jnp.float32)}


def _resample_process(state, ins, params, ctx):
    fmt = ctx.in_formats[0]
    out_rate = int(ctx.params["out_rate"])
    R_np, H, _ = resample_matrix(fmt.rate, out_rate)
    R = jnp.asarray(R_np)                          # trace-time constant
    ch = fmt.channels
    x = ins[0]
    B = x.shape[0]
    x_ext = jnp.concatenate([state["hist"], x], axis=1)
    if ch == 1:
        out = jnp.matmul(x_ext, R.T, precision=jax.lax.Precision.HIGHEST)
    else:
        xe = x_ext.reshape(B, -1, ch)              # de-interleave
        out = jnp.einsum("om,bmc->boc", R, xe,
                         precision=jax.lax.Precision.HIGHEST).reshape(B, -1)
    new_hist = x_ext[:, -H * ch:]
    return {"hist": new_hist}, (out,), {}


register_filter(FilterDef(
    name="resample", ninputs=1, noutputs=1,
    out_formats=_resample_formats, init=_resample_init,
    process=_resample_process,
))


# --- channel adapter (reference: src/audiofilters/chanadapt.c) --------------
def _chan_formats(ctx):
    return (ctx.in_formats[0].with_(channels=int(ctx.params["out_channels"])),)


def _chan_process(state, ins, params, ctx):
    in_ch = ctx.in_formats[0].channels
    out_ch = int(ctx.params["out_channels"])
    x = ins[0]
    B = x.shape[0]
    if in_ch == out_ch:
        return state, (x,), {}
    xs = x.reshape(B, -1, in_ch)
    if out_ch == 1:
        out = xs.mean(axis=2)                      # downmix
    elif in_ch == 1:
        out = jnp.repeat(xs, out_ch, axis=2).reshape(B, -1)
        return state, (out,), {}
    else:
        out = jnp.repeat(xs.mean(axis=2, keepdims=True), out_ch, axis=2).reshape(B, -1)
    return state, (out,), {}


register_filter(FilterDef(
    name="channel_adapter", ninputs=1, noutputs=1,
    out_formats=_chan_formats, process=_chan_process,
))
