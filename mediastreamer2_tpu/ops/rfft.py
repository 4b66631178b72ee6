"""Real-pair FFTs as matmuls.

For the fixed, modest transform sizes of a 10 ms tick (N = 160..960) a DFT
is a matmul with a constant cos/sin basis, which batches over every leg in
one GEMM and fuses with the surrounding elementwise work. Everything
carries spectra as (re, im) float32 pairs; no complex dtype exists anywhere
on the device. Whether cuFFT beats this at tick sizes is not measured yet.

Every f32 product runs at ``Precision.HIGHEST``: the default precision may
run as TF32 on GPU tensor cores (~3 decimal digits), which the echo
canceller's ERLE and the device-vs-CPU quality bar do not tolerate.

Conventions match numpy.fft.rfft/irfft (forward: X_k = sum x_n e^{-2pi i nk/N}).
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST


@functools.lru_cache(maxsize=None)
def _fwd_mats(n: int):
    k = np.arange(n // 2 + 1)
    t = np.arange(n)
    ang = 2 * np.pi * np.outer(t, k) / n            # [n, F]
    return (np.cos(ang).astype(np.float32),
            (-np.sin(ang)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _inv_mats(n: int):
    f = n // 2 + 1
    k = np.arange(f)
    t = np.arange(n)
    ang = 2 * np.pi * np.outer(k, t) / n            # [F, n]
    w = np.full(f, 2.0)
    w[0] = 1.0
    if n % 2 == 0:
        w[-1] = 1.0
    cw = (np.cos(ang) * w[:, None] / n).astype(np.float32)
    sw = (-np.sin(ang) * w[:, None] / n).astype(np.float32)
    return cw, sw


import os

# Optional bf16 basis matrices (RFFT_BF16=1, an A/B knob; not measured on
# the GPU): f32 at HIGHEST precision is the default.
_USE_BF16 = os.environ.get("RFFT_BF16", "0") != "0"


def _mm(x, m):
    if _USE_BF16:
        return jnp.matmul(x.astype(jnp.bfloat16), jnp.asarray(m, jnp.bfloat16),
                          preferred_element_type=jnp.float32)
    return jnp.matmul(x, jnp.asarray(m), precision=HIGHEST)


def rfft(x, n: int):
    """x [..., n] float32 -> (re, im) each [..., n//2+1]."""
    c, s = _fwd_mats(n)
    return _mm(x, c), _mm(x, s)


def irfft(re, im, n: int):
    """(re, im) [..., n//2+1] -> x [..., n]."""
    cw, sw = _inv_mats(n)
    # x_t = (1/n) sum_k w_k [re_k cos(2pi kt/n) - im_k sin(2pi kt/n)]
    return _mm(re, cw) + _mm(im, sw)


def rfft_tail(x_tail, n: int):
    """rfft of [zeros(n/2), x_tail] without materializing the zeros.

    The zero half contributes nothing to the contraction, so the matmul
    runs on the basis rows n/2: only — half the MACs of rfft(), exactly
    the same values (adding exact zeros is lossless).  This is the MDF
    error-spectrum transform (ops/aec.py: E = rfft([0, e]))."""
    c, s = _fwd_mats(n)
    h = n // 2
    return _mm(x_tail, c[h:]), _mm(x_tail, s[h:])


def irfft_tail(re, im, n: int):
    """Last n/2 samples of irfft(re, im, n), via the basis columns n/2:
    only — half the MACs, identical values.  This is the overlap-save
    output extraction (ops/aec.py: y = irfft(Y)[:, S:])."""
    cw, sw = _inv_mats(n)
    h = n // 2
    return _mm(re, cw[:, h:]) + _mm(im, sw[:, h:])


@functools.lru_cache(maxsize=None)
def _constraint_mats(n: int):
    """The MDF gradient (causality) constraint — time-domain projection
    irfft -> zero the last n/2 samples -> rfft — folded into one constant
    [F, F] complex linear operator, precomputed in float64:

        g' = R @ diag(mask) @ I  applied to (re, im) pairs.

    Costs 4 matmuls of [F,F] instead of 4 of [F,n] (2.0x fewer MACs for
    n = 2F-2) and skips the [., n] time-domain intermediate entirely."""
    f = n // 2 + 1
    k = np.arange(f)
    t = np.arange(n)
    ang_i = 2 * np.pi * np.outer(k, t) / n           # inverse [F, n]
    w = np.full(f, 2.0)
    w[0] = 1.0
    if n % 2 == 0:
        w[-1] = 1.0
    cw = np.cos(ang_i) * w[:, None] / n
    sw = -np.sin(ang_i) * w[:, None] / n
    ang_f = 2 * np.pi * np.outer(t, k) / n           # forward [n, F]
    c = np.cos(ang_f)
    s = -np.sin(ang_f)
    h = n // 2                                       # keep samples [0, h)
    arr = (cw[:, :h] @ c[:h]).astype(np.float32)
    ari = (cw[:, :h] @ s[:h]).astype(np.float32)
    air = (sw[:, :h] @ c[:h]).astype(np.float32)
    aii = (sw[:, :h] @ s[:h]).astype(np.float32)
    return arr, ari, air, aii


def apply_constraint(re, im, n: int):
    """(re, im) -> constrained (re', im'): equivalent to
    rfft(irfft(re, im, n).at[..., n//2:].set(0), n)."""
    arr, ari, air, aii = _constraint_mats(n)
    return (_mm(re, arr) + _mm(im, air),
            _mm(re, ari) + _mm(im, aii))


def cmul(ar, ai, br, bi):
    """(ar+i ai)(br+i bi) -> (re, im)."""
    return ar * br - ai * bi, ar * bi + ai * br


def cmul_conj(ar, ai, br, bi):
    """conj(a) * b -> (re, im)."""
    return ar * br + ai * bi, ar * bi - ai * br


def cabs2(re, im):
    return re * re + im * im
