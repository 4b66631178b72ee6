"""G.722 (64 kbit/s SB-ADPCM, ITU-T G.722) — QMF + two-band ADPCM as lax.scan.

Parity: src/audiofilters/msg722.c:169-351 wrapping the bundled ITU
implementation src/utils/g722_encode.c / g722_decode.c (tests are bit-exact
against vectors generated from that implementation).  RTP quirk preserved:
payload type 9 runs 16 kHz audio on an 8 kHz RTP clock (RFC 3551 §4.5.2).

Device design: the per-sample recurrence (predictor adaptation, log scale
factor) follows the DVI4 pattern (ops/adpcm.py) — a ``lax.scan`` over the
80 8-kHz code slots of a tick whose body is fully vectorized across legs:
QMF analysis/synthesis, both bands' quantizers and the block4 pole/zero
predictor all advance every leg at once on the VPU.

All constant tables are the standards-defined ITU G.722 tables (same
category as the IMA/G.711 tables per the round-1 review).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from mediastreamer2_tpu.core.filter import FilterDef, register_filter
from mediastreamer2_tpu.ops.g711 import float_to_pcm16, pcm16_to_float

# --- ITU G.722 tables -------------------------------------------------------
_Q6 = np.array([
    0, 35, 72, 110, 150, 190, 233, 276, 323, 370, 422, 473, 530, 587, 650,
    714, 786, 858, 940, 1023, 1121, 1219, 1339, 1458, 1612, 1765, 1980,
    2195, 2557, 2919, 0, 0], dtype=np.int32)
_ILN = np.array([
    0, 63, 62, 31, 30, 29, 28, 27, 26, 25, 24, 23, 22, 21, 20, 19, 18, 17,
    16, 15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 0], dtype=np.int32)
_ILP = np.array([
    0, 61, 60, 59, 58, 57, 56, 55, 54, 53, 52, 51, 50, 49, 48, 47, 46, 45,
    44, 43, 42, 41, 40, 39, 38, 37, 36, 35, 34, 33, 32, 0], dtype=np.int32)
_WL = np.array([-60, -30, 58, 172, 334, 538, 1198, 3042], dtype=np.int32)
_RL42 = np.array([0, 7, 6, 5, 4, 3, 2, 1, 7, 6, 5, 4, 3, 2, 1, 0],
                 dtype=np.int32)
_ILB = np.array([
    2048, 2093, 2139, 2186, 2233, 2282, 2332, 2383, 2435, 2489, 2543, 2599,
    2656, 2714, 2774, 2834, 2896, 2960, 3025, 3091, 3158, 3228, 3298, 3371,
    3444, 3520, 3597, 3676, 3756, 3838, 3922, 4008], dtype=np.int32)
_WH = np.array([0, -214, 798], dtype=np.int32)
_RH2 = np.array([2, 1, 2, 1], dtype=np.int32)
_QM2 = np.array([-7408, -1616, 7408, 1616], dtype=np.int32)
_QM4 = np.array([
    0, -20456, -12896, -8968, -6288, -4240, -2584, -1200,
    20456, 12896, 8968, 6288, 4240, 2584, 1200, 0], dtype=np.int32)
_QM6 = np.array([
    -136, -136, -136, -136, -24808, -21904, -19008, -16704, -14984, -13512,
    -12280, -11192, -10232, -9360, -8576, -7856, -7192, -6576, -6000, -5456,
    -4944, -4464, -4008, -3576, -3168, -2776, -2400, -2032, -1688, -1360,
    -1040, -728, 24808, 21904, 19008, 16704, 14984, 13512, 12280, 11192,
    10232, 9360, 8576, 7856, 7192, 6576, 6000, 5456, 4944, 4464, 4008, 3576,
    3168, 2776, 2400, 2032, 1688, 1360, 1040, 728, 432, 136, -432, -136],
    dtype=np.int32)
_IHN = np.array([0, 1, 0], dtype=np.int32)
_IHP = np.array([0, 3, 2], dtype=np.int32)
_QMF = np.array([3, -11, 12, 32, -210, 951, 3876, -805, 362, -156, 53, -11],
                dtype=np.int32)


def _sat16(x):
    return jnp.clip(x, -32768, 32767)


def _band_init(B):
    """Per-leg state of one ADPCM band (encoder and decoder share it)."""
    z = lambda *shape: jnp.zeros((B,) + shape, jnp.int32)  # noqa: E731
    return {"s": z(), "sp": z(), "sz": z(), "r": z(3), "a": z(3), "p": z(3),
            "d": z(7), "b": z(7), "nb": z(), "det": None}


def g722_state(B: int):
    lo = _band_init(B)
    hi = _band_init(B)
    lo["det"] = jnp.full((B,), 32, jnp.int32)
    hi["det"] = jnp.full((B,), 8, jnp.int32)
    return {"lo": lo, "hi": hi, "x": jnp.zeros((B, 24), jnp.int32)}


def _block4(band, d):
    """ITU G.722 block 4: pole/zero predictor adaptation (vectorized [B])."""
    r, a, p, dd, b = band["r"], band["a"], band["p"], band["d"], band["b"]
    dd = dd.at[:, 0].set(d)
    r = r.at[:, 0].set(_sat16(band["s"] + d))                    # RECONS
    p = p.at[:, 0].set(_sat16(band["sz"] + d))                   # PARREC
    # UPPOL2
    sg = p >> 15                                                 # [B,3]
    wd1 = _sat16(a[:, 1] << 2)
    wd2 = jnp.where(sg[:, 0] == sg[:, 1], -wd1, wd1)
    wd2 = jnp.minimum(wd2, 32767)
    wd3 = jnp.where(sg[:, 0] == sg[:, 2], 128, -128)
    wd3 = wd3 + (wd2 >> 7) + ((a[:, 2] * 32512) >> 15)
    ap2 = jnp.clip(wd3, -12288, 12288)
    # UPPOL1
    wd1 = jnp.where(sg[:, 0] == sg[:, 1], 192, -192)
    wd2 = (a[:, 1] * 32640) >> 15
    ap1 = _sat16(wd1 + wd2)
    wd3 = _sat16(15360 - ap2)
    ap1 = jnp.clip(ap1, -wd3, wd3)
    # UPZERO
    wd1 = jnp.where(d == 0, 0, 128)                              # [B]
    sg0 = d >> 15
    sgi = dd[:, 1:7] >> 15                                       # [B,6]
    wd2 = jnp.where(sgi == sg0[:, None], wd1[:, None], -wd1[:, None])
    wd3 = (b[:, 1:7] * 32640) >> 15
    bp = _sat16(wd2 + wd3)                                       # [B,6]
    # DELAYA: d[i]=d[i-1], b[i]=bp[i] for i=6..1; r/p/a shift, a=ap
    dd = jnp.concatenate([dd[:, :1], dd[:, 0:6]], axis=1)
    b = jnp.concatenate([b[:, :1], bp], axis=1)
    r = jnp.stack([r[:, 0], r[:, 0], r[:, 1]], axis=1)
    p = jnp.stack([p[:, 0], p[:, 0], p[:, 1]], axis=1)
    a = jnp.stack([a[:, 0], ap1, ap2], axis=1)
    # FILTEP
    wd1 = (a[:, 1] * _sat16(r[:, 1] + r[:, 1])) >> 15
    wd2 = (a[:, 2] * _sat16(r[:, 2] + r[:, 2])) >> 15
    sp = _sat16(wd1 + wd2)
    # FILTEZ
    sz = _sat16(jnp.sum((b[:, 1:7] * _sat16(dd[:, 1:7] + dd[:, 1:7])) >> 15,
                        axis=1))
    s = _sat16(sp + sz)
    return {"s": s, "sp": sp, "sz": sz, "r": r, "a": a, "p": p,
            "d": dd, "b": b, "nb": band["nb"], "det": band["det"]}


def _scalel(nb, il4, wl_tab, nb_max, shift_base):
    """LOGSCL/LOGSCH + SCALEL/SCALEH -> (nb', det')."""
    ilb = jnp.asarray(_ILB)
    nb = ((nb * 127) >> 7) + wl_tab[il4]
    nb = jnp.clip(nb, 0, nb_max)
    wd1 = (nb >> 6) & 31
    wd2 = shift_base - (nb >> 11)
    wd3 = jnp.where(wd2 < 0, ilb[wd1] << (-wd2), ilb[wd1] >> wd2)
    return nb, wd3 << 2


def _enc_step(carry, xt):
    """One 8 kHz code slot: consume 2 input samples [B,2] -> code byte [B]."""
    lo, hi, x = carry["lo"], carry["hi"], carry["x"]
    q6, iln, ilp = jnp.asarray(_Q6), jnp.asarray(_ILN), jnp.asarray(_ILP)
    qm4, qm2 = jnp.asarray(_QM4), jnp.asarray(_QM2)
    wl, rl42 = jnp.asarray(_WL), jnp.asarray(_RL42)
    wh, rh2 = jnp.asarray(_WH), jnp.asarray(_RH2)
    ihn, ihp = jnp.asarray(_IHN), jnp.asarray(_IHP)
    qmf = jnp.asarray(_QMF)

    # QMF transmit: shift in the two new samples, split bands
    x = jnp.concatenate([x[:, 2:], xt], axis=1)                  # [B,24]
    sumodd = jnp.sum(x[:, 0::2] * qmf, axis=1)
    sumeven = jnp.sum(x[:, 1::2] * qmf[::-1], axis=1)
    xlow = (sumeven + sumodd) >> 13
    xhigh = (sumeven - sumodd) >> 13

    # ---- lower band (6-bit) ----
    el = _sat16(xlow - lo["s"])
    wd = jnp.where(el >= 0, el, -(el + 1))
    th = (q6[1:30] * lo["det"][:, None]) >> 12                   # [B,29]
    i = 1 + jnp.sum(wd[:, None] >= th, axis=1)                   # 1..30
    ilow = jnp.where(el < 0, iln[i], ilp[i])
    ril = ilow >> 2
    dlow = (lo["det"] * qm4[ril]) >> 15
    lo["nb"], lo["det"] = _scalel(lo["nb"], rl42[ril], wl, 18432, 8)
    lo = _block4(lo, dlow)

    # ---- higher band (2-bit) ----
    eh = _sat16(xhigh - hi["s"])
    wd = jnp.where(eh >= 0, eh, -(eh + 1))
    wd1 = (564 * hi["det"]) >> 12
    mih = jnp.where(wd >= wd1, 2, 1)
    ihigh = jnp.where(eh < 0, ihn[mih], ihp[mih])
    dhigh = (hi["det"] * qm2[ihigh]) >> 15
    hi["nb"], hi["det"] = _scalel(hi["nb"], rh2[ihigh], wh, 22528, 10)
    hi = _block4(hi, dhigh)

    code = (ihigh << 6) | ilow
    return {"lo": lo, "hi": hi, "x": x}, code


def _dec_step(carry, code):
    lo, hi, x = carry["lo"], carry["hi"], carry["x"]
    qm4, qm2, qm6 = jnp.asarray(_QM4), jnp.asarray(_QM2), jnp.asarray(_QM6)
    wl, rl42 = jnp.asarray(_WL), jnp.asarray(_RL42)
    wh, rh2 = jnp.asarray(_WH), jnp.asarray(_RH2)
    qmf = jnp.asarray(_QMF)

    ilow = code & 0x3F
    ihigh = (code >> 6) & 3
    # lower band: 6-bit inverse quantizer for the signal, 4-bit for adaptation
    wd2 = (lo["det"] * qm6[ilow]) >> 15
    rlow = jnp.clip(lo["s"] + wd2, -16384, 16383)
    dlowt = (lo["det"] * qm4[ilow >> 2]) >> 15
    lo["nb"], lo["det"] = _scalel(lo["nb"], rl42[ilow >> 2], wl, 18432, 8)
    lo = _block4(lo, dlowt)
    # higher band
    dhigh = (hi["det"] * qm2[ihigh]) >> 15
    rhigh = jnp.clip(dhigh + hi["s"], -16384, 16383)
    hi["nb"], hi["det"] = _scalel(hi["nb"], rh2[ihigh], wh, 22528, 10)
    hi = _block4(hi, dhigh)
    # QMF receive: recombine into two 16 kHz samples
    x = jnp.concatenate([x[:, 2:],
                         (rlow + rhigh)[:, None], (rlow - rhigh)[:, None]],
                        axis=1)
    xout2 = jnp.sum(x[:, 0::2] * qmf, axis=1)
    xout1 = jnp.sum(x[:, 1::2] * qmf[::-1], axis=1)
    # reference casts to int16 (wrap, not saturate): (int16_t)(xout >> 12)
    wrap = lambda v: ((v + 32768) & 0xFFFF) - 32768  # noqa: E731
    out = jnp.stack([wrap(xout1 >> 12), wrap(xout2 >> 12)], axis=1)
    return {"lo": lo, "hi": hi, "x": x}, out


def g722_encode(pcm, state):
    """pcm [B,S] int32 (16 kHz, S even) -> (codes [B,S//2] int32, state')."""
    B, S = pcm.shape
    xs = pcm.reshape(B, S // 2, 2).transpose(1, 0, 2)            # [S/2,B,2]
    state, codes = jax.lax.scan(_enc_step, state, xs)
    return codes.T, state


def g722_decode(codes, state):
    """codes [B,C] int32 -> (pcm [B,2C] int32 @16 kHz, state')."""
    B, C = codes.shape
    state, out = jax.lax.scan(_dec_step, state, codes.T)         # [C,B,2]
    return out.transpose(1, 0, 2).reshape(B, 2 * C), state


# --- filter registration ----------------------------------------------------
def _g722_init(ctx):
    return g722_state(ctx.batch)


def _g722_enc_process(state, ins, params, ctx):
    codes, state = g722_encode(float_to_pcm16(ins[0]), state)
    return state, (codes,), {}


def _g722_dec_process(state, ins, params, ctx):
    pcm, state = g722_decode(ins[0], state)
    return state, (pcm16_to_float(pcm),), {}


register_filter(FilterDef(
    name="g722_enc", ninputs=1, noutputs=1,
    out_formats=lambda ctx: (ctx.in_formats[0].with_(
        kind="g722", rate=ctx.in_formats[0].rate // 2),),
    init=_g722_init, process=_g722_enc_process,
    category="encoder", enc_fmt="g722", interfaces=("audio_encoder",),
))
register_filter(FilterDef(
    name="g722_dec", ninputs=1, noutputs=1,
    out_formats=lambda ctx: (ctx.in_formats[0].with_(
        kind="pcm", rate=ctx.in_formats[0].rate * 2),),
    init=_g722_init, process=_g722_dec_process,
    category="decoder", enc_fmt="g722", interfaces=("audio_decoder",),
))
