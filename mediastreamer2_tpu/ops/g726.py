"""G.726 ADPCM (16/24/32/40 kbit/s) — per-sample recurrence as lax.scan.

Reference: src/audiofilters/g726.c:170-205 (eight MSFilter identities over
spandsp's G.726).  spandsp is not in this image, so the codec is
implemented from the ITU-T G.726 specification: log-domain quantizers with
the standard scaled tables (x128 log2 domain), W/F scale-factor and speed
adaptation, fast/locked scale factors (yu/yl, al), and the 2-pole/6-zero
adaptive predictor with the spec's stability clamps.

Arithmetic note: the predictor multiplies run in float32 (the VPU's native
width) rather than the spec's 11-bit pseudo-floating-point FMULT, so output
is algorithmically G.726 but not bit-exact against ITU fixed-point test
vectors; encoder and decoder share the reconstruction path, so round-trips
are exact in-framework and cross-interop degrades gracefully (validated by
round-trip SNR tests at all four rates).

Device design: same pattern as G.722/DVI4 — lax.scan over the 80 samples of a
tick, body fully vectorized across legs.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from mediastreamer2_tpu.core.filter import FilterDef, register_filter
from mediastreamer2_tpu.ops.g711 import float_to_pcm16, pcm16_to_float

# Per-rate tables (ITU G.726; scaled-by-128 log2 domain as in the spec's
# fixed-point description).  qtab = decision thresholds, dqln =
# reconstruction levels, W = scale factor multipliers, F = speed weights.
_RATE_TABLES = {
    2: {  # 16 kbit/s
        "qtab": np.array([261], np.int32),
        "dqln": np.array([116, 365], np.int32),
        "W": np.array([-22, 439], np.int32),
        "F": np.array([0, 7], np.int32),
    },
    3: {  # 24 kbit/s
        "qtab": np.array([-8, 171, 285], np.int32),
        "dqln": np.array([-2048, 135, 273, 373], np.int32),
        "W": np.array([-4, 30, 137, 582], np.int32),
        "F": np.array([0, 1, 2, 7], np.int32),
    },
    4: {  # 32 kbit/s
        "qtab": np.array([-124, 80, 178, 246, 300, 349, 400], np.int32),
        "dqln": np.array([-2048, 4, 135, 213, 273, 323, 373, 425], np.int32),
        "W": np.array([-12, 18, 41, 64, 112, 198, 355, 1122], np.int32),
        "F": np.array([0, 0, 0, 1, 1, 1, 3, 7], np.int32),
    },
    5: {  # 40 kbit/s
        "qtab": np.array([-122, -16, 67, 138, 197, 249, 297, 338,
                          377, 412, 444, 474, 501, 527, 552], np.int32),
        "dqln": np.array([-2048, -66, 28, 104, 169, 224, 274, 318,
                          358, 395, 429, 459, 488, 514, 539, 566], np.int32),
        "W": np.array([14, 14, 24, 39, 40, 41, 58, 100, 141, 179,
                       219, 280, 358, 440, 529, 696], np.int32),
        "F": np.array([0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 2, 3, 4, 5, 6, 6],
                      np.int32),
    },
}


def g726_state(B: int):
    z = lambda *s: jnp.zeros((B,) + s, jnp.float32)  # noqa: E731
    return {
        "b": z(6), "dq": z(6),            # zero section
        "a1": z(), "a2": z(),             # pole section
        "sr1": z(), "sr2": z(), "p1": z(), "p2": z(),
        "yu": jnp.full((B,), 544.0),      # fast scale factor (log*128)
        "yl": jnp.full((B,), 34816.0),    # locked, extra <<6 precision
        "dms": z(), "dml": z(), "ap": z(),
        "td": z(),
    }


def _step(bits: int):
    t = _RATE_TABLES[bits]
    qtab = jnp.asarray(t["qtab"], jnp.float32)
    dqln = jnp.asarray(t["dqln"], jnp.float32)
    W = jnp.asarray(t["W"], jnp.float32)
    F = jnp.asarray(t["F"], jnp.float32)
    n_codes = 1 << bits
    half = n_codes // 2

    def reconstruct(st, code):
        """Shared encoder/decoder back half: code -> (st', sr, y)."""
        mag = jnp.abs(code - half + 0.5) - 0.5   # |I| for sign-magnitude
        mag = jnp.where(code >= half, code - half, half - 1 - code)
        sign = jnp.where(code >= half, 1.0, -1.0)
        y = _scale(st)
        dql = dqln[mag.astype(jnp.int32)] + y / 4.0     # log domain
        dq = sign * jnp.exp2(dql / 128.0)
        dq = jnp.where(dql < -1024, 0.0, dq)            # "-2048" = zero level
        sez = jnp.sum(st["b"] * st["dq"], axis=-1)
        se = sez + st["a1"] * st["sr1"] + st["a2"] * st["sr2"]
        sr = se + dq
        st = _adapt(st, dq, sr, sez, mag.astype(jnp.int32), y)
        return st, sr, se, sez

    def _scale(st):
        al = jnp.clip(st["ap"] / 256.0, 0.0, 1.0)
        return al * st["yu"] + (1.0 - al) * (st["yl"] / 64.0)

    def _adapt(st, dq, sr, sez, mag, y):
        # scale factor (yu fast / yl locked)
        w = W[mag]
        yu = jnp.clip(y + (w * 32.0 - y) / 32.0, 544.0, 5120.0)
        yl = st["yl"] + (yu - st["yl"] / 64.0)      # yl carries <<6
        yl = jnp.clip(yl, 544.0 * 64, 5120.0 * 64)
        # adaptation speed
        f = F[mag]
        dms = st["dms"] + (f * 32.0 - st["dms"]) / 32.0
        dml = st["dml"] + (f * 128.0 - st["dml"]) / 128.0
        # tone / transition detection (cf. spec TRANS/TONE blocks)
        td = (st["a2"] < -0.71875).astype(jnp.float32)
        tr = (st["td"] > 0) & (jnp.abs(dq) > 1.5 * jnp.exp2(st["yl"] / 64.0
                                                            / 128.0))
        ax = jnp.where((y < 1536.0) | (td > 0)
                       | (jnp.abs(dms / 4.0 - dml / 16.0) >= dml / 128.0),
                       1.0, 0.0)
        ap = jnp.where(tr, 256.0, st["ap"] + (ax * 512.0 - st["ap"]) / 16.0)
        # predictor update (sign-sign LMS with leakage + stability clamps)
        sign_dq = jnp.sign(dq)
        sign_dqi = jnp.sign(st["dq"])
        b = jnp.where(tr[:, None], 0.0,
                      st["b"] * (1 - 1.0 / 256.0)
                      + (1.0 / 128.0) * sign_dq[:, None] * sign_dqi)
        p0 = dq + sez
        sign_p0 = jnp.sign(p0)
        a2 = st["a2"] * (1 - 1.0 / 128.0) + (1.0 / 128.0) * (
            sign_p0 * jnp.sign(st["p2"])
            - 4.0 * jnp.clip(st["a1"] * sign_p0 * jnp.sign(st["p1"]),
                             -0.25, 0.25))  # f(a1) approx per spec
        a2 = jnp.clip(a2, -0.75, 0.75)
        a1 = st["a1"] * (1 - 1.0 / 256.0) \
            + (3.0 / 256.0) * sign_p0 * jnp.sign(st["p1"])
        lim = 1.0 - (1.0 / 16.0) - a2
        a1 = jnp.clip(a1, -lim, lim)
        a1 = jnp.where(tr, 0.0, a1)
        a2 = jnp.where(tr, 0.0, a2)
        return {
            "b": b,
            "dq": jnp.concatenate([dq[:, None], st["dq"][:, :5]], axis=1),
            "a1": a1, "a2": a2,
            "sr1": sr, "sr2": st["sr1"],
            "p1": p0, "p2": st["p1"],
            "yu": yu, "yl": yl, "dms": dms, "dml": dml, "ap": ap,
            "td": td,
        }

    def enc_step(st, x):
        sez = jnp.sum(st["b"] * st["dq"], axis=-1)
        se = sez + st["a1"] * st["sr1"] + st["a2"] * st["sr2"]
        d = x - se
        y = _scale(st)
        dl = jnp.log2(jnp.maximum(jnp.abs(d), 1e-6)) * 128.0
        dln = dl - y / 4.0
        mag = jnp.sum(dln[:, None] >= qtab, axis=1)     # 0..half-1
        mag = jnp.minimum(mag, half - 1)
        code = jnp.where(d >= 0, half + mag, half - 1 - mag)
        st, _, _, _ = reconstruct(st, code)
        return st, code

    def dec_step(st, code):
        st, sr, _, _ = reconstruct(st, code)
        return st, sr

    return enc_step, dec_step


def g726_encode(pcm16, state, bits: int = 4):
    """pcm16 [B,S] int16-range -> (codes [B,S] int32 in [0, 2^bits), state')."""
    enc_step, _ = _step(bits)
    x = pcm16.astype(jnp.float32) / 4.0            # 14-bit domain per spec
    state, codes = jax.lax.scan(enc_step, state, x.T)
    return codes.T.astype(jnp.int32), state


def g726_decode(codes, state, bits: int = 4):
    _, dec_step = _step(bits)
    state, sr = jax.lax.scan(dec_step, state, codes.T)
    pcm = jnp.clip(sr.T * 4.0, -32768, 32767)
    return pcm, state


def pack_codes(codes: np.ndarray, bits: int) -> bytes:
    """Little-endian nibble packing per RFC 3551 §4.5.4 (aal2 ordering is
    the byte-reversed variant the reference also registers)."""
    flat = np.asarray(codes, np.uint8).reshape(-1)
    acc = 0
    nbits = 0
    out = bytearray()
    for c in flat:
        acc |= int(c) << nbits
        nbits += bits
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def unpack_codes(data: bytes, bits: int, n: int) -> np.ndarray:
    acc = 0
    nbits = 0
    out = np.zeros(n, np.int32)
    i = 0
    mask = (1 << bits) - 1
    for byte in data:
        acc |= byte << nbits
        nbits += 8
        while nbits >= bits and i < n:
            out[i] = acc & mask
            acc >>= bits
            nbits -= bits
            i += 1
    return out


# --- filter registration (the four rates, cf. g726.c:170-205) --------------
def _mk(bits, kbps):
    def init(ctx):
        return g726_state(ctx.batch)

    def enc_process(state, ins, params, ctx):
        codes, state = g726_encode(float_to_pcm16(ins[0]), state, bits)
        return state, (codes,), {}

    def dec_process(state, ins, params, ctx):
        pcm, state = g726_decode(ins[0], state, bits)
        return state, (pcm16_to_float(pcm),), {}

    register_filter(FilterDef(
        name=f"g726_{kbps}_enc", ninputs=1, noutputs=1,
        out_formats=lambda ctx: (ctx.in_formats[0].with_(
            kind=f"g726_{kbps}"),),
        init=init, process=enc_process,
        category="encoder", enc_fmt=f"g726_{kbps}",
        interfaces=("audio_encoder",),
    ))
    register_filter(FilterDef(
        name=f"g726_{kbps}_dec", ninputs=1, noutputs=1,
        out_formats=lambda ctx: (ctx.in_formats[0].with_(kind="pcm"),),
        init=init, process=dec_process,
        category="decoder", enc_fmt=f"g726_{kbps}",
        interfaces=("audio_decoder",),
    ))


for _bits, _kbps in ((2, 16), (3, 24), (4, 32), (5, 40)):
    _mk(_bits, _kbps)
