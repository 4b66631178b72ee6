"""Host-side codecs (Opus, GSM-FR) via ctypes — the "host filter" tier.

Architecture note: the reference treats hardware codecs as opaque filters
(MediaCodec/VideoToolbox backends under h26x/); equivalently, this batched
framework treats *CPU-library* codecs as host filters that live at the RTP
boundary: payload bytes <-> PCM tick blocks, outside the jitted device
graph (SURVEY.md §7 step 7).  DSP before/after them stays on device.

Reference parity: MSOpusEnc/Dec (src/audiofilters/msopus.c:689,943 — ptime
aggregation, FEC/PLC, DTX, bitrate mgmt) and MSGsmEnc/Dec
(src/audiofilters/gsm.c:137-214).

Linked libraries: libopus.so.0, libgsm.so.1 (present in this image; gated
by availability so the package imports cleanly without them).
"""
from __future__ import annotations

import ctypes
import ctypes.util
import os
from typing import Optional

import numpy as np

# ---------------------------------------------------------------- opus
_opus = None
try:
    _p = ctypes.util.find_library("opus")
    if _p:
        _opus = ctypes.CDLL(_p)
        _opus.opus_encoder_create.restype = ctypes.c_void_p
        _opus.opus_decoder_create.restype = ctypes.c_void_p
        _opus.opus_encode.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int, ctypes.c_void_p,
                                      ctypes.c_int]
        _opus.opus_decode.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int, ctypes.c_void_p,
                                      ctypes.c_int, ctypes.c_int]
except OSError:                                    # pragma: no cover
    _opus = None

OPUS_APPLICATION_VOIP = 2048
OPUS_SET_BITRATE_REQUEST = 4002
OPUS_SET_COMPLEXITY_REQUEST = 4010
OPUS_SET_INBAND_FEC_REQUEST = 4012
OPUS_SET_DTX_REQUEST = 4016
OPUS_SET_PACKET_LOSS_PERC_REQUEST = 4014


def _default_opus_complexity() -> int:
    """CPU-count-scaled encoder complexity, exactly the reference's policy
    (msopus.c:111-141): env override MS2TPU_OPUS_COMPLEXITY (like
    MS2_OPUS_COMPLEXITY), else 0 on a 1-core host, 5 on 2 cores, -1
    (libopus default) otherwise.  libopus' default complexity 9 costs
    ~3-4x the encode CPU of complexity 0 — on the 1-core bench host that
    difference is the mixed-fleet opus class's deadline."""
    env = os.environ.get("MS2TPU_OPUS_COMPLEXITY", "")
    if env:
        return max(-1, min(10, int(env)))
    cores = os.cpu_count() or 1
    if cores == 1:
        return 0
    if cores == 2:
        return 5
    return -1


def opus_available() -> bool:
    return _opus is not None


class OpusEncoder:
    """cf. MSOpusEnc: bitrate/FEC/DTX controls, one 10ms-multiple frame per
    packet (ptime aggregation = frames_per_packet)."""

    def __init__(self, rate: int = 48000, channels: int = 1,
                 bitrate: int = 32000, fec: bool = True, dtx: bool = False,
                 complexity: Optional[int] = None):
        """complexity: 0-10 explicit, or None for the reference's
        CPU-count-scaled default (_default_opus_complexity).  NOTE
        complexity 0 — the 1-core default — makes libopus skip LBRR
        generation, so in-band FEC is ineffective there (same trade the
        reference makes on single-core devices, msopus.c:130-136)."""
        if _opus is None:
            raise RuntimeError("libopus not available")
        err = ctypes.c_int()
        self.st = _opus.opus_encoder_create(rate, channels,
                                            OPUS_APPLICATION_VOIP,
                                            ctypes.byref(err))
        if err.value != 0:
            raise RuntimeError(f"opus_encoder_create: {err.value}")
        self.rate, self.channels = rate, channels
        self.set_bitrate(bitrate)
        cx = (_default_opus_complexity() if complexity is None
              else max(0, min(10, complexity)))
        if cx >= 0:
            self._ctl(OPUS_SET_COMPLEXITY_REQUEST, cx)
        self._ctl(OPUS_SET_INBAND_FEC_REQUEST, 1 if fec else 0)
        # NOTE: libopus embeds FEC bits only when expected loss > 0; that
        # trades primary quality, so the loss expectation is driven by the
        # QoS loop (set_packet_loss from observed loss), not defaulted on
        self._ctl(OPUS_SET_DTX_REQUEST, 1 if dtx else 0)
        self._out = ctypes.create_string_buffer(4000)
        self._f32 = None             # lazily sized conversion buffers
        self._s16 = None

    def _ctl(self, req: int, val: int):
        _opus.opus_encoder_ctl(ctypes.c_void_p(self.st), req, ctypes.c_int(val))

    def set_bitrate(self, bps: int):
        self.bitrate = bps
        self._ctl(OPUS_SET_BITRATE_REQUEST, bps)

    def set_packet_loss(self, percent: int):
        self._ctl(OPUS_SET_PACKET_LOSS_PERC_REQUEST, percent)

    def encode(self, pcm: np.ndarray) -> bytes:
        """pcm float32 [-1,1], length = frame samples * channels."""
        # hot path (per leg per tick in the conference fleet): reuse
        # conversion + output buffers instead of allocating four arrays
        # per call — measured ~0.4 ms/tick for 8 legs of pure overhead
        n_s = len(pcm)
        if self._f32 is None or len(self._f32) != n_s:
            self._f32 = np.empty(n_s, np.float32)
            self._s16 = np.empty(n_s, np.int16)
        np.multiply(pcm, 32768.0, out=self._f32)
        np.rint(self._f32, out=self._f32)
        np.clip(self._f32, -32768, 32767, out=self._f32)
        np.copyto(self._s16, self._f32, casting="unsafe")
        n = _opus.opus_encode(ctypes.c_void_p(self.st),
                              self._s16.ctypes.data_as(ctypes.c_void_p),
                              n_s // self.channels, self._out, 4000)
        if n < 0:
            raise RuntimeError(f"opus_encode: {n}")
        return self._out.raw[:n]


class OpusDecoder:
    def __init__(self, rate: int = 48000, channels: int = 1):
        if _opus is None:
            raise RuntimeError("libopus not available")
        err = ctypes.c_int()
        self.st = _opus.opus_decoder_create(rate, channels, ctypes.byref(err))
        if err.value != 0:
            raise RuntimeError(f"opus_decoder_create: {err.value}")
        self.rate, self.channels = rate, channels
        self._i16 = None             # lazily sized decode buffer

    def decode(self, payload: Optional[bytes], frame_samples: int,
               fec: bool = False) -> np.ndarray:
        """payload None => PLC (opus native concealment).

        Returns a FRESH float32 array per call (callers buffer decoded
        audio across ticks); only the int16 staging buffer is reused."""
        n_buf = frame_samples * self.channels
        if self._i16 is None or len(self._i16) != n_buf:
            self._i16 = np.empty(n_buf, np.int16)
        buf = self._i16
        if payload is None:
            n = _opus.opus_decode(ctypes.c_void_p(self.st), None, 0,
                                  buf.ctypes.data_as(ctypes.c_void_p),
                                  frame_samples, 0)
        else:
            n = _opus.opus_decode(ctypes.c_void_p(self.st), payload,
                                  len(payload),
                                  buf.ctypes.data_as(ctypes.c_void_p),
                                  frame_samples, 1 if fec else 0)
        if n < 0:
            raise RuntimeError(f"opus_decode: {n}")
        out = np.empty(n * self.channels, np.float32)
        np.divide(buf[: n * self.channels], 32768.0, out=out)
        return out


# ---------------------------------------------------------------- speex
_speex = None
try:
    _p = ctypes.util.find_library("speex")
    if _p:
        _speex = ctypes.CDLL(_p)
        _speex.speex_lib_get_mode.restype = ctypes.c_void_p
        _speex.speex_encoder_init.restype = ctypes.c_void_p
        _speex.speex_decoder_init.restype = ctypes.c_void_p
except OSError:                                    # pragma: no cover
    _speex = None

SPEEX_MODEID_NB, SPEEX_MODEID_WB, SPEEX_MODEID_UWB = 0, 1, 2
SPEEX_SET_QUALITY = 4
SPEEX_GET_FRAME_SIZE = 3


class _SpeexBits(ctypes.Structure):
    # public, ABI-stable layout from <speex/speex_bits.h>
    _fields_ = [("chars", ctypes.c_char_p), ("nbBits", ctypes.c_int),
                ("charPtr", ctypes.c_int), ("bitPtr", ctypes.c_int),
                ("owner", ctypes.c_int), ("overflow", ctypes.c_int),
                ("buf_size", ctypes.c_int), ("reserved1", ctypes.c_int),
                ("reserved2", ctypes.c_void_p)]


def speex_available() -> bool:
    return _speex is not None


class SpeexCodec:
    """Speex NB/WB (cf. MSSpeexEnc/Dec, src/audiofilters/msspeex.c).

    20 ms frames (160 samples NB @8k, 320 WB @16k)."""

    def __init__(self, rate: int = 8000, quality: int = 7):
        if _speex is None:
            raise RuntimeError("libspeex not available")
        mode_id = {8000: SPEEX_MODEID_NB, 16000: SPEEX_MODEID_WB,
                   32000: SPEEX_MODEID_UWB}[rate]
        mode = _speex.speex_lib_get_mode(mode_id)
        self.enc = _speex.speex_encoder_init(ctypes.c_void_p(mode))
        self.dec = _speex.speex_decoder_init(ctypes.c_void_p(mode))
        q = ctypes.c_int(quality)
        _speex.speex_encoder_ctl(ctypes.c_void_p(self.enc), SPEEX_SET_QUALITY,
                                 ctypes.byref(q))
        fs = ctypes.c_int()
        _speex.speex_encoder_ctl(ctypes.c_void_p(self.enc),
                                 SPEEX_GET_FRAME_SIZE, ctypes.byref(fs))
        self.frame_samples = fs.value
        self.bits = _SpeexBits()
        _speex.speex_bits_init(ctypes.byref(self.bits))

    def encode(self, pcm: np.ndarray) -> bytes:
        """One or more 20 ms frames packed into ONE speex bits stream —
        RFC 5574 §3's multiple-frames-per-packet (msspeex.c ptime loop)."""
        s16 = np.clip(np.round(pcm * 32768.0), -32768, 32767).astype(np.int16)
        assert len(s16) % self.frame_samples == 0
        _speex.speex_bits_reset(ctypes.byref(self.bits))
        for k in range(0, len(s16), self.frame_samples):
            frame = np.ascontiguousarray(s16[k:k + self.frame_samples])
            _speex.speex_encode_int(ctypes.c_void_p(self.enc),
                                    frame.ctypes.data_as(ctypes.c_void_p),
                                    ctypes.byref(self.bits))
        n = _speex.speex_bits_nbytes(ctypes.byref(self.bits))
        out = ctypes.create_string_buffer(n + 8)
        n = _speex.speex_bits_write(ctypes.byref(self.bits), out, len(out))
        return out.raw[:n]

    def decode(self, payload: Optional[bytes]) -> np.ndarray:
        """Decode every frame in the payload's bits stream (or PLC one
        frame for None)."""
        if payload is None:                          # PLC
            buf = np.zeros(self.frame_samples, np.int16)
            _speex.speex_decode_int(ctypes.c_void_p(self.dec), None,
                                    buf.ctypes.data_as(ctypes.c_void_p))
            return buf.astype(np.float32) / 32768.0
        _speex.speex_bits_read_from(ctypes.byref(self.bits), payload,
                                    len(payload))
        chunks = []
        while True:
            buf = np.zeros(self.frame_samples, np.int16)
            r = _speex.speex_decode_int(ctypes.c_void_p(self.dec),
                                        ctypes.byref(self.bits),
                                        buf.ctypes.data_as(ctypes.c_void_p))
            if r != 0:                               # -1 end / -2 corrupt
                break
            chunks.append(buf.astype(np.float32) / 32768.0)
            # stop when fewer bits than the smallest frame remain
            if _speex.speex_bits_remaining(ctypes.byref(self.bits)) < 43:
                break
        return np.concatenate(chunks) if chunks else \
            np.zeros(0, np.float32)


# ---------------------------------------------------------------- gsm
_gsm = None
try:
    _p = ctypes.util.find_library("gsm")
    if _p:
        _gsm = ctypes.CDLL(_p)
        _gsm.gsm_create.restype = ctypes.c_void_p
except OSError:                                    # pragma: no cover
    _gsm = None

GSM_FRAME_SAMPLES = 160      # 20 ms @ 8k
GSM_FRAME_BYTES = 33


def gsm_available() -> bool:
    return _gsm is not None


class GsmCodec:
    """GSM 06.10 full-rate, 20 ms frames (cf. MSGsmEnc/Dec)."""

    def __init__(self):
        if _gsm is None:
            raise RuntimeError("libgsm not available")
        self.enc_st = _gsm.gsm_create()
        self.dec_st = _gsm.gsm_create()

    def encode(self, pcm: np.ndarray) -> bytes:
        """One or more 160-sample frames -> concatenated 33-byte frames
        (ptime aggregation packs several, gsm.c frames-until-ptime)."""
        s16 = np.clip(np.round(pcm * 32768.0), -32768, 32767).astype(np.int16)
        assert len(s16) % GSM_FRAME_SAMPLES == 0
        out = b""
        for k in range(0, len(s16), GSM_FRAME_SAMPLES):
            frame = np.ascontiguousarray(s16[k:k + GSM_FRAME_SAMPLES])
            buf = ctypes.create_string_buffer(GSM_FRAME_BYTES)
            _gsm.gsm_encode(ctypes.c_void_p(self.enc_st),
                            frame.ctypes.data_as(ctypes.c_void_p), buf)
            out += buf.raw
        return out

    def decode(self, payload: bytes) -> np.ndarray:
        chunks = []
        for k in range(0, len(payload) - GSM_FRAME_BYTES + 1,
                       GSM_FRAME_BYTES):
            buf = np.zeros(GSM_FRAME_SAMPLES, np.int16)
            r = _gsm.gsm_decode(ctypes.c_void_p(self.dec_st),
                                payload[k:k + GSM_FRAME_BYTES],
                                buf.ctypes.data_as(ctypes.c_void_p))
            if r != 0:
                raise RuntimeError("gsm_decode failed")
            chunks.append(buf.astype(np.float32) / 32768.0)
        return np.concatenate(chunks) if chunks else \
            np.zeros(0, np.float32)


# ---------------------------------------------------------------- g729
# bcg729 (Belledonne's own G.729 Annex A/B implementation) — the exact
# library the reference wraps in src/audiofilters/g729.c:112-293.  Like a
# reference build without ENABLE_G729, the codec is simply unavailable
# when the shared library is absent from the system.
_bcg729 = None
try:
    _p = ctypes.util.find_library("bcg729")
    if _p:
        _bcg729 = ctypes.CDLL(_p)
        _bcg729.initBcg729EncoderChannel.restype = ctypes.c_void_p
        _bcg729.initBcg729DecoderChannel.restype = ctypes.c_void_p
except OSError:                                    # pragma: no cover
    _bcg729 = None

G729_FRAME_SAMPLES = 80      # 10 ms @ 8k (SIGNAL_FRAME_SIZE/2, g729.c)
G729_FRAME_BYTES = 10        # BITSTREAM_FRAME_SIZE
G729_SID_BYTES = 2           # NOISE_BITSTREAM_FRAME_SIZE


def g729_available() -> bool:
    return _bcg729 is not None


class G729Codec:
    """G.729A/B via bcg729, 20 ms packets of two 10 ms frames
    (cf. MSBCG729Enc/Dec, g729.c:186-195: frames appended until ptime;
    a 2-byte frame is an annex-B SID and always ends the payload,
    RFC 3551 §4.5.6)."""

    def __init__(self, enable_vad: bool = False):
        if _bcg729 is None:
            raise RuntimeError("libbcg729 not available")
        self.enc_st = _bcg729.initBcg729EncoderChannel(
            ctypes.c_uint8(1 if enable_vad else 0))
        self.dec_st = _bcg729.initBcg729DecoderChannel()

    def encode(self, pcm: np.ndarray) -> bytes:
        s16 = np.clip(np.round(pcm * 32768.0), -32768, 32767).astype(np.int16)
        assert len(s16) % G729_FRAME_SAMPLES == 0
        out = b""
        for i in range(0, len(s16), G729_FRAME_SAMPLES):
            frame = np.ascontiguousarray(s16[i:i + G729_FRAME_SAMPLES])
            buf = ctypes.create_string_buffer(G729_FRAME_BYTES)
            blen = ctypes.c_uint8(0)
            _bcg729.bcg729Encoder(ctypes.c_void_p(self.enc_st),
                                  frame.ctypes.data_as(ctypes.c_void_p),
                                  buf, ctypes.byref(blen))
            out += buf.raw[:blen.value]
            if blen.value == G729_SID_BYTES:   # SID ends the payload
                break
        return out

    def decode(self, payload, frame_samples: int = 160) -> np.ndarray:
        """Decode one RTP payload (or None -> PLC) to `frame_samples` PCM."""
        chunks = []
        if payload:
            pos = 0
            while pos < len(payload):
                rest = len(payload) - pos
                sid = 1 if rest == G729_SID_BYTES else 0
                n = G729_SID_BYTES if sid else min(G729_FRAME_BYTES, rest)
                buf = np.zeros(G729_FRAME_SAMPLES, np.int16)
                _bcg729.bcg729Decoder(
                    ctypes.c_void_p(self.dec_st), payload[pos:pos + n],
                    ctypes.c_uint8(n), ctypes.c_uint8(0),
                    ctypes.c_uint8(sid), ctypes.c_uint8(0),
                    buf.ctypes.data_as(ctypes.c_void_p))
                chunks.append(buf.astype(np.float32) / 32768.0)
                pos += n
        # concealment / CN fill up to the requested duration (g729.c:74)
        while sum(len(c) for c in chunks) < frame_samples:
            buf = np.zeros(G729_FRAME_SAMPLES, np.int16)
            _bcg729.bcg729Decoder(ctypes.c_void_p(self.dec_st), None,
                                  ctypes.c_uint8(0), ctypes.c_uint8(1),
                                  ctypes.c_uint8(0), ctypes.c_uint8(0),
                                  buf.ctypes.data_as(ctypes.c_void_p))
            chunks.append(buf.astype(np.float32) / 32768.0)
        return np.concatenate(chunks)[:frame_samples]


# ---------------------------------------------------------------- bv16
# BroadVoice16 (libbv16 / bv16-floatingpoint) — the library the reference
# wraps in src/audiofilters/bv16.c:192-336.  5 ms frames: 40 samples @8k
# in, 10 bytes out (FRSZ/BITSTREAM_FRAME_SIZE, bv16.c:50-52).  Like a
# reference build without ENABLE_BV16, the codec is unavailable when the
# shared library is absent (it is not packaged in this distro at all).
_bv16 = None
try:
    _p = ctypes.util.find_library("bv16") or \
        ctypes.util.find_library("bv16-floatingpoint")
    if _p:
        _bv16 = ctypes.CDLL(_p)
except OSError:                                    # pragma: no cover
    _bv16 = None

BV16_FRAME_SAMPLES = 40       # 5 ms @ 8k (FRSZ)
BV16_FRAME_BYTES = 10         # 80-bit bitstream frame
# BV16_{Encoder,Decoder}_State / BV16_Bit_Stream are caller-allocated
# structs; without the headers we over-allocate opaque storage (the float
# build's states are <2 KB) — Reset_* initializes every field within.
_BV16_STATE_BYTES = 16384


def bv16_available() -> bool:
    return _bv16 is not None and _bv16_selfcheck()


_bv16_ok = None


def _bv16_selfcheck() -> bool:
    """Roundtrip sanity before trusting the dlopen'd ABI (same discipline
    as h264_available: never expose a codec that didn't prove itself)."""
    global _bv16_ok
    if _bv16_ok is not None:
        return _bv16_ok
    _bv16_ok = False
    try:
        c = Bv16Codec()
        t = np.arange(320) / 8000.0
        x = (0.4 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
        y = c.decode(c.encode(x))
        _bv16_ok = bool(y.shape == x.shape and
                        0.01 < float(np.sqrt(np.mean(y ** 2))) < 1.0)
    except Exception:
        _bv16_ok = False
    return _bv16_ok


class Bv16Codec:
    """BV16 via libbv16 (cf. MSBv16Enc/Dec, bv16.c:148-180,258-290):
    ptime/5 frames per packet, BitPack/BitUnPack 10-byte frames, PLC on
    erased frames."""

    def __init__(self):
        if _bv16 is None:
            raise RuntimeError("libbv16 not available")
        self.enc_st = ctypes.create_string_buffer(_BV16_STATE_BYTES)
        self.dec_st = ctypes.create_string_buffer(_BV16_STATE_BYTES)
        self._bs = ctypes.create_string_buffer(_BV16_STATE_BYTES)
        _bv16.Reset_BV16_Encoder(self.enc_st)
        _bv16.Reset_BV16_Decoder(self.dec_st)

    def encode(self, pcm: np.ndarray) -> bytes:
        s16 = np.clip(np.round(np.asarray(pcm) * 32768.0),
                      -32768, 32767).astype(np.int16)
        assert len(s16) % BV16_FRAME_SAMPLES == 0
        out = b""
        for i in range(0, len(s16), BV16_FRAME_SAMPLES):
            frame = np.ascontiguousarray(s16[i:i + BV16_FRAME_SAMPLES])
            _bv16.BV16_Encode(self._bs, self.enc_st,
                              frame.ctypes.data_as(ctypes.c_void_p))
            buf = ctypes.create_string_buffer(BV16_FRAME_BYTES)
            _bv16.BV16_BitPack(buf, self._bs)
            out += buf.raw[:BV16_FRAME_BYTES]
        return out

    def decode(self, payload, frame_samples: int = 80) -> np.ndarray:
        """RTP payload (or None -> PLC, bv16.c:284) to >= frame_samples."""
        chunks = []
        if payload:
            for pos in range(0, len(payload) - BV16_FRAME_BYTES + 1,
                             BV16_FRAME_BYTES):
                _bv16.BV16_BitUnPack(payload[pos:pos + BV16_FRAME_BYTES],
                                     self._bs)
                buf = np.zeros(BV16_FRAME_SAMPLES, np.int16)
                _bv16.BV16_Decode(self._bs, self.dec_st,
                                  buf.ctypes.data_as(ctypes.c_void_p))
                chunks.append(buf.astype(np.float32) / 32768.0)
        while sum(len(c) for c in chunks) < frame_samples:
            buf = np.zeros(BV16_FRAME_SAMPLES, np.int16)
            _bv16.BV16_PLC(self.dec_st,
                           buf.ctypes.data_as(ctypes.c_void_p))
            chunks.append(buf.astype(np.float32) / 32768.0)
        return np.concatenate(chunks)[:frame_samples]
