"""H.264 host codec via libavcodec/libx264 (ctypes) — the interop codec.

Reference: src/videofilters/h26x/h26x-encoder-filter.cpp /
h26x-decoder-filter.cpp (codec-agnostic filter templates over platform
backends) and the legacy ffmpeg decoder h264dec.cpp:474.  Like the
reference's MediaCodec/VideoToolbox backends, the codec itself is a host
component; frames cross the RTP boundary as Annex-B NAL streams that
net/h26x.py packetizes (RFC 6184).

ABI strategy (no ffmpeg dev headers in this image): well-known AVOptions
("b" = bit_rate int64, "g" = gop_size int) are set to sentinel values and
located by scanning the struct, anchoring the stable AVCodecContext field
run  ``bit_rate .. time_base, ticks_per_frame, delay, width, height,
coded_w/h, gop_size, pix_fmt`` — gop_size found at the predicted distance
from time_base CONFIRMS the layout before width/height are trusted.
AVPacket/AVFrame use their long-stable layouts, and ``h264_available()``
only returns True after an **import-time encode→decode self-check** passes
(re-verify anchors instead of trusting pinned offsets).
"""
from __future__ import annotations

import ctypes
import ctypes.util
from typing import List, Optional, Tuple

import numpy as np

_av = None
_avu = None
try:
    _p1 = ctypes.util.find_library("avcodec")
    _p2 = ctypes.util.find_library("avutil")
    if _p1 and _p2:
        _avu = ctypes.CDLL(_p2, mode=ctypes.RTLD_GLOBAL)
        _av = ctypes.CDLL(_p1)
        for f in ("avcodec_find_encoder_by_name",
                  "avcodec_find_decoder_by_name",
                  "avcodec_alloc_context3"):
            getattr(_av, f).restype = ctypes.c_void_p
        _av.avcodec_find_encoder_by_name.argtypes = [ctypes.c_char_p]
        _av.avcodec_find_decoder_by_name.argtypes = [ctypes.c_char_p]
        _av.avcodec_alloc_context3.argtypes = [ctypes.c_void_p]
        _av.av_packet_alloc.restype = ctypes.c_void_p
        _avu.av_frame_alloc.restype = ctypes.c_void_p
        _avu.av_opt_set.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_char_p, ctypes.c_int]
        _avu.av_opt_set_int.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.c_int64, ctypes.c_int]
except OSError:                                    # pragma: no cover
    _av = None

AV_OPT_SEARCH_CHILDREN = 1
AV_PIX_FMT_YUV420P = 0
AVERROR_EAGAIN = -11

# AVPacket (libavcodec 57..60): stable layout
_PKT_PTS, _PKT_DTS, _PKT_DATA, _PKT_SIZE, _PKT_FLAGS = 8, 16, 24, 32, 40
# AVFrame (libavutil 56..58): stable head
_FR_DATA0 = 0                  # uint8_t* data[8]
_FR_LINESIZE0 = 64             # int linesize[8]
_FR_WIDTH, _FR_HEIGHT = 104, 108
_FR_FORMAT = 116


def _scan_i64(buf_addr: int, length: int, value: int) -> Optional[int]:
    raw = ctypes.string_at(buf_addr, length)
    needle = value.to_bytes(8, "little")
    i = raw.find(needle)
    return i if i >= 0 else None


def _scan_i32(buf_addr: int, length: int, value: int) -> Optional[int]:
    raw = ctypes.string_at(buf_addr, length)
    needle = (value & 0xFFFFFFFF).to_bytes(4, "little")
    i = raw.find(needle)
    return i if i >= 0 else None


_CTX_OFF = None                # (bit_rate, width, height, gop, pix_fmt)


def _probe_ctx_offsets() -> Optional[Tuple[int, int, int, int, int]]:
    """Locate AVCodecContext field offsets via AVOption sentinels."""
    global _CTX_OFF
    if _CTX_OFF is not None:
        return _CTX_OFF
    codec = _av.avcodec_find_decoder_by_name(b"h264")
    if not codec:
        return None
    ctx = _av.avcodec_alloc_context3(ctypes.c_void_p(codec))
    if not ctx:
        return None
    SCAN = 4096
    _avu.av_opt_set_int(ctypes.c_void_p(ctx), b"b", 0x1DCB9A754321, 0)
    off_b = _scan_i64(ctx, SCAN, 0x1DCB9A754321)
    _avu.av_opt_set_int(ctypes.c_void_p(ctx), b"g", 0x5AD0F00D, 0)
    off_g = _scan_i32(ctx, SCAN, 0x5AD0F00D)
    # time_base is an AVRational AVOption: set num/den sentinels
    _avu.av_opt_set(ctypes.c_void_p(ctx), b"time_base", b"7919/104729", 0)
    off_tb = None
    raw = ctypes.string_at(ctx, SCAN)
    needle = (7919).to_bytes(4, "little") + (104729).to_bytes(4, "little")
    i = raw.find(needle)
    if i >= 0:
        off_tb = i
    if off_b is None or off_g is None or off_tb is None:
        return None
    # layout anchor: time_base(8) + ticks_per_frame(4) + delay(4) + width(4)
    # + height(4) + coded_w(4) + coded_h(4) -> gop_size
    if off_g != off_tb + 32:
        return None                    # layout drifted: refuse, don't guess
    off_w = off_tb + 16
    off_h = off_tb + 20
    off_pix = off_g + 4
    _CTX_OFF = (off_b, off_w, off_h, off_g, off_pix)
    return _CTX_OFF


def _w32(addr: int, off: int, value: int):
    ctypes.cast(addr + off, ctypes.POINTER(ctypes.c_int32))[0] = value


def _r32(addr: int, off: int) -> int:
    return ctypes.cast(addr + off, ctypes.POINTER(ctypes.c_int32))[0]


def _r64(addr: int, off: int) -> int:
    return ctypes.cast(addr + off, ctypes.POINTER(ctypes.c_int64))[0]


def _rptr(addr: int, off: int) -> int:
    return ctypes.cast(addr + off, ctypes.POINTER(ctypes.c_void_p))[0] or 0


class H264Encoder:
    """libx264 via avcodec: YUV420 frames -> Annex-B access units
    (zerolatency, repeating SPS/PPS on every IDR for mid-stream join).

    Also the base for the legacy ffmpeg codec family the reference builds
    from videoenc.c/videodec.c (H.263/H.263+/MPEG4/MJPEG) — subclasses
    pass a different codec name and skip the x264 options."""

    CODEC_NAME = b"libx264"

    def __init__(self, width: int, height: int, bitrate_bps: int = 500_000,
                 fps: int = 25, gop: int = 100):
        off = _probe_ctx_offsets()
        if _av is None or off is None:
            raise RuntimeError("libavcodec/libx264 unavailable")
        codec = _av.avcodec_find_encoder_by_name(self.CODEC_NAME)
        if not codec:
            raise RuntimeError(f"{self.CODEC_NAME} encoder missing")
        self.w, self.h = width, height
        ctx = _av.avcodec_alloc_context3(ctypes.c_void_p(codec))
        _, off_w, off_h, off_g, off_pix = off
        _avu.av_opt_set_int(ctypes.c_void_p(ctx), b"b", bitrate_bps, 0)
        _avu.av_opt_set(ctypes.c_void_p(ctx), b"time_base",
                        f"1/{fps}".encode(), 0)
        _w32(ctx, off_w, width)
        _w32(ctx, off_h, height)
        _w32(ctx, off_g, gop)
        if self.CODEC_NAME == b"mjpeg":
            # MJPEG wants full-range YUVJ420P (or strict=unofficial)
            _w32(ctx, off_pix, 12)          # AV_PIX_FMT_YUVJ420P
            _avu.av_opt_set(ctypes.c_void_p(ctx), b"strict", b"-2", 0)
            # RFC 2435 receivers rebuild frames with the STANDARD Huffman
            # tables; ffmpeg's optimal-tables default would corrupt the
            # reconstructed entropy stream
            _avu.av_opt_set(ctypes.c_void_p(ctx), b"huffman", b"default",
                            AV_OPT_SEARCH_CHILDREN)
        else:
            _w32(ctx, off_pix, AV_PIX_FMT_YUV420P)
        if self.CODEC_NAME == b"libx264":
            _avu.av_opt_set(ctypes.c_void_p(ctx), b"preset", b"ultrafast",
                            AV_OPT_SEARCH_CHILDREN)
            _avu.av_opt_set(ctypes.c_void_p(ctx), b"tune", b"zerolatency",
                            AV_OPT_SEARCH_CHILDREN)
            # in-band parameter sets on every keyframe (mid-stream join)
            _avu.av_opt_set(ctypes.c_void_p(ctx), b"x264-params",
                            b"repeat-headers=1:annexb=1",
                            AV_OPT_SEARCH_CHILDREN)
        if self.CODEC_NAME == b"libx265":
            _avu.av_opt_set(ctypes.c_void_p(ctx), b"preset", b"ultrafast",
                            AV_OPT_SEARCH_CHILDREN)
            _avu.av_opt_set(ctypes.c_void_p(ctx), b"tune", b"zerolatency",
                            AV_OPT_SEARCH_CHILDREN)
            # in-band VPS/SPS/PPS on every IRAP + quiet the x265 banner
            _avu.av_opt_set(ctypes.c_void_p(ctx), b"x265-params",
                            b"repeat-headers=1:annexb=1:log-level=none",
                            AV_OPT_SEARCH_CHILDREN)
        if self.CODEC_NAME == b"h263":
            # H.263 baseline allows only specific sizes; callers use CIF/QCIF
            pass
        if self.CODEC_NAME == b"libtheora":
            # Theora's stream headers (info/comment/setup) land in ctx
            # extradata with global_header; receivers need them before
            # decoding (delivered in-band on keyframes, RFC 5215 style)
            _avu.av_opt_set(ctypes.c_void_p(ctx), b"flags",
                            b"+global_header", 0)
        if _av.avcodec_open2(ctypes.c_void_p(ctx), ctypes.c_void_p(codec),
                             None) != 0:
            raise RuntimeError(f"avcodec_open2({self.CODEC_NAME}) failed")
        self.ctx = ctx
        self.frame = _avu.av_frame_alloc()
        _w32(self.frame, _FR_WIDTH, width)
        _w32(self.frame, _FR_HEIGHT, height)
        _w32(self.frame, _FR_FORMAT, AV_PIX_FMT_YUV420P)
        if _avu.av_frame_get_buffer(ctypes.c_void_p(self.frame), 32) != 0:
            raise RuntimeError("av_frame_get_buffer failed")
        # self-check the AVFrame layout: plausible plane geometry
        if _r32(self.frame, _FR_LINESIZE0) < width or \
                not _rptr(self.frame, _FR_DATA0):
            raise RuntimeError("AVFrame layout check failed")
        self.pkt = _av.av_packet_alloc()
        self._pts = 0

    def encode(self, yuv420: bytes, keyframe: bool = False) -> bytes:
        """One I420 frame (w*h*3/2 bytes) -> Annex-B bytes (may be empty)."""
        w, h = self.w, self.h
        assert len(yuv420) == w * h * 3 // 2
        _avu.av_frame_make_writable(ctypes.c_void_p(self.frame))
        src = np.frombuffer(yuv420, np.uint8)
        planes = [(0, src[:w * h], w, h),
                  (1, src[w * h: w * h + w * h // 4], w // 2, h // 2),
                  (2, src[w * h + w * h // 4:], w // 2, h // 2)]
        for i, plane, pw, ph in planes:
            dst = _rptr(self.frame, _FR_DATA0 + 8 * i)
            stride = _r32(self.frame, _FR_LINESIZE0 + 4 * i)
            pbytes = plane.tobytes()
            for row in range(ph):
                ctypes.memmove(dst + row * stride,
                               pbytes[row * pw:(row + 1) * pw], pw)
        # pts (AVFrame offset 136 in avutil 57: after sar rational)
        ctypes.cast(self.frame + 136,
                    ctypes.POINTER(ctypes.c_int64))[0] = self._pts
        self._pts += 1
        # pict_type: 1=I forces a keyframe (AVFrame offset 124)
        _w32(self.frame, 124, 1 if keyframe else 0)
        out = b""
        if _av.avcodec_send_frame(ctypes.c_void_p(self.ctx),
                                  ctypes.c_void_p(self.frame)) != 0:
            return out
        while True:
            r = _av.avcodec_receive_packet(ctypes.c_void_p(self.ctx),
                                           ctypes.c_void_p(self.pkt))
            if r != 0:
                break
            data = _rptr(self.pkt, _PKT_DATA)
            size = _r32(self.pkt, _PKT_SIZE)
            out += ctypes.string_at(data, size)
            _av.av_packet_unref(ctypes.c_void_p(self.pkt))
        return out


def _extradata_offsets(off) -> Tuple[int, int]:
    """(ptr_off, size_off) of AVCodecContext extradata/extradata_size.

    lavc 57-60 keep [uint8_t *extradata; int extradata_size;
    AVRational time_base] adjacent; the probe locates time_base (off_w =
    time_base + 16), so extradata sits 12 bytes before it.  Every use
    self-checks the content, so a layout drift degrades to 'unavailable',
    never to a wild pointer."""
    off_tb = off[1] - 16
    return off_tb - 12, off_tb - 4


def encoder_extradata(enc) -> bytes:
    """Read the opened encoder's global headers (b'' if none/implausible)."""
    p_off, s_off = _extradata_offsets(_probe_ctx_offsets())
    ptr = _rptr(enc.ctx, p_off)
    size = _r32(enc.ctx, s_off)
    if not ptr or not (0 < size <= 1 << 16):
        return b""
    return ctypes.string_at(ptr, size)


class H264Decoder:
    """avcodec h264: Annex-B access units -> I420 frames."""

    CODEC_NAME = b"h264"

    def __init__(self, extradata: bytes = b"", dims: Tuple[int, int] = None):
        """dims: preset coded (width, height) before open — required for
        codecs whose bitstream carries no dimensions (Snow, an
        ffmpeg-internal experimental codec: the reference negotiates the
        size out-of-band via SDP, videodec.c picking it from the payload
        fmtp; videoenc.c:916-1032)."""
        off = _probe_ctx_offsets()
        if _av is None or off is None:
            raise RuntimeError("libavcodec unavailable")
        codec = _av.avcodec_find_decoder_by_name(self.CODEC_NAME)
        ctx = _av.avcodec_alloc_context3(ctypes.c_void_p(codec))
        if dims is not None:
            _, off_w, off_h, _, _ = off
            _w32(ctx, off_w, dims[0])
            _w32(ctx, off_h, dims[1])
        if extradata:
            # out-of-band codec config (Theora headers etc.): install an
            # av_malloc'd copy before open2 at the probed offsets.
            # Layout gate: a freshly-allocated context has extradata=NULL /
            # extradata_size=0, so the probed slots must read as zero BEFORE
            # the write and read back exactly what was written AFTER — a
            # lavc layout drift degrades to "unavailable" instead of
            # corrupting adjacent AVCodecContext fields before open2.
            p_off, s_off = _extradata_offsets(off)
            if _rptr(ctx, p_off) or _r32(ctx, s_off) != 0:
                _av.avcodec_free_context(
                    ctypes.byref(ctypes.c_void_p(ctx)))
                raise RuntimeError(
                    "extradata offsets implausible (lavc layout drift); "
                    "out-of-band codec config unavailable")
            _avu.av_malloc.restype = ctypes.c_void_p
            buf = _avu.av_malloc(len(extradata) + 64)
            ctypes.memmove(buf, extradata, len(extradata))
            ctypes.memset(buf + len(extradata), 0, 64)
            ctypes.cast(ctx + p_off,
                        ctypes.POINTER(ctypes.c_void_p))[0] = buf
            _w32(ctx, s_off, len(extradata))
            if _rptr(ctx, p_off) != buf or _r32(ctx, s_off) != len(extradata):
                # un-install before freeing so the context never owns buf
                # (avoids double-free) and nothing leaks on the raise
                ctypes.cast(ctx + p_off,
                            ctypes.POINTER(ctypes.c_void_p))[0] = None
                _w32(ctx, s_off, 0)
                _avu.av_free(ctypes.c_void_p(buf))
                _av.avcodec_free_context(
                    ctypes.byref(ctypes.c_void_p(ctx)))
                raise RuntimeError("extradata install readback mismatch")
        if _av.avcodec_open2(ctypes.c_void_p(ctx), ctypes.c_void_p(codec),
                             None) != 0:
            # frees any installed extradata along with the context
            _av.avcodec_free_context(ctypes.byref(ctypes.c_void_p(ctx)))
            raise RuntimeError(
                f"avcodec_open2({self.CODEC_NAME.decode()}) failed")
        self.ctx = ctx
        self.frame = _avu.av_frame_alloc()
        self.pkt = _av.av_packet_alloc()
        self.width = 0
        self.height = 0

    def decode(self, annexb: bytes) -> List[bytes]:
        """Feed one access unit; returns zero or more I420 frames."""
        if not annexb:
            return []
        if _av.av_new_packet(ctypes.c_void_p(self.pkt), len(annexb)) != 0:
            return []
        ctypes.memmove(_rptr(self.pkt, _PKT_DATA), annexb, len(annexb))
        frames = []
        if _av.avcodec_send_packet(ctypes.c_void_p(self.ctx),
                                   ctypes.c_void_p(self.pkt)) == 0:
            while True:
                r = _av.avcodec_receive_frame(ctypes.c_void_p(self.ctx),
                                              ctypes.c_void_p(self.frame))
                if r != 0:
                    break
                w = _r32(self.frame, _FR_WIDTH)
                h = _r32(self.frame, _FR_HEIGHT)
                self.width, self.height = w, h
                out = bytearray()
                for i, (pw, ph) in enumerate(((w, h), (w // 2, h // 2),
                                              (w // 2, h // 2))):
                    src = _rptr(self.frame, _FR_DATA0 + 8 * i)
                    stride = _r32(self.frame, _FR_LINESIZE0 + 4 * i)
                    for row in range(ph):
                        out += ctypes.string_at(src + row * stride, pw)
                frames.append(bytes(out))
        _av.av_packet_unref(ctypes.c_void_p(self.pkt))
        return frames


_checked: Optional[bool] = None


def h264_available() -> bool:
    """True only if a real encode->decode roundtrip works on this build."""
    global _checked
    if _checked is not None:
        return _checked
    _checked = False
    if _av is None or _probe_ctx_offsets() is None:
        return False
    try:
        w, h = 64, 64
        enc = H264Encoder(w, h, fps=10, gop=5)
        dec = H264Decoder()
        y = np.tile(np.arange(w, dtype=np.uint8), (h, 1))
        frame = y.tobytes() + bytes([128] * (w * h // 4)) * 2
        got = []
        for k in range(8):
            au = enc.encode(frame, keyframe=(k == 0))
            got.extend(dec.decode(au))
        if not got or len(got[0]) != w * h * 3 // 2:
            return False
        ref = np.frombuffer(frame, np.uint8).astype(np.float32)
        out = np.frombuffer(got[-1], np.uint8).astype(np.float32)
        psnr = 10 * np.log10(255.0 ** 2 / max(np.mean((ref - out) ** 2), 1e-9))
        _checked = bool(psnr > 30.0)
    except Exception:
        _checked = False
    return _checked


# --- legacy ffmpeg codec family (reference: videoenc.c:916-1032 /
# videodec.c — H.263(+), MPEG4, MJPEG via libavcodec) ------------------------
class H265Encoder(H264Encoder):
    """libx265 Annex-B (the HEVC half of the reference's h26x encoder
    framework, h26x-encoder-filter.cpp + videotoolbox/mediacodec h265)."""
    CODEC_NAME = b"libx265"


class H265Decoder(H264Decoder):
    CODEC_NAME = b"hevc"


_h265_ok = None


def h265_available() -> bool:
    """libx265+hevc present AND a tiny encode/decode roundtrip works
    (same self-check discipline as h264_available)."""
    global _h265_ok
    if _h265_ok is not None:
        return _h265_ok
    _h265_ok = False
    if _av is None or _probe_ctx_offsets() is None:
        return False
    if not (_av.avcodec_find_encoder_by_name(b"libx265") and
            _av.avcodec_find_decoder_by_name(b"hevc")):
        return False
    try:
        w, h = 64, 64
        enc = H265Encoder(w, h, 200_000, 25, gop=10)
        dec = H265Decoder()
        frame = np.full(w * h * 3 // 2, 128, np.uint8)
        frame[: w * h] = (np.arange(w * h) % 255).astype(np.uint8)
        got = []
        for i in range(6):
            au = enc.encode(frame.tobytes(), keyframe=(i == 0))
            if au:
                got += dec.decode(au)
        if got and len(got[-1]) == w * h * 3 // 2:
            ref = frame[: w * h].astype(np.float32)
            out = np.frombuffer(got[-1], np.uint8)[: w * h].astype(np.float32)
            mse = float(((ref - out) ** 2).mean())
            _h265_ok = mse < 200.0
    except Exception:
        _h265_ok = False
    return _h265_ok


# avcodec names differ from ours where the encoder is an external lib
# wrapper (libtheora) or a shared decoder (h263p decodes as h263)
_LEGACY_NAMES = {
    "h263p": (b"h263p", b"h263"),
    "theora": (b"libtheora", b"theora"),   # reference: videofilters/theora.c
}


def make_legacy_codec(name: str):
    """Returns (EncoderCls, DecoderCls) for 'h263' | 'h263p' | 'mpeg4' |
    'mjpeg' | 'theora'. Availability follows the same probed-offset layer
    as H.264.  Theora parity: src/videofilters/theora.c (MSTheoraEnc/Dec,
    554 LoC) — here via avcodec's libtheora wrapper."""
    ename, dname = _LEGACY_NAMES.get(name, (name.encode(), name.encode()))

    class _Enc(H264Encoder):
        CODEC_NAME = ename

    class _Dec(H264Decoder):
        CODEC_NAME = dname

    _Enc.__name__ = f"{name.upper()}Encoder"
    _Dec.__name__ = f"{name.upper()}Decoder"
    return _Enc, _Dec


def legacy_codec_available(name: str) -> bool:
    if _av is None or _probe_ctx_offsets() is None:
        return False
    ename, dname = _LEGACY_NAMES.get(name, (name.encode(), name.encode()))
    return bool(_av.avcodec_find_encoder_by_name(ename)) and \
        bool(_av.avcodec_find_decoder_by_name(dname))
