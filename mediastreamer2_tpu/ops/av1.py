"""AV1 host codec via libaom (ctypes, runtime-probed ABI).

Reference: src/videofilters/av1/* (2,291 LoC: aom encoder, dav1d decoder,
OBU packetization).  Same host-filter tier and probing approach as
ops/vp8.py; libaom v3.6 offsets anchored by config_default values
(realtime usage -> CBR; encoder ABI 25, decoder ABI 22 verified by init).
Realtime settings: usage=AOM_USAGE_REALTIME, cpu-used 9.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import struct
from typing import Optional, Tuple

import numpy as np

_aom = None
try:
    _p = ctypes.util.find_library("aom")
    if _p:
        _aom = ctypes.CDLL(_p)
        for f in ("aom_codec_av1_cx", "aom_codec_av1_dx", "aom_img_alloc",
                  "aom_codec_get_cx_data", "aom_codec_get_frame"):
            getattr(_aom, f).restype = ctypes.c_void_p
        _aom.aom_codec_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_ulong, ctypes.c_longlong]
except OSError:                                    # pragma: no cover
    _aom = None

# probed aom_codec_enc_cfg offsets (libaom v3.6, x86-64)
_CFG_W, _CFG_H = 12, 16
_CFG_TB_NUM, _CFG_TB_DEN = 40, 44
_CFG_TARGET_KBPS = 136
_CFG_KF_MAX = 192
# probed aom_image offsets
_IMG_DW, _IMG_DH = 40, 44
_IMG_PLANES = (64, 72, 80)
_IMG_STRIDES = (88, 92, 96)
# cx pkt (kind@0, buf@8, sz@16, flags@40 — keyframe bit 0)
_PKT_KIND, _PKT_BUF, _PKT_SZ, _PKT_FLAGS = 0, 8, 16, 40

AOM_IMG_FMT_I420 = 0x102
AOM_USAGE_REALTIME = 1
AOME_SET_CPUUSED = 13
AOM_EFLAG_FORCE_KF = 1
ENC_ABI, DEC_ABI = 25, 22


_verified = None


def av1_available() -> bool:
    """True only after a real encode->decode roundtrip on THIS libaom/
    dav1d build (offset drift disables the codec instead of corrupting
    configs)."""
    global _verified
    if _verified is not None:
        return _verified
    _verified = False
    if _aom is None:
        return False
    try:
        import numpy as _np
        enc = Av1Encoder(64, 48, fps=25)
        dec = Av1Decoder()
        rng = _np.random.default_rng(0)
        y = (rng.random((48, 64)) * 255).astype(_np.uint8)
        u = v = _np.full((24, 32), 128, _np.uint8)
        data, key = enc.encode_planes(y, u, v, force_keyframe=True)
        out = dec.decode(data)
        _verified = bool(data and out is not None
                         and out[0].shape == (48, 64))
    except Exception:
        _verified = False
    return _verified


def _u(addr, off, n=4):
    return int.from_bytes(ctypes.string_at(addr + off, n), "little")


class Av1Encoder:
    def __init__(self, width: int, height: int, bitrate_bps: int = 500_000,
                 fps: int = 25, kf_max_dist: int = 100, cpu_used: int = 9):
        if _aom is None:
            raise RuntimeError("libaom not available")
        self.w, self.h = width, height
        iface = _aom.aom_codec_av1_cx()
        cfg = (ctypes.c_uint8 * 8192)()
        _aom.aom_codec_enc_config_default(ctypes.c_void_p(iface), cfg,
                                          AOM_USAGE_REALTIME)
        for off, v in ((_CFG_W, width), (_CFG_H, height),
                       (_CFG_TB_NUM, 1), (_CFG_TB_DEN, fps),
                       (_CFG_TARGET_KBPS, max(bitrate_bps // 1000, 30)),
                       (_CFG_KF_MAX, kf_max_dist)):
            struct.pack_into("<I", cfg, off, v)
        self._cfg = cfg
        self.ctx = (ctypes.c_uint8 * 1024)()
        r = _aom.aom_codec_enc_init_ver(self.ctx, ctypes.c_void_p(iface),
                                        cfg, 0, ENC_ABI)
        if r != 0:
            raise RuntimeError(f"av1 enc init: {r}")
        _aom.aom_codec_control(self.ctx, AOME_SET_CPUUSED, cpu_used)
        self.img = _aom.aom_img_alloc(None, AOM_IMG_FMT_I420,
                                      width, height, 16)
        self.pts = 0

    def set_bitrate(self, bps: int):
        struct.pack_into("<I", self._cfg, _CFG_TARGET_KBPS,
                         max(bps // 1000, 30))
        _aom.aom_codec_enc_config_set(self.ctx, self._cfg)

    def encode_planes(self, y, u, v, force_keyframe: bool = False
                      ) -> Tuple[bytes, bool]:
        planes = [_u(self.img, o, 8) for o in _IMG_PLANES]
        strides = [_u(self.img, o) for o in _IMG_STRIDES]
        for plane, stride, arr in zip(planes, strides, (y, u, v)):
            data = np.ascontiguousarray(arr, np.uint8)
            for row in range(arr.shape[0]):
                ctypes.memmove(plane + row * stride,
                               data[row].tobytes(), arr.shape[1])
        flags = AOM_EFLAG_FORCE_KF if force_keyframe else 0
        r = _aom.aom_codec_encode(self.ctx, self.img, self.pts, 1, flags)
        if r != 0:
            raise RuntimeError(f"av1 encode: {r}")
        self.pts += 1
        it = ctypes.c_void_p(0)
        out, is_key = b"", False
        while True:
            pkt = _aom.aom_codec_get_cx_data(self.ctx, ctypes.byref(it))
            if not pkt:
                break
            if _u(pkt, _PKT_KIND) == 0:
                out += ctypes.string_at(_u(pkt, _PKT_BUF, 8),
                                        _u(pkt, _PKT_SZ, 8))
                is_key = bool(_u(pkt, _PKT_FLAGS) & 1)
        return out, is_key


class Av1Decoder:
    def __init__(self):
        if _aom is None:
            raise RuntimeError("libaom not available")
        self.ctx = (ctypes.c_uint8 * 1024)()
        r = _aom.aom_codec_dec_init_ver(
            self.ctx, ctypes.c_void_p(_aom.aom_codec_av1_dx()), None, 0,
            DEC_ABI)
        if r != 0:
            raise RuntimeError(f"av1 dec init: {r}")

    def decode(self, data: bytes):
        r = _aom.aom_codec_decode(self.ctx, data, len(data), None)
        if r != 0:
            return None
        it = ctypes.c_void_p(0)
        fr = _aom.aom_codec_get_frame(self.ctx, ctypes.byref(it))
        if not fr:
            return None
        w, h = _u(fr, _IMG_DW), _u(fr, _IMG_DH)
        planes = [_u(fr, o, 8) for o in _IMG_PLANES]
        strides = [_u(fr, o) for o in _IMG_STRIDES]

        def read(plane, stride, ph, pw):
            buf = ctypes.string_at(plane, stride * ph)
            return np.frombuffer(buf, np.uint8).reshape(ph, stride)[:, :pw].copy()
        return (read(planes[0], strides[0], h, w),
                read(planes[1], strides[1], h // 2, w // 2),
                read(planes[2], strides[2], h // 2, w // 2))


class Av1FrameCodec:
    """FrameCodec adapter for VideoStreamBatch (packed-I420 byte layout)."""

    name = "av1"

    def __init__(self, width: int, height: int, bitrate_bps: int = 500_000,
                 fps: int = 25):
        self.w, self.h = width, height
        self.enc = Av1Encoder(width, height, bitrate_bps, fps)
        self.dec = Av1Decoder()

    def _unpack(self, frame: bytes):
        a = np.frombuffer(frame, np.uint8).reshape(self.h * 3 // 2, self.w)
        y = a[: self.h]
        uv = a[self.h:].reshape(self.h // 2, 2, self.w // 2)
        return y, uv[:, 0, :], uv[:, 1, :]

    def _pack(self, y, u, v) -> bytes:
        uv = np.stack([u, v], axis=1).reshape(self.h // 2, self.w)
        return np.concatenate([y, uv], axis=0).tobytes()

    def encode(self, frame: bytes, keyframe: bool) -> bytes:
        y, u, v = self._unpack(frame)
        data, _ = self.enc.encode_planes(y, u, v, force_keyframe=keyframe)
        return data

    def decode(self, data: bytes) -> Optional[bytes]:
        out = self.dec.decode(data)
        if out is None:
            return None
        return self._pack(*out)
