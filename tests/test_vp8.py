"""VP8 host codec (libvpx via probed-ABI ctypes) — unit + full video call
(parity: src/videofilters/vp8.c + vp8rtpfmt.c)."""
import numpy as np
import pytest

from mediastreamer2_tpu.ops import vp8
from mediastreamer2_tpu.core.block import Format
from mediastreamer2_tpu.models.video_stream import VideoStreamBatch
from mediastreamer2_tpu.net.rtp import LoopbackPair

pytestmark = pytest.mark.skipif(not vp8.vp8_available(),
                                reason="libvpx missing")
W, H = 64, 48


def _gradient(w=W, h=H, off=0):
    y = ((np.arange(h)[:, None] * 3 + np.arange(w)[None, :] + off) % 220
         ).astype(np.uint8)
    u = np.full((h // 2, w // 2), 100, np.uint8)
    v = np.full((h // 2, w // 2), 160, np.uint8)
    return y, u, v


def test_vp8_roundtrip_quality():
    enc = vp8.Vp8Encoder(W, H, bitrate_bps=400_000)
    dec = vp8.Vp8Decoder()
    for i in range(5):
        y, u, v = _gradient(off=i * 4)
        data, is_key = enc.encode_planes(y, u, v)
        assert (i == 0) == is_key        # first frame is the keyframe
        out = dec.decode(data)
        assert out is not None
        dy, du, dv = out
    mse = float(((dy.astype(float) - y.astype(float)) ** 2).mean())
    assert mse < 30.0, f"vp8 y mse {mse}"
    assert abs(float(du.mean()) - 100) < 6
    assert abs(float(dv.mean()) - 160) < 6


def test_vp8_forced_keyframe():
    enc = vp8.Vp8Encoder(W, H)
    y, u, v = _gradient()
    enc.encode_planes(y, u, v)
    _, k2 = enc.encode_planes(y, u, v)
    assert not k2
    _, k3 = enc.encode_planes(y, u, v, force_keyframe=True)
    assert k3                             # REQ_VFU honored


def test_vp8_payload_descriptor():
    frags = vp8.vp8_payload_pack([b"abc", b"def"])
    d0, s0, p0 = vp8.vp8_payload_unpack(frags[0])
    d1, s1, p1 = vp8.vp8_payload_unpack(frags[1])
    assert (d0, s0, p0) == (b"abc", True, None)
    assert (d1, s1, p1) == (b"def", False, None)


def test_vp8_payload_picture_id():
    frags = vp8.vp8_payload_pack([b"xyz"], picture_id=12345)
    d, s, pid = vp8.vp8_payload_unpack(frags[0])
    assert (d, s, pid) == (b"xyz", True, 12345)
    # 7-bit form parses too
    short = bytes([0x90, 0x80, 42]) + b"qq"
    d, s, pid = vp8.vp8_payload_unpack(short)
    assert (d, s, pid) == (b"qq", True, 42)


def test_vp8_video_call(factory):
    B = 1
    fmt = Format(kind="yuv420", width=W, height=H, fps=25.0)
    mk = lambda: vp8.Vp8FrameCodec(W, H, bitrate_bps=300_000)
    tx = VideoStreamBatch(factory, B, fmt=fmt, fps=25.0, codec_factory=mk)
    rx = VideoStreamBatch(factory, B, fmt=fmt, fps=25.0, codec_factory=mk)
    pair = LoopbackPair()
    tx.set_transport(0, pair.endpoint(0))
    rx.set_transport(0, pair.endpoint(1))
    tx.bind_assemblers(); rx.bind_assemblers()
    tx.ticker.realtime = rx.ticker.realtime = False
    tx.ticker.warm_up(); rx.ticker.warm_up()
    for _ in range(60):
        tx.ticker.do_tick()
        rx.ticker.do_tick()
    assert rx.stats[0].frames_received >= 5
    # received frames carry the moving mire pattern (not black)
    assert float(np.abs(rx._last_rx[0]).mean()) > 0.05


def test_partition_mode_roundtrip():
    """Token-partition output: the encoder emits separate partition
    buffers whose concatenation decodes identically; RFC 7741 packets are
    partition-aligned with PID fields (vp8rtpfmt.c partition handling)."""
    import numpy as np
    if not vp8.vp8_available():
        import pytest
        pytest.skip("libvpx unavailable")
    enc = vp8.Vp8Encoder(64, 48, fps=25, token_partitions_log2=2)
    dec = vp8.Vp8Decoder()
    rng = np.random.default_rng(4)
    y = (rng.random((48, 64)) * 255).astype(np.uint8)
    u = v = np.full((24, 32), 128, np.uint8)
    parts, key = enc.encode_partitions(y, u, v, force_keyframe=True)
    assert key and len(parts) == 5          # first + 4 token partitions
    out = dec.decode(b"".join(parts))
    assert out is not None and out[0].shape == (48, 64)
    payloads = vp8.vp8_packetize_partitions(parts, mtu=1400, picture_id=7)
    # one packet per partition (all small here), PIDs 0..4 capped at 7
    pids = [vp8.vp8_partition_id(pl) for pl in payloads]
    assert pids == [0, 1, 2, 3, 4]
    # every partition-start packet has S=1
    assert all(pl[0] & 0x10 for pl in payloads)
    # reassemble by PID order and decode
    datas = [vp8.vp8_payload_unpack(pl)[0] for pl in payloads]
    assert b"".join(datas) == b"".join(parts)


def test_vp8_available_is_verified():
    """vp8_available now proves the ABI with a real roundtrip, not just
    the presence of the library."""
    assert vp8.vp8_available() in (True, False)
    if vp8.vp8_available():
        assert vp8._verified is True
