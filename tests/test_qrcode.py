"""QR reader on the video branch (parity: zxing_qrcode.cpp via cv2)."""
import numpy as np
import pytest

from mediastreamer2_tpu.ops.qrcode import qrcode_available

pytestmark = pytest.mark.skipif(not qrcode_available(), reason="no cv2")


def _make_qr(text):
    """Render a QR with cv2's encoder if present, else PIL fallback."""
    import cv2
    try:
        enc = cv2.QRCodeEncoder.create()
        img = enc.encode(text)
        return img
    except (AttributeError, cv2.error):
        pytest.skip("cv2 QRCodeEncoder missing")


def test_qr_detect_from_luma():
    import cv2
    from mediastreamer2_tpu.ops.qrcode import QrCodeReader
    img = _make_qr("sip:conf@example.com")
    # upscale with margin, like a camera frame
    big = cv2.resize(img, (240, 240), interpolation=cv2.INTER_NEAREST)
    frame = np.full((320, 320), 255, np.uint8)
    frame[40:280, 40:280] = big
    r = QrCodeReader()
    assert r.scan_gray(frame) == "sip:conf@example.com"
    assert r.found == ["sip:conf@example.com"]
    # a plain frame decodes nothing
    assert r.scan_gray(np.full((320, 320), 128, np.uint8)) is None


def test_qr_from_packed_yuv_block():
    import cv2
    from mediastreamer2_tpu.ops.qrcode import QrCodeReader
    img = _make_qr("hello-ms2")
    big = cv2.resize(img, (200, 200), interpolation=cv2.INTER_NEAREST)
    h, w = 240, 320
    y = np.full((h, w), 255, np.uint8)
    y[20:220, 60:260] = big
    block = np.concatenate([y.astype(np.float32) / 255.0,
                            np.full((h // 2, w), 0.5, np.float32)], axis=0)
    r = QrCodeReader()
    assert r.scan_yuv_block(block, w, h) == "hello-ms2"
