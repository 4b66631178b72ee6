"""Video pipeline ops — YUV420 <-> RGB, rescale, rotation, test pattern.

Reference: src/voip/msvideo.c (YUV buffer mgmt :158-315, scaler with
libyuv/swscale backends :526-715, NEON rotation in msvideo_neon.c),
src/videofilters/pixconv.c, sizeconv.c, mire.c (synthetic moving pattern),
and the GLSL YUV->RGB shaders under utils/opengles_display.c:312-377.

Batched: frames are batched tensors — YUV420 packed as
``[legs, h*3/2, w]`` float32 (Y plane stacked over interleaved half-res U,V
rows), RGB as ``[legs, h, w, 3]``.  Color conversion is a 3x3 matmul over
the channel dim, rescale is ``jax.image.resize`` per plane (XLA
generates fused gather/linear-combine kernels), rotation is a transpose —
the things NEON assembly does in the reference fall out of the compiler.

One frame per tick per leg: at the reference's default 10 ms tick a graph
pass moves up to 100 fps; real camera cadence is handled by the host
feeding frames (or repeats) like MSVideoSource does.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from mediastreamer2_tpu.core.block import Format
from mediastreamer2_tpu.core.filter import FilterDef, register_filter

# BT.601 full-range matrices (same space the reference's shaders use)
_YUV2RGB = np.array([[1.0, 0.0, 1.402],
                     [1.0, -0.344136, -0.714136],
                     [1.0, 1.772, 0.0]], np.float32)
_RGB2YUV = np.linalg.inv(_YUV2RGB).astype(np.float32)


def split_yuv420(frame, w: int, h: int):
    """[B, h*3/2, w] -> (Y [B,h,w], U [B,h/2,w/2], V [B,h/2,w/2])."""
    y = frame[:, :h, :]
    uv = frame[:, h:, :].reshape(frame.shape[0], h // 2, 2, w // 2)
    u = uv[:, :, 0, :]
    v = uv[:, :, 1, :]
    return y, u, v


def join_yuv420(y, u, v):
    B, h, w = y.shape
    uv = jnp.stack([u, v], axis=2).reshape(B, h // 2, w)
    return jnp.concatenate([y, uv], axis=1)


def nv12_to_i420(y, uv, nv21: bool = False):
    """Semi-planar (biplanar) -> planar chroma (the framework tester's
    'copy ycbcrbiplanar to true yuv', msvideo.c ms_yuv_buf copy helpers).

    y [B,h,w]; uv [B,h/2,w] with interleaved CbCr (CrCb when nv21)."""
    B, hh, w = uv.shape
    pairs = uv.reshape(B, hh, w // 2, 2)
    u = pairs[..., 1] if nv21 else pairs[..., 0]
    v = pairs[..., 0] if nv21 else pairs[..., 1]
    return y, u, v


def i420_to_nv12(y, u, v, nv21: bool = False):
    """Planar -> semi-planar interleaved chroma."""
    a, b = (v, u) if nv21 else (u, v)
    B, hh, hw = u.shape
    uv = jnp.stack([a, b], axis=-1).reshape(B, hh, hw * 2)
    return y, uv


def nv12_to_yuv420_frame(y, uv, degrees: int = 0, out_w: int = 0,
                         out_h: int = 0, nv21: bool = False):
    """Biplanar input -> packed I420 frame with optional rotation and
    rescale — the tester's rotation/downscale combo matrix in one op
    (rotation before scaling, like ms_yuv_buf_copy_with_rotation)."""
    yy, u, v = nv12_to_i420(y, uv, nv21=nv21)
    frame = join_yuv420(yy, u, v)
    B, h, w = yy.shape
    if degrees:
        frame = rotate_yuv420(frame, w, h, degrees)
        if degrees in (90, 270):
            w, h = h, w
    if out_w and out_h and (out_w, out_h) != (w, h):
        frame = scale_yuv420(frame, w, h, out_w, out_h)
    return frame


def yuv420_to_rgb(frame, w: int, h: int):
    y, u, v = split_yuv420(frame, w, h)
    up = lambda p: jax.image.resize(p, (p.shape[0], h, w), "linear")
    yuv = jnp.stack([y, up(u) - 0.5, up(v) - 0.5], axis=-1)     # [B,h,w,3]
    rgb = jnp.einsum("bhwc,rc->bhwr", yuv, jnp.asarray(_YUV2RGB),
                     precision=jax.lax.Precision.HIGHEST)
    return jnp.clip(rgb, 0.0, 1.0)


def rgb_to_yuv420(rgb):
    B, h, w, _ = rgb.shape
    yuv = jnp.einsum("bhwc,rc->bhwr", rgb, jnp.asarray(_RGB2YUV),
                     precision=jax.lax.Precision.HIGHEST)
    y = yuv[..., 0]
    u = yuv[..., 1] + 0.5
    v = yuv[..., 2] + 0.5
    down = lambda p: jax.image.resize(p, (B, h // 2, w // 2), "linear")
    return join_yuv420(jnp.clip(y, 0, 1), jnp.clip(down(u), 0, 1),
                       jnp.clip(down(v), 0, 1))


def scale_yuv420(frame, w: int, h: int, out_w: int, out_h: int):
    """MSScaler equivalent (msvideo.c:526-715, libyuv I420Scale path).

    Layout note (measured on the target chip): a reshape-mean box filter
    for integer downscale looked cheaper on paper but benched ~1.6x SLOWER
    than jax.image.resize at the config-5 shape (the reduce forces a
    relayout; resize lowers to well-tiled gathers) — keep resize.
    """
    y, u, v = split_yuv420(frame, w, h)
    B = frame.shape[0]
    ys = jax.image.resize(y, (B, out_h, out_w), "linear")
    us = jax.image.resize(u, (B, out_h // 2, out_w // 2), "linear")
    vs = jax.image.resize(v, (B, out_h // 2, out_w // 2), "linear")
    return join_yuv420(ys, us, vs)


def rotate_yuv420(frame, w: int, h: int, degrees: int):
    """90-degree-step rotation (reference: ms_video_rotate..., NEON asm)."""
    if degrees % 360 == 0:
        return frame
    y, u, v = split_yuv420(frame, w, h)
    k = (degrees // 90) % 4
    rot = lambda p: jnp.rot90(p, k=-k, axes=(1, 2))   # clockwise
    return join_yuv420(rot(y), rot(u), rot(v))


def mirror_yuv420(frame, w: int, h: int):
    y, u, v = split_yuv420(frame, w, h)
    m = lambda p: p[:, :, ::-1]
    return join_yuv420(m(y), m(u), m(v))


# ---------------------------------------------------------------- filters
def _mire_formats(ctx):
    return (ctx.params["fmt"],)


def _mire_init(ctx):
    return {"frame_idx": jnp.zeros((ctx.batch,), jnp.int32)}


def _mire_process(state, ins, params, ctx):
    """Moving color-bar/checker pattern (parity: src/videofilters/mire.c)."""
    fmt: Format = ctx.params["fmt"]
    w, h, B = fmt.width, fmt.height, ctx.batch
    idx = state["frame_idx"]
    xs = jax.lax.broadcasted_iota(jnp.int32, (B, h, w), 2)
    ys = jax.lax.broadcasted_iota(jnp.int32, (B, h, w), 1)
    off = idx[:, None, None]
    ycells = (((xs + off) // 32 + ys // 32) % 8).astype(jnp.float32) / 8.0
    u = 0.5 + 0.4 * jnp.sin(2 * np.pi * (xs + off * 2).astype(jnp.float32) / w)
    v = 0.5 + 0.4 * jnp.cos(2 * np.pi * (ys + off * 2).astype(jnp.float32) / h)
    frame = join_yuv420(
        ycells,
        jax.image.resize(u, (B, h // 2, w // 2), "linear"),
        jax.image.resize(v, (B, h // 2, w // 2), "linear"))
    return {"frame_idx": idx + 1}, (frame,), {}


register_filter(FilterDef(
    name="mire", ninputs=0, noutputs=1,
    out_formats=_mire_formats, init=_mire_init, process=_mire_process,
    interfaces=("video_source",),
))


def _pixconv_formats(ctx):
    to = ctx.params.get("to", "rgb")
    f = ctx.in_formats[0]
    return (f.with_(kind=to),)


def _pixconv_process(state, ins, params, ctx):
    f = ctx.in_formats[0]
    to = ctx.params.get("to", "rgb")
    if f.kind == "yuv420" and to == "rgb":
        return state, (yuv420_to_rgb(ins[0], f.width, f.height),), {}
    if f.kind == "rgb" and to == "yuv420":
        return state, (rgb_to_yuv420(ins[0]),), {}
    if f.kind == to:
        return state, (ins[0],), {}
    raise ValueError(f"pixconv {f.kind}->{to} unsupported")


register_filter(FilterDef(
    name="pix_conv", ninputs=1, noutputs=1,
    out_formats=_pixconv_formats, process=_pixconv_process,
))


def _sizeconv_formats(ctx):
    f = ctx.in_formats[0]
    return (f.with_(width=int(ctx.params["out_w"]), height=int(ctx.params["out_h"])),)


def _sizeconv_process(state, ins, params, ctx):
    f = ctx.in_formats[0]
    ow, oh = int(ctx.params["out_w"]), int(ctx.params["out_h"])
    if f.kind == "yuv420":
        return state, (scale_yuv420(ins[0], f.width, f.height, ow, oh),), {}
    out = jax.image.resize(ins[0], (ins[0].shape[0], oh, ow, 3), "linear")
    return state, (out,), {}


register_filter(FilterDef(
    name="size_conv", ninputs=1, noutputs=1,
    out_formats=_sizeconv_formats, process=_sizeconv_process,
))


def _rot_formats(ctx):
    f = ctx.in_formats[0]
    deg = int(ctx.params.get("degrees", 0))
    if deg % 180 == 90:
        return (f.with_(width=f.height, height=f.width),)
    return (f,)


def _rot_process(state, ins, params, ctx):
    f = ctx.in_formats[0]
    deg = int(ctx.params.get("degrees", 0))
    out = rotate_yuv420(ins[0], f.width, f.height, deg)
    if ctx.params.get("mirror", False):
        fo = _rot_formats(ctx)[0]
        out = mirror_yuv420(out, fo.width, fo.height)
    return state, (out,), {}


register_filter(FilterDef(
    name="video_transform", ninputs=1, noutputs=1,
    out_formats=_rot_formats, process=_rot_process,
))


# analyse display: checker/average analysis for tests
# (parity: src/videofilters/msanalysedisplay.c)
def _analyse_process(state, ins, params, ctx):
    f = ctx.in_formats[0]
    if f.kind == "yuv420":
        y, u, v = split_yuv420(ins[0], f.width, f.height)
        mean = y.mean(axis=(1, 2))
    else:
        mean = ins[0].mean(axis=(1, 2, 3))
    return state, (), {"frame_mean": mean}


register_filter(FilterDef(
    name="analyse_display", ninputs=1, noutputs=0,
    out_formats=lambda ctx: (), process=_analyse_process,
    interfaces=("video_display",),
))


def compose_selfview(main, pip, corner: str = "bottom_right",
                     scale: float = 0.25, margin: int = 8):
    """Composite display with local self-view inset — MSVideoOut's layout
    (reference: src/videofilters/videoout.c + layouts.c math).

    main/pip: packed-I420 float blocks [B, h*3/2, w]; the pip is rescaled
    to `scale` of the main picture and blended into the chosen corner.
    Pure jnp: runs fused with the rest of the tick program.
    """
    B, bh, w = main.shape
    h = bh * 2 // 3
    pw = max(16, int(w * scale) // 2 * 2)
    ph = max(12, int(h * scale) // 2 * 2)
    pip_small = scale_yuv420(pip, w, h, pw, ph)          # [B, ph*3/2, pw]
    if corner == "bottom_right":
        x0, y0 = w - pw - margin, h - ph - margin
    elif corner == "bottom_left":
        x0, y0 = margin, h - ph - margin
    elif corner == "top_right":
        x0, y0 = w - pw - margin, margin
    else:                                                # top_left
        x0, y0 = margin, margin
    x0, y0 = max(0, x0), max(0, y0) // 2 * 2
    out_y = jax.lax.dynamic_update_slice(
        main[:, :h], pip_small[:, :ph], (0, y0, x0))
    # chroma rows are interleaved U,V half-res pairs in the packed layout
    main_uv = main[:, h:].reshape(B, h // 2, 2, w // 2)
    pip_uv = pip_small[:, ph:].reshape(B, ph // 2, 2, pw // 2)
    out_uv = jax.lax.dynamic_update_slice(
        main_uv, pip_uv, (0, y0 // 2, 0, x0 // 2))
    return jnp.concatenate([out_y, out_uv.reshape(B, h // 2, w)], axis=1)


# --------------------------------------------------------- pix-stride copy
def plane_copy_with_strides(src: np.ndarray, src_row_stride: int,
                            src_pix_stride: int, src_roi,
                            dst: np.ndarray, dst_row_stride: int,
                            dst_pix_stride: int, dst_roi):
    """One plane of ms_yuv_buf_copy_with_pix_strides (msvideo.c plane_copy):
    copy a src ROI into a dst ROI where each may be planar (pix stride 1)
    or semi-planar interleaved (pix stride 2). Host-side numpy — this is a
    byte-layout shuffle, not device math (CLAUDE.md design rules)."""
    sx, sy, w, h = src_roi
    dx, dy, _, _ = dst_roi
    src = np.asarray(src).reshape(-1)
    dst = dst.reshape(-1)
    for row in range(h):
        r0 = (sy + row) * src_row_stride + sx * src_pix_stride
        w0 = (dy + row) * dst_row_stride + dx * dst_pix_stride
        dst[w0:w0 + w * dst_pix_stride:dst_pix_stride] = \
            src[r0:r0 + w * src_pix_stride:src_pix_stride]


def yuv_copy_with_pix_strides(src_planes, src_row_strides, src_pix_strides,
                              src_roi, dst_planes, dst_row_strides,
                              dst_pix_strides, dst_roi):
    """ms_yuv_buf_copy_with_pix_strides (msvideo.c:245): Y plane copies the
    full ROI, chroma planes copy the ROI halved in every coordinate.
    ROI = (x, y, w, h). Supports planar<->semi-planar (NV12-style UV
    interleave via pixel stride 2) and "sliding" (src ROI != dst ROI)."""
    plane_copy_with_strides(src_planes[0], src_row_strides[0],
                            src_pix_strides[0], src_roi,
                            dst_planes[0], dst_row_strides[0],
                            dst_pix_strides[0], dst_roi)
    half = lambda r: (r[0] // 2, r[1] // 2, r[2] // 2, r[3] // 2)
    s2, d2 = half(src_roi), half(dst_roi)
    for p in (1, 2):
        plane_copy_with_strides(src_planes[p], src_row_strides[p],
                                src_pix_strides[p], s2,
                                dst_planes[p], dst_row_strides[p],
                                dst_pix_strides[p], d2)
