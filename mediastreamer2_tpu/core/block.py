"""Tick blocks and media formats.

The reference moves variable-size refcounted ``mblk_t`` buffers through
per-edge FIFO queues (reference: include/mediastreamer2/msqueue.h:32-36,
oRTP str_utils).  Under XLA, dynamic shapes force recompilation, so the unit of
data is a **fixed-size tick block**: every graph edge carries exactly one
tick (10 ms) worth of samples for *all* legs at once, shaped
``[legs, samples_per_tick * channels]`` (interleaved, like the reference's
int16 PCM convention but stored float32 in [-1, 1]).

Byte-granular buffering (the reference's MSBufferizer,
include/mediastreamer2/msqueue.h:131-242) only survives at host boundaries;
on-device rate adaptation is done with static-shape ring buffers carried in
filter state (see ops/resample.py).
"""
from __future__ import annotations

import dataclasses

TICK_MS = 10  # reference: src/base/msticker.c:46 TICKER_INTERVAL


def tick_samples(rate: int, tick_ms: int = TICK_MS) -> int:
    """Samples per tick per channel at ``rate`` Hz."""
    s = rate * tick_ms
    if s % 1000 != 0:
        raise ValueError(f"rate {rate} does not yield integer samples per {tick_ms} ms tick")
    return s // 1000


@dataclasses.dataclass(frozen=True)
class Format:
    """Static per-edge media format, resolved at graph-build time.

    The reference negotiates rate/channels dynamically through
    ``ms_filter_call_method`` (MS_FILTER_SET_SAMPLE_RATE etc.); here formats
    are part of the graph's static shape class — changing them means
    compiling a different graph, which is the batched equivalent of the
    reference's "graphs are only mutated while detached" invariant
    (reference: src/base/msfilter.c:126-133).

    kind: 'pcm' (float32 audio), 'ulaw'/'alaw'/'l16'/'g722'/'gsm' (encoded,
          still fixed-rate so shapes stay static), 'yuv420'/'rgb' (video).
    """
    kind: str = "pcm"
    rate: int = 8000
    channels: int = 1
    # video-only
    width: int = 0
    height: int = 0
    fps: float = 0.0

    @property
    def is_audio(self) -> bool:
        return self.kind in ("pcm", "ulaw", "alaw", "l16", "g722", "gsm", "cn", "opus", "dvi4")

    @property
    def samples_per_tick(self) -> int:
        """Per-leg flattened samples in one tick block (interleaved channels)."""
        return tick_samples(self.rate) * self.channels

    def with_(self, **kw) -> "Format":
        return dataclasses.replace(self, **kw)


def block_dtype(fmt: Format):
    """Numpy/JAX dtype of a tick block: float32 PCM/video, int32 for encoded
    codes (host narrows to uint8/int16 at the RTP boundary)."""
    import jax.numpy as jnp
    if fmt.kind in ("ulaw", "alaw", "g722", "gsm", "l16", "dvi4"):
        return jnp.int32
    return jnp.float32


def block_shape(batch: int, fmt: Format) -> tuple:
    """Shape of one tick block on an edge with format ``fmt``."""
    if fmt.kind in ("yuv420",):
        # planar YUV 4:2:0 packed as [legs, h*3//2, w] (Y plane then U,V half-res)
        return (batch, fmt.height * 3 // 2, fmt.width)
    if fmt.kind in ("rgb",):
        return (batch, fmt.height, fmt.width, 3)
    return (batch, fmt.samples_per_tick)
