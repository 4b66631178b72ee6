"""Video end-to-end benchmark: N self-looped video legs over real UDP.

Beyond a bare device-scaler number, every stream runs the full leg each frame interval:

  [device] mire pattern -> sizeconv pixel path -> (download)
  -> host codec encode (VP8/H.264) -> packetize -> RTP over localhost UDP
  -> depacketize -> decode -> (upload) -> device rx-frame analyse

matching the reference's video tester graphs
(tester/mediastreamer2_video_stream_tester.c:735-1349: camera -> encoder ->
rtp -> decoder -> display with fps/SSRC/PLI assertions) at bench scale
(tools/bench.c shape: stack streams until the ticker misses).

Pass criteria per trial: ticker keeps the 10 ms beat (late ticks bounded),
each leg receives >= 90% of nominal fps in the steady-state window after
the warmup cut (self-loop: sent==received modulo codec latency), and the
decoded pictures carry real luma (the mire pattern, not black).  A loss-recovery phase (netsim burst + FIR/PLI
keyframe recovery) can be asserted separately via run_loss_recovery().
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from mediastreamer2_tpu.core.block import Format
from mediastreamer2_tpu.models.video_stream import VideoStreamBatch
from mediastreamer2_tpu.net.rtp import UdpTransport


@dataclasses.dataclass
class VideoE2EResult:
    n_streams: int
    ticks: int
    ms_per_tick: float
    late_ticks: int
    fps_nominal: float
    fps_received_min: float      # worst leg, steady-state window only
    fps_received_mean: float
    luma_ok: bool                # decoded frames carry the mire pattern

    def passes(self) -> bool:
        """Steady-state delivery bar: every leg receives >= 90% of nominal
        fps AFTER the warmup cut (codec startup + jitter priming excluded
        by run()), matching the reference video tester's assertion that
        expected frames actually arrive under its fps configuration
        (tester/mediastreamer2_video_stream_tester.c:735-1349)."""
        return (self.late_ticks <= max(1, self.ticks // 50)
                and self.fps_received_min >= 0.9 * self.fps_nominal
                and self.luma_ok)


class VideoE2EBench:
    """N video legs, each self-looped over its own localhost UDP socket."""

    def __init__(self, factory, n_streams: int, codec: str = "vp8",
                 width: int = 320, height: int = 240, fps: float = 15.0,
                 pipeline_depth: int = 0, frame_tick: bool = False):
        """frame_tick=True paces the ticker at the FRAME interval instead
        of 10 ms: video device work only produces new content once per
        frame, so per-tick dispatch of per-frame work is pure waste. The reference's 10 ms video tick
        mostly polls between frames for the same reason."""
        fmt = Format(kind="yuv420", width=width, height=height, fps=fps)
        self.fps = fps
        self.vs = VideoStreamBatch(factory, n_streams, fmt=fmt, fps=fps,
                                   codec=codec)
        self.ticks_per_s = 100.0
        if frame_tick:
            # exact fractional interval: int(round(1000/15))=67 ms would
            # quantize nominal pacing to 14.93 fps BEFORE any overhead,
            # silently eating a third of the 10% fps budget passes() allows
            self.vs.ticker.interval_ms = 1000.0 / fps
            self.vs._tick_per_frame = 1
            self.ticks_per_s = fps
        self.transports = []
        for i in range(n_streams):
            t = UdpTransport()
            t.set_remote("127.0.0.1", t.local_port)    # self-loop
            self.vs.set_transport(i, t)
            self.transports.append(t)
        self.vs.bind_assemblers()
        if pipeline_depth:
            # overlap device dispatch with the next ticks, and move readback
            # + host codec work off the paced loop (single worker keeps
            # frame order)
            self.vs.ticker.pipeline_depth = pipeline_depth
            self.vs.ticker.async_publish = True

    def run(self, seconds: float = 3.0, paced: bool = True,
            warmup_seconds: float = 1.0) -> VideoE2EResult:
        """Measured fps is STEADY-STATE: the first `warmup_seconds` of
        delivery (codec startup keyframe, pipeline fill, jitter priming)
        run first and are excluded from the fps window — a 2.5 s average
        that includes warmup understates sustained delivery by ~1 frame/s
        per second of window."""
        tk = self.vs.ticker
        tk.realtime = paced
        tk.warm_up()
        if warmup_seconds > 0:
            tk.run(int(warmup_seconds * self.ticks_per_s) or 1)
            tk.drain()
        base_ticks = tk.stats.ticks
        base_late = tk.stats.late_ticks
        base_rx = [s.frames_received for s in self.vs.stats]
        n_ticks = int(seconds * self.ticks_per_s)
        t0 = time.perf_counter()
        tk.run(n_ticks)
        tk.drain()                       # land in-flight async publishes
        wall = time.perf_counter() - t0
        ticks = tk.stats.ticks - base_ticks
        rx = np.array([s.frames_received - b
                       for s, b in zip(self.vs.stats, base_rx)], float)
        fps_rx = rx / max(wall, 1e-9)
        luma = self.vs._last_rx
        # decoded mire frames: bright + structured (std over the pattern)
        luma_ok = bool((np.abs(luma).mean(axis=(1, 2, 3) if luma.ndim == 4
                                          else (1, 2)) > 0.05).all())
        return VideoE2EResult(
            n_streams=self.vs.batch, ticks=ticks,
            ms_per_tick=wall * 1e3 / max(ticks, 1),
            late_ticks=tk.stats.late_ticks - base_late,
            fps_nominal=self.fps,
            fps_received_min=float(fps_rx.min()) if len(fps_rx) else 0.0,
            fps_received_mean=float(fps_rx.mean()) if len(fps_rx) else 0.0,
            luma_ok=luma_ok)

    def run_loss_recovery(self, seconds: float = 2.0) -> bool:
        """CLOSED-LOOP loss recovery: burst-drop one leg's inbound
        datagrams for a window (netsim-style burst loss), then let the
        PRODUCT detect the damage and recover on its own — no manual
        request_keyframe.

        The recovery chain under test is VideoStreamBatch._push's
        decode-error path: the lost window leaves an inter-frame seq gap
        -> FrameAssembler.seq_gaps increments on the first post-heal
        packet -> FIR feedback emitted through the FIR-rate limiter ->
        (self-loop) sender receives FIR -> forces a keyframe -> decoding
        resumes on a fresh reference chain.  Mirrors the reference's
        unpacker-discontinuity / decoder-error callback ->
        ms_iframe_requests_limiter -> PLI/FIR loop
        (tester/mediastreamer2_video_stream_tester.c:735-1349 'AVPF high
        loss rate'; src/videofilters/vp8rtpfmt.c discontinuity checks).

        Returns True only if (a) the product itself sent >=1 FIR after the
        burst, (b) the sender answered with a fresh keyframe, and (c)
        frames kept arriving after the heal."""
        leg = 0
        orig = self.transports[leg]

        class _Blackout:
            drop = False

            def send(self, d):
                orig.send(d)

            def recv_all(self):
                pkts = orig.recv_all()       # drain socket: burst is LOST
                return [] if self.drop else pkts

            def close(self):
                pass
        lossy = _Blackout()
        self.vs.set_transport(leg, lossy)
        self.vs.bind_assemblers()
        tk = self.vs.ticker
        tk.realtime = False
        # settle: confirm normal flow before the burst
        tk.run(int(seconds * self.ticks_per_s / 4) or 10)
        tk.drain()
        fir_before = self.vs.stats[leg].fir_sent
        kf_before = self.vs.stats[leg].keyframes_sent
        lossy.drop = True                         # the loss burst
        tk.run(int(seconds * self.ticks_per_s / 4) or 10)
        tk.drain()
        lossy.drop = False                        # link heals
        before = self.vs.stats[leg].frames_received
        st = self.vs.stats[leg]
        # heal phase: poll (ticks are virtual when unpaced) with a budget
        # covering the 2 s FIR-limiter interval, so an earlier legitimate
        # FIR can't starve the recovery FIR out of the window
        chunk = int(seconds * self.ticks_per_s / 2) or 10
        for _ in range(8):
            tk.run(chunk)
            tk.drain()
            if (st.fir_sent > fir_before
                    and st.keyframes_sent > kf_before
                    and st.frames_received > before):
                break
        return (st.fir_sent > fir_before                # product asked
                and st.keyframes_sent > kf_before       # sender answered
                and st.frames_received > before)        # decode resumed

    def close(self):
        for t in self.transports:
            try:
                t.close()
            except Exception:
                pass
