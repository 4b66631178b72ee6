"""Video e2e bench harness: N self-looped VP8 legs over real localhost UDP
with full pixel path + host codec + RTP, plus the loss-recovery phase.
Parity: tester/mediastreamer2_video_stream_tester.c:735-1349 graphs at
tools/bench.c scale."""
import numpy as np
import pytest

from mediastreamer2_tpu.models.video_e2e_bench import VideoE2EBench


def _vp8_or_skip():
    from mediastreamer2_tpu.ops.vp8 import vp8_available
    if not vp8_available():
        pytest.skip("libvpx missing")


def test_video_e2e_paced_small(factory):
    _vp8_or_skip()
    # One retry: a paced realtime trial on the 1-core CI box can lose a
    # boundary frame to transient load (e.g. a concurrent interpreter
    # start costs seconds of CPU), which at a short window is exactly the
    # 0.9x bar's slack.  The bar itself stays 0.9x — same as the bench.
    for attempt in range(2):
        b = VideoE2EBench(factory, 3, codec="vp8", width=128, height=96,
                          fps=15.0)
        res = b.run(seconds=2.0, paced=True)
        b.close()
        if res.passes():
            break
    assert res.passes(), res
    # paced: received rate tracks nominal fps, not the free-run rate
    assert res.fps_received_mean <= res.fps_nominal * 1.5, res


def test_video_e2e_loss_recovery(factory):
    _vp8_or_skip()
    b = VideoE2EBench(factory, 2, codec="vp8", width=128, height=96,
                      fps=15.0)
    b.run(seconds=0.8, paced=False)          # converge first
    assert b.run_loss_recovery(seconds=1.0)
    b.close()


def test_video_e2e_loss_recovery_bench_config(factory):
    """run_loss_recovery under bench.py's EXACT shape (frame_tick=True,
    pipeline_depth=2, seconds=1.0 after a short paced run) — the config
    that certified video_pli_recovery_ok:false on chip in round 4 while
    the frame_tick=False test above passed.  Root cause: stream-clock
    seconds were computed as ticks*0.01 regardless of interval_ms, so at
    15 ticks/s the 2 s FIR-limiter window stretched to ~13 wall-seconds
    and starved the recovery FIR."""
    _vp8_or_skip()
    b = VideoE2EBench(factory, 2, codec="vp8", width=128, height=96,
                      fps=15.0, pipeline_depth=2, frame_tick=True)
    b.run(seconds=1.0, paced=False)          # bench runs 2.5 s paced first
    assert b.run_loss_recovery(seconds=1.0)
    b.close()
