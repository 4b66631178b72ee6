"""Mixed-fleet co-residency: heterogeneous compiled graphs sharing one
device under concurrent paced loops — small-N CPU validation of the
machinery bench.py measures at scale on the GPU.
Parity: src/base/msticker.c:448 + src/voip/mediastream.c:227-239 (arbitrary
concurrent graph mixes are the reference's default condition)."""
import pytest

from mediastreamer2_tpu.core.factory import Factory
from mediastreamer2_tpu.native import rtp_edge_available
from mediastreamer2_tpu.models.mixed_fleet import MixedFleetBench


def _vp8_ok():
    try:
        from mediastreamer2_tpu.ops.vp8 import vp8_available
        return vp8_available()
    except Exception:
        return False


def _opus_ok():
    from mediastreamer2_tpu.ops import host_codecs as hc
    return hc.opus_available()


class _StubFut:
    def __init__(self, err=None):
        self._done = False
        self._err = err

    def done(self):
        return self._done

    def result(self):
        if self._err:
            raise self._err
        return None


class _StubWorker:
    def __init__(self):
        self.futs = []

    def submit(self, fn):
        f = _StubFut()
        self.futs.append(f)
        return f


class _StubTicker:
    realtime = True

    def do_tick(self):
        pass


def test_ticker_stepper_backlog_bound():
    """A dispatch worker that falls behind caps the stepper's in-flight
    queue at MAX_BACKLOG (further edges are skipped, counted late by the
    callers) and resumes as soon as a slot frees."""
    from mediastreamer2_tpu.models.mixed_fleet import _TickerStepper
    tk, w = _StubTicker(), _StubWorker()
    st = _TickerStepper(tk, w)
    assert tk.realtime is False          # fleet loop owns pacing
    for _ in range(st.MAX_BACKLOG):
        assert st._submit_tick()
    assert not st._submit_tick()         # backlogged: skip, don't queue
    assert len(w.futs) == st.MAX_BACKLOG
    w.futs[0]._done = True               # worker caught up by one
    assert st._submit_tick()


def test_ticker_stepper_propagates_worker_errors():
    """do_tick failures on the dispatch worker re-raise on the fleet loop
    (where the member gets error-discarded) instead of vanishing."""
    from mediastreamer2_tpu.models.mixed_fleet import _TickerStepper
    st = _TickerStepper(_StubTicker(), _StubWorker())
    st._pending.append(_StubFut(err=RuntimeError("boom")))
    st._pending[0]._done = True
    with pytest.raises(RuntimeError, match="boom"):
        st._submit_tick()


@pytest.mark.slow
@pytest.mark.skipif(not rtp_edge_available(), reason="g++ build failed")
@pytest.mark.parametrize("mode", ["loop", "threads"])
def test_mixed_fleet_coresident(factory, mode):
    """Flagship G.711 e2e legs + SRTP legs + opus host-codec conference
    legs + VP8 video streams, all concurrently: every class keeps its own
    deadline while sharing the device, and traffic/fidelity oracles hold
    per class — in BOTH co-residency shapes (one paced loop / per-member
    threads)."""
    n_opus = 2 if _opus_ok() else 0
    n_video = 2 if _vp8_ok() else 0
    fleet = MixedFleetBench(Factory, n_flagship=16, n_srtp=8,
                            n_opus=n_opus, n_video=n_video,
                            k_block=4, depth=1, opus_depth=0,
                            video_depth=0)
    try:
        res = fleet.run(seconds=2.0, mode=mode)
    finally:
        fleet.close()
    assert not res.errors, res.errors
    # flagship + srtp classes: deadline, traffic and fidelity held
    assert res.flagship is not None and res.flagship.fidelity > 0.9, \
        res.summary()
    assert res.srtp is not None and res.srtp.fidelity > 0.9, res.summary()
    assert res.srtp.auth_failures == 0
    if n_opus:
        assert res.opus["delivery"] >= 0.9, res.summary()
    if n_video:
        assert res.video.fps_received_min > 0, res.summary()
    # the combined verdict machinery reports one bit for the artifact
    assert isinstance(res.passes(), bool)
    assert res.summary()["flagship"]["legs"] == 16
