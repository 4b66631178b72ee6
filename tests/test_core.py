"""Core runtime tests — parity targets: reference framework tester
(tester/mediastreamer2_framework_tester.c): registry, linking rules,
event queue, graph execution."""
import numpy as np
import jax.numpy as jnp
import pytest

from mediastreamer2_tpu.core.block import Format, tick_samples
from mediastreamer2_tpu.core.graph import GraphBuilder
from mediastreamer2_tpu.core.events import EventQueue
from mediastreamer2_tpu.core.ticker import Ticker, TickerSynchronizer

FMT8K = Format(kind="pcm", rate=8000, channels=1)


def test_registry(factory):
    assert factory.has("tee")
    assert factory.find_encoder("ulaw").name == "ulaw_enc"
    assert factory.find_decoder("alaw").name == "alaw_dec"
    encs = factory.filters_implementing("audio_encoder")
    assert any(f.name == "ulaw_enc" for f in encs)


def test_link_validation(factory):
    g = GraphBuilder(factory, batch=2)
    src = g.add("ext_source", "in", fmt=FMT8K)
    sink = g.add("ext_sink", "out")
    g.link(src, 0, sink, 0)
    with pytest.raises(ValueError):
        g.link(src, 0, sink, 0)          # double-link
    with pytest.raises(ValueError):
        g.link(src, 5, sink, 0)          # bad pin


def test_unlinked_input_rejected(factory):
    g = GraphBuilder(factory, batch=1)
    g.add("ulaw_enc", "enc")
    with pytest.raises(ValueError, match="unlinked"):
        g.build()


def test_passthrough_step(factory):
    B = 4
    g = GraphBuilder(factory, batch=B)
    src = g.add("ext_source", "in", fmt=FMT8K)
    t = g.add("tee", "tee")
    sink = g.add("ext_sink", "out")
    g.link(src, 0, t, 0)
    g.link(t, 0, sink, 0)
    cg = g.build()
    st = cg.init_state()
    x = np.random.default_rng(0).standard_normal((B, 80)).astype(np.float32)
    st, out, ev = cg.step(st, cg.init_params(), {"in": x})
    np.testing.assert_allclose(np.asarray(out["out"]), x)


def test_scan_multitick(factory):
    B, K = 3, 5
    g = GraphBuilder(factory, batch=B)
    src = g.add("ext_source", "in", fmt=FMT8K)
    sink = g.add("ext_sink", "out")
    g.link(src, 0, sink, 0)
    cg = g.build()
    xs = np.arange(K * B * 80, dtype=np.float32).reshape(K, B, 80)
    st, outs, evs = cg.run_scan(cg.init_state(), cg.init_params(), {"in": xs})
    np.testing.assert_allclose(np.asarray(outs["out"]), xs)


def test_cycle_rejected(factory):
    g = GraphBuilder(factory, batch=1)
    j = g.add("join", "j")
    t = g.add("tee", "t")
    g.link(j, 0, t, 0)
    g.link(t, 0, j, 0)
    g.link(t, 1, j, 1)
    with pytest.raises(ValueError, match="cycle"):
        g.build()


def test_event_queue():
    q = EventQueue()
    q.post_tensor_events({"player.eof": np.array([False, True, False, True])}, tick=7)
    assert len(q) == 2
    got = []
    q.set_handler("player.eof", lambda ev: got.append(ev.leg))
    assert q.pump() == 2
    assert got == [1, 3]


def test_file_player_eof_and_loop(factory):
    B, S = 2, tick_samples(8000)
    sig = np.ones(S * 2, np.float32) * 0.25      # 2 ticks of signal
    g = GraphBuilder(factory, batch=B)
    p = g.add("file_player", "play", fmt=FMT8K, signal=sig)
    sink = g.add("ext_sink", "out")
    g.link(p, 0, sink, 0)
    cg = g.build()
    st, params = cg.init_state(), cg.init_params()
    params["play"]["loop"] = jnp.array([False, True])
    outs, eofs = [], []
    for _ in range(4):
        st, out, ev = cg.step(st, params, {})
        outs.append(np.asarray(out["out"]))
        eofs.append(np.asarray(ev["play.eof"]))
    assert eofs[0].tolist() == [False, False]
    assert eofs[1].tolist() == [True, True]
    # leg 0 (no loop) is silent on tick 3; leg 1 looped and keeps playing
    assert np.all(outs[2][0] == 0.0)
    assert np.all(outs[2][1] == 0.25)


def test_ticker_runs_and_measures(factory):
    B = 2
    g = GraphBuilder(factory, batch=B)
    src = g.add("ext_source", "in", fmt=FMT8K)
    sink = g.add("ext_sink", "out")
    g.link(src, 0, sink, 0)
    cg = g.build()
    tk = Ticker(cg, realtime=False)
    tk.warm_up()
    tk.run(10)
    assert tk.stats.ticks == 10
    assert tk.time_ms == 100
    assert tk.stats.mean_step_ms > 0


def test_ticker_synchronizer():
    ts = TickerSynchronizer(alpha=0.5)
    # device consuming at exactly 8 kHz with constant 5 ms offset
    for i in range(1, 50):
        skew = ts.update(nb_samples=i * 80, rate=8000, host_time_ms=i * 10 + 5)
    assert abs(skew - 5.0) < 0.5
    assert abs(ts.drift_ms(50 * 80, 8000, 50 * 10 + 5)) < 0.5


def test_ticker_pipelined_outputs_complete(factory):
    """pipeline_depth>0: outputs arrive `depth` ticks late but complete,
    in order, and drain() flushes the tail."""
    import numpy as np
    from mediastreamer2_tpu import GraphBuilder, Format, tick_samples
    from mediastreamer2_tpu.core.ticker import Ticker
    S = tick_samples(8000)
    ticks = 12
    sig = np.arange(S * ticks, dtype=np.float32) / (S * ticks)
    g = GraphBuilder(factory, batch=2)
    p = g.add("file_player", "play", fmt=Format(rate=8000), signal=sig)
    g.chain(p, g.add("ext_sink", "out"))
    cg = g.build()
    tk = Ticker(cg, realtime=False, pipeline_depth=3)
    got = {}
    tk.set_io(push=lambda t, out: got.update({t: np.asarray(out["out"][0])}))
    tk.warm_up()
    tk.run(ticks)
    assert sorted(got) == list(range(ticks))
    flat = np.concatenate([got[t] for t in range(ticks)])
    np.testing.assert_allclose(flat, sig, atol=1e-6)


def test_fleet_ticker_heterogeneous_graphs(factory):
    """Two DIFFERENT compiled graphs (different batch + rate shape
    classes) co-resident under ONE FleetTicker beat: both deliver
    complete, correct output streams; stride runs a member every Nth
    tick; no thread ever double-ticks a graph (single-loop design —
    the c5f8759 race cannot occur).  Parity: msticker.c:448 (arbitrary
    concurrent graphs is the reference's default condition)."""
    import numpy as np
    from mediastreamer2_tpu import GraphBuilder, Format, tick_samples
    from mediastreamer2_tpu.core.ticker import FleetTicker, Ticker
    ticks = 12
    S8 = tick_samples(8000)
    sig_a = np.arange(S8 * ticks, dtype=np.float32) / (S8 * ticks)
    ga = GraphBuilder(factory, batch=2)
    pa = ga.add("file_player", "play", fmt=Format(rate=8000), signal=sig_a)
    ga.chain(pa, ga.add("ulaw_enc"), ga.add("ulaw_dec"),
             ga.add("ext_sink", "out"))
    # different shape class: batch 3 at 16 kHz, pipelined dispatch
    S16 = tick_samples(16000)
    sig_b = 0.5 * np.ones(S16 * ticks, np.float32)
    gb = GraphBuilder(factory, batch=3)
    pb = gb.add("file_player", "play", fmt=Format(rate=16000), signal=sig_b)
    gb.chain(pb, gb.add("ext_sink", "out"))
    ta = Ticker(ga.build(), name="a", realtime=False)
    tb = Ticker(gb.build(), name="b", realtime=False, pipeline_depth=2)
    got_a, got_b = {}, {}
    ta.set_io(push=lambda t, o: got_a.update({t: np.asarray(o["out"][0])}))
    tb.set_io(push=lambda t, o: got_b.update({t: np.asarray(o["out"][0])}))
    fleet = FleetTicker(realtime=False)
    fleet.add(ta)
    fleet.add(tb, stride=2)               # member b runs every 2nd tick
    fleet.warm_up()
    fleet.run(ticks)
    assert fleet.stats.ticks == ticks
    assert ta.stats.ticks == ticks
    assert tb.stats.ticks == ticks // 2   # stride honored
    # member a: complete in-order ulaw roundtrip of its own signal
    flat = np.concatenate([got_a[t] for t in range(ticks)])
    assert np.corrcoef(flat, sig_a)[0, 1] > 0.999
    # member b (pipelined): all its ticks published after drain
    assert sorted(got_b) == list(range(ticks // 2))
    assert all(np.allclose(v, 0.5, atol=1e-6) for v in got_b.values())


def test_profile_nodes_reports_per_node_times(factory):
    """profile_nodes: per-node ms attribution with forced readback (the
    MSFilterStats box-plot role)."""
    import numpy as np
    from mediastreamer2_tpu import GraphBuilder, Format, tick_samples
    S = tick_samples(8000)
    g = GraphBuilder(factory, batch=4)
    src = g.add("ext_source", "in", fmt=Format(rate=8000))
    g.chain(src, g.add("ulaw_enc", "enc"), g.add("ulaw_dec", "dec"),
            g.add("ext_sink", "out"))
    cg = g.build()
    times = cg.profile_nodes(cg.init_state(), cg.init_params(),
                             ext_in={"in": np.zeros((4, S), np.float32)},
                             iters=3)
    assert set(times) == {"enc", "dec"}
    assert all(v >= 0 for v in times.values())


def test_ticker_save_load_state_resumes_streams(factory):
    """Whole-graph checkpoint/resume (media_stream_reclaim_sessions +
    EC-blob parity): a NEW ticker restored from a snapshot continues
    exactly where the old one stopped — codec predictor state included."""
    import numpy as np
    from mediastreamer2_tpu import GraphBuilder, Format, tick_samples
    from mediastreamer2_tpu.core.ticker import Ticker
    S = tick_samples(8000)
    ticks = 40
    sig = np.sin(np.arange(S * ticks) / 3.0).astype(np.float32) * 0.5

    def build():
        g = GraphBuilder(factory, batch=1)
        p = g.add("file_player", "play", fmt=Format(rate=8000), signal=sig)
        # dvi4 is stateful per sample: any resume glitch corrupts audio
        g.chain(p, g.add("dvi4_enc"), g.add("dvi4_dec"),
                g.add("ext_sink", "out"))
        return g.build()

    ref = Ticker(build(), realtime=False)
    outs_ref = []
    ref.set_io(push=lambda t, o: outs_ref.append(np.asarray(o["out"])[0]))
    ref.warm_up()
    ref.run(ticks)

    a = Ticker(build(), realtime=False)
    outs = []
    a.set_io(push=lambda t, o: outs.append(np.asarray(o["out"])[0]))
    a.warm_up()
    a.run(ticks // 2)
    blob = a.save_state()

    b = Ticker(build(), realtime=False)       # fresh graph, warm resume
    b.set_io(push=lambda t, o: outs.append(np.asarray(o["out"])[0]))
    b.load_state(blob)
    b.warm_up()
    b.stats.ticks = ticks // 2                # continue the tick count
    b.run(ticks // 2)
    np.testing.assert_allclose(np.concatenate(outs),
                               np.concatenate(outs_ref), atol=1e-6)


def test_factory_filter_enable_disable():
    """'FilterDesc enabling/disabling' framework tester case
    (ms_factory_enable_filter_from_name)."""
    import pytest
    from mediastreamer2_tpu.core.factory import Factory
    f = Factory()
    assert f.filter_enabled("ulaw_enc")
    f.enable_filter("ulaw_enc", False)
    assert not f.filter_enabled("ulaw_enc")
    assert not f.has("ulaw_enc")
    assert f.find_encoder("ulaw") is None      # codec lookup skips disabled
    with pytest.raises(KeyError):
        f.lookup("ulaw_enc")
    f.enable_filter("ulaw_enc", True)
    assert f.has("ulaw_enc") and f.find_encoder("ulaw") is not None
    with pytest.raises(KeyError):
        f.enable_filter("nonexistent")


def test_unsynchronized_inputs_rejected_at_build(factory):
    """basic_audio tester's 'unsynchronized inputs' case, the batched
    way: the reference's bufferizer absorbs a 10%-fast input at run time;
    here graphs are fixed-shape, so mismatched input rates are a
    BUILD-time error directing the caller to a resampler."""
    import numpy as np
    import pytest
    from mediastreamer2_tpu.core.graph import GraphBuilder
    from mediastreamer2_tpu.core.block import Format
    g = GraphBuilder(factory, batch=1)
    p1 = g.add("file_player", "p1", fmt=Format(rate=8800),
               signal=np.zeros(880, np.float32))
    p2 = g.add("file_player", "p2", fmt=Format(rate=8000),
               signal=np.zeros(800, np.float32))
    mx = g.add("mix2", "mx")
    g.link(p1, 0, mx, 0)
    g.link(p2, 0, mx, 1)
    g.link(mx, 0, g.add("ext_sink", "out"), 0)
    with pytest.raises(ValueError, match="resample"):
        g.build()


def test_unsynchronized_inputs_fixed_with_resampler(factory):
    """...and with the prescribed resampler the same graph mixes fine."""
    import numpy as np
    from mediastreamer2_tpu.core.graph import GraphBuilder
    from mediastreamer2_tpu.core.block import Format
    g = GraphBuilder(factory, batch=1)
    p1 = g.add("file_player", "p1", fmt=Format(rate=16000),
               signal=np.ones(1600, np.float32) * 0.25)
    p2 = g.add("file_player", "p2", fmt=Format(rate=8000),
               signal=np.ones(800, np.float32) * 0.25)
    rs = g.add("resample", "rs", out_rate=8000)
    mx = g.add("mix2", "mx")
    g.link(p1, 0, rs, 0)
    g.link(rs, 0, mx, 0)
    g.link(p2, 0, mx, 1)
    g.link(mx, 0, g.add("ext_sink", "out"), 0)
    cg = g.build()
    st = cg.init_state()
    st, out, _ = cg.step(st, cg.init_params(), {})
    assert np.asarray(out["out"]).shape == (1, 80)


def test_ticker_schedprio_env(factory, monkeypatch):
    """MS2TPU_TICKER_SCHEDPRIO elevates the tick loop to SCHED_RR
    (msticker.c:330-399 / MS_TICKER_SCHEDPRIO:370); without privileges it
    degrades gracefully — either way the ticks run."""
    import os
    import numpy as np
    from mediastreamer2_tpu.core.graph import GraphBuilder
    from mediastreamer2_tpu.core.block import Format
    from mediastreamer2_tpu.core.ticker import Ticker
    monkeypatch.setenv("MS2TPU_TICKER_SCHEDPRIO", "10")
    g = GraphBuilder(factory, batch=1)
    src = g.add("void_source", "vs", fmt=Format(rate=8000))
    g.link(src, 0, g.add("ext_sink", "out"), 0)
    tk = Ticker(g.build(), realtime=True)
    tk.warm_up()
    old_policy = os.sched_getscheduler(0)
    try:
        tk.run(5)
        assert tk.stats.ticks == 5
        # in this container (root) the elevation actually lands
        if os.geteuid() == 0:
            assert os.sched_getscheduler(0) in (os.SCHED_RR, old_policy)
    finally:
        try:                           # restore for the rest of the suite
            os.sched_setscheduler(0, os.SCHED_OTHER, os.sched_param(0))
        except OSError:
            pass
