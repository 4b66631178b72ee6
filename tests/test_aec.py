"""Echo canceller quality tests — ERLE convergence on simulated room echo
(parity target: reference aec3 tester scenarios,
tester/mediastreamer2_aec3_tester.c + tools/audio/aec/aec_metrics.py)."""
import numpy as np
import jax.numpy as jnp

from mediastreamer2_tpu.core.block import Format, tick_samples
from mediastreamer2_tpu.core.graph import GraphBuilder
from mediastreamer2_tpu.ops.aec import get_state_blob, set_state_blob
from mediastreamer2_tpu.utils.audiodiff import snr_db

from conftest import make_speechlike

RATE = 16000
S = tick_samples(RATE)


def room_ir(rng, length, delay=20):
    ir = np.zeros(length)
    ir[delay] = 0.5
    decay = np.exp(-np.arange(length - delay) / (length / 4))
    ir[delay:] += 0.15 * rng.standard_normal(length - delay) * decay
    return ir


def simulate(factory, B=2, ticks=300, near_talk=False, seed=0,
             dt_start_tick=150):
    """Far-end speech plays throughout; optional near-end (double-talk)
    enters at dt_start_tick — the shape of the reference aec3 scenarios."""
    rng = np.random.default_rng(seed)
    n = S * ticks
    far = make_speechlike(n, RATE, seed=seed)
    ir = room_ir(rng, 400)
    echo = np.convolve(far, ir)[:n].astype(np.float32)
    near_sig = np.zeros(n, np.float32)
    if near_talk:
        near_sig = make_speechlike(n, RATE, seed=seed + 99)
        near_sig[: dt_start_tick * S] = 0.0
    near = echo + near_sig + 1e-4 * rng.standard_normal(n).astype(np.float32)

    g = GraphBuilder(factory, batch=B)
    near_src = g.add("ext_source", "near", fmt=Format(rate=RATE))
    far_src = g.add("ext_source", "far", fmt=Format(rate=RATE))
    ec = g.add("echo_canceller", "ec", tail_ms=80)
    sink = g.add("ext_sink", "out")
    g.link(near_src, 0, ec, 0)
    g.link(far_src, 0, ec, 1)
    g.link(ec, 0, sink, 0)
    cg = g.build()
    st, params = cg.init_state(), cg.init_params()
    near_t = np.broadcast_to(near.reshape(ticks, 1, S), (ticks, B, S))
    far_t = np.broadcast_to(far.reshape(ticks, 1, S), (ticks, B, S))
    st, outs, _ = cg.run_scan(st, params, {"near": jnp.asarray(near_t),
                                           "far": jnp.asarray(far_t)})
    out = np.asarray(outs["out"])[:, 0, :].reshape(-1)
    return near, echo, near_sig, out, st


def erle_db(echo, out, sl):
    e_in = (echo[sl] ** 2).mean()
    e_out = (out[sl] ** 2).mean()
    return 10 * np.log10(e_in / (e_out + 1e-12))


def test_aec_erle_convergence(factory):
    near, echo, _, out, _ = simulate(factory, ticks=300)
    converged = slice(150 * S, 300 * S)
    e = erle_db(echo, out, converged)
    assert e > 15, f"converged ERLE {e:.1f} dB"
    early = erle_db(echo, out, slice(0, 30 * S))
    assert e > early  # it actually adapts


def test_aec_preserves_near_speech(factory):
    near, echo, near_sig, out, _ = simulate(factory, ticks=300, near_talk=True)
    tail = slice(200 * S, 300 * S)
    s = snr_db(near_sig[tail], out[tail])
    assert s > 5, f"near speech SNR through AEC {s:.1f} dB"


def test_aec_state_blob_roundtrip(factory):
    _, _, _, _, st = simulate(factory, B=1, ticks=20)
    blob = get_state_blob(st["ec"])
    restored = set_state_blob(blob)
    for k, v in st["ec"].items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(restored[k]))


def test_sround_bf16_unbiased_subulp():
    """Stochastic rounding (the bf16-shadow enabler): accumulating a
    sub-ulp increment must make statistical progress instead of stalling
    at truncation (the failure that rejected plain bf16 shadow storage in
    round 2), and the long-run mean must track the true sum."""
    import jax
    from mediastreamer2_tpu.ops.aec import _sround_bf16
    n = 4096
    x = jnp.ones((n,), jnp.float32)          # bf16 ulp at 1.0 = 2^-8
    inc = jnp.float32(2.0 ** -11)            # 1/8 ulp per step
    steps = 400

    @jax.jit
    def run(x):
        def body(i, acc):
            return _sround_bf16(acc.astype(jnp.float32) + inc,
                                jnp.uint32(i))
        return jax.lax.fori_loop(0, steps, body, x.astype(jnp.bfloat16))

    got = np.asarray(run(x).astype(jnp.float32)).mean()
    want = 1.0 + float(inc) * steps           # 1.1953...
    # plain truncation (or round-to-nearest) would stay exactly 1.0
    assert abs(got - want) < 0.01, (got, want)


def test_aec_bf16_shadow_quality_parity(factory, monkeypatch):
    """The default bf16+stochastic-rounding shadow must match the f32
    shadow's converged ERLE within 2 dB and stay >15 dB — the quality
    gate attached to this bandwidth lever."""
    converged = slice(150 * S, 300 * S)
    monkeypatch.setenv("AEC_BF16_SHADOW", "0")
    _, echo32, _, out32, st32 = simulate(factory)
    assert st32["ec"]["Ws_r"].dtype == jnp.float32
    monkeypatch.setenv("AEC_BF16_SHADOW", "1")
    _, echo16, _, out16, st16 = simulate(factory)
    assert st16["ec"]["Ws_r"].dtype == jnp.bfloat16
    e32 = erle_db(echo32, out32, converged)
    e16 = erle_db(echo16, out16, converged)
    assert e16 > 15, f"bf16-shadow converged ERLE {e16:.1f} dB"
    assert e16 > e32 - 2.0, f"bf16 {e16:.1f} vs f32 {e32:.1f} dB"


def test_circular_history_exact(factory, monkeypatch):
    """The circular far-history layout (AEC_CIRC_HIST, ops/aec.py
    _circ_hist_on) is a pure BANDWIDTH change: the dynamic_slice window
    holds the same quantized blocks in the same lag order as the shift
    form, so outputs and taps must be BIT-IDENTICAL — over enough ticks
    to wrap the ring many times (P=8 for the 80 ms tail here)."""
    monkeypatch.setenv("AEC_CIRC_HIST", "0")
    _, _, _, out_shift, st_shift = simulate(factory, B=2, ticks=60)
    monkeypatch.setenv("AEC_CIRC_HIST", "1")
    _, _, _, out_circ, st_circ = simulate(factory, B=2, ticks=60)
    P = st_shift["ec"]["Wm_r"].shape[1]
    assert st_circ["ec"]["Xh_r"].shape[1] == 2 * P      # ring layout on
    assert st_shift["ec"]["Xh_r"].shape[1] == P         # shift layout off
    np.testing.assert_array_equal(out_circ, out_shift)
    for k in ("Wm_r", "Wm_i", "Ws_r", "Ws_i", "Hp"):
        np.testing.assert_array_equal(np.asarray(st_circ["ec"][k]),
                                      np.asarray(st_shift["ec"][k]))
    # the ring window equals the shift history (lag order), wrapped
    hq = int(st_circ["ec"]["hq"])           # next write slot
    q_now = (hq + 1) % P                    # this state's window start
    win = np.asarray(st_circ["ec"]["Xh_r"])[:, q_now:q_now + P]
    np.testing.assert_array_equal(win, np.asarray(st_shift["ec"]["Xh_r"]))
