"""Fused per-tick passes that XLA compiles: the volume stage's sample path
against a numpy float64 reference, and the uniform-group mixer against the
general segment-sum form."""
import numpy as np
import pytest
import jax.numpy as jnp

from mediastreamer2_tpu.ops.volume import fused_volume


def _fused_volume_f64(x, g0, g1, dc, en):
    x = x.astype(np.float64)
    S = x.shape[1]
    mean = x.mean(axis=1)
    x = x - (dc * en)[:, None]
    ramp = np.arange(S)[None, :] / S
    g = g0[:, None] * (1 - ramp) + g1[:, None] * ramp
    return np.clip(x * g, -1.0, 1.0), (x * x).mean(axis=1), mean


@pytest.mark.parametrize("S", [80, 160, 320, 480])
def test_fused_volume_matches_reference(S):
    rng = np.random.default_rng(S)
    B = 16
    x = rng.uniform(-1.2, 1.2, (B, S)).astype(np.float32)
    g0 = rng.uniform(0.1, 2.0, B).astype(np.float32)
    g1 = rng.uniform(0.1, 2.0, B).astype(np.float32)
    dc = rng.uniform(-0.1, 0.1, B).astype(np.float32)
    en = (rng.uniform(0, 1, B) > 0.5).astype(np.float32)
    y_p, e_p, m_p = fused_volume(jnp.asarray(x), jnp.asarray(g0),
                                 jnp.asarray(g1), jnp.asarray(dc),
                                 jnp.asarray(en))
    y_r, e_r, m_r = _fused_volume_f64(x, g0, g1, dc, en)
    np.testing.assert_allclose(np.asarray(y_p), y_r, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(e_p), e_r, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(m_p), m_r, rtol=1e-5, atol=1e-7)


def test_fused_volume_saturates():
    B, S = 4, 80
    x = np.full((B, S), 0.9, np.float32)
    y, e, m = fused_volume(jnp.asarray(x), jnp.full(B, 3.0, np.float32),
                           jnp.full(B, 3.0, np.float32),
                           jnp.zeros(B, np.float32),
                           jnp.zeros(B, np.float32))
    assert float(np.asarray(y).max()) <= 1.0


def test_uniform_group_mixer_matches_segment_sum(factory):
    from mediastreamer2_tpu.core.block import Format
    from mediastreamer2_tpu.core.graph import GraphBuilder
    import jax
    B, k, S = 8, 4, 80
    x = np.random.default_rng(1).uniform(-0.2, 0.2, (B, S)).astype(np.float32)

    def build(uniform):
        g = GraphBuilder(factory, batch=B)
        src = g.add("ext_source", "in", fmt=Format(rate=8000))
        kw = {"uniform_group_size": k} if uniform else {}
        m = g.add("conf_mixer", "mix", **kw)
        g.chain(src, m)
        g.link(m, 0, g.add("ext_sink", "out"), 0)
        cg = g.build()
        p = cg.init_params()
        p["mix"]["group_id"] = jnp.asarray(np.arange(B) // k, jnp.int32)
        _, out, _ = cg.step(cg.init_state(), p, {"in": x})
        return np.asarray(out["out"])

    np.testing.assert_allclose(build(True), build(False), atol=1e-6)
