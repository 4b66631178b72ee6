"""Flagship pipeline: the 48 kHz AEC+resample+mix conference leg.

The north-star configuration: every leg runs
mic -> echo cancellation (48 kHz, 80 ms tail) -> AGC volume -> polyphase
resample 48k->16k -> N-way conference mix-minus.  The graph mirrors the
reference's conference endpoint chain (audioconference.c splice of
EC'd/resampled legs into MSAudioMixer) as one batched XLA program.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from mediastreamer2_tpu.core.block import Format, tick_samples
from mediastreamer2_tpu.core.graph import GraphBuilder


def build_flagship(factory, batch: int, rate: int = 48000,
                   mix_rate: int = 16000, conf_size: int = 4,
                   tail_ms: int = 80, uniform_groups: bool = True):
    """Returns (CompiledGraph, params) with conference groups of conf_size.
    uniform_groups=False mixes with the general segment-sum (any sorted
    group_id layout, e.g. groups straddling shard boundaries)."""
    g = GraphBuilder(factory, batch=batch)
    mic = g.add("ext_source", "mic", fmt=Format(rate=rate))
    spk = g.add("ext_source", "spk_ref", fmt=Format(rate=rate))
    ec = g.add("echo_canceller", "ec", tail_ms=tail_ms)
    agc = g.add("volume", "agc")
    rs = g.add("resample", "rs", out_rate=mix_rate)
    mix = g.add("conf_mixer", "conf", sorted_groups=True,
                **({"uniform_group_size": conf_size} if uniform_groups
                   else {}))
    out = g.add("ext_sink", "out")
    g.link(mic, 0, ec, 0)
    g.link(spk, 0, ec, 1)
    g.chain(ec, agc, rs, mix, out)
    cg = g.build()
    params = cg.init_params()
    params["agc"]["agc_enabled"] = jnp.ones((batch,), bool)
    params["conf"]["group_id"] = jnp.asarray(
        np.arange(batch, dtype=np.int32) // conf_size)
    return cg, params


def example_inputs(batch: int, rate: int = 48000, seed: int = 0):
    S = tick_samples(rate)
    rng = np.random.default_rng(seed)
    return {
        "mic": (0.1 * rng.standard_normal((batch, S))).astype(np.float32),
        "spk_ref": (0.1 * rng.standard_normal((batch, S))).astype(np.float32),
    }
