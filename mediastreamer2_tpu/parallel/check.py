"""Sharded-flagship checks on a device mesh (virtual CPU devices or GPUs).

What leg sharding must preserve, checked on whatever devices it is given:

1. the flagship step sharded over the ``legs`` axis equals the unsharded
   step on one device;
2. conference mix-minus is exact when groups span shard boundaries (the
   segment-sum becomes a cross-device collective);
3. a second shape-class graph (8 kHz G.711 legs) stepped interleaved with
   the flagship on the same mesh stays exact;
4. the served path: one native SRTP edge per shard (sendmmsg tx,
   recvmmsg + jitter ring rx, self-looped over localhost UDP) feeds the
   sharded codec-boundary e2e step, and the ring delivers exactly what
   the devices sent.
"""
from __future__ import annotations

import socket
import time

import numpy as np

# sharded vs unsharded f32 on one backend: same kernels, other partitioned
# shapes, so the library may pick other algorithms — sums in another order
STEP_ATOL = 1e-4


def _dc_mix_minus(step, cg, params, batch, mesh, shard_tree):
    """Distinct per-leg DC levels: leg i must hear its group's sum minus
    itself.  Returns (got, want) per leg after the resampler settles."""
    dc = 0.002 * (1.0 + np.arange(batch, dtype=np.float32) % 64)  # no clip
    ext = shard_tree({"mic": np.repeat(dc[:, None], 480, axis=1),
                      "spk_ref": np.zeros((batch, 480), np.float32)},
                     mesh, batch)
    st = shard_tree(cg.init_state(), mesh, batch)
    pr = shard_tree(params, mesh, batch)
    out = None
    for _ in range(4):                       # let the resampler settle on DC
        st, out, _ = step(st, pr, ext)
    got = np.asarray(out["out"])[:, -40:].mean(axis=1)
    gid = np.asarray(params["conf"]["group_id"])
    sums = np.bincount(gid, weights=dc.astype(np.float64))
    return got, sums[gid] - dc


def check_sharded(devices, batch: int) -> dict:
    """Run checks 1-4 over `devices`; raises AssertionError on a failure.
    `batch` must be a multiple of 4 * len(devices)."""
    import jax
    import jax.numpy as jnp
    from mediastreamer2_tpu.core.block import Format
    from mediastreamer2_tpu.core.factory import Factory
    from mediastreamer2_tpu.core.graph import GraphBuilder
    from mediastreamer2_tpu.models.flagship import (build_flagship,
                                                    example_inputs)
    from mediastreamer2_tpu.parallel.sharding import make_mesh, shard_tree

    n = len(devices)
    assert batch % (4 * n) == 0, (batch, n)
    mesh = make_mesh(devices=list(devices))
    res = {"devices": n, "batch": batch}

    # (1) sharded step == unsharded step on one device
    cg, params = build_flagship(Factory(), batch=batch, conf_size=4)
    state = cg.init_state()
    ext = example_inputs(batch, seed=7)
    one = jax.device_put((state, params, ext), devices[0])
    _, ref_out, _ = jax.jit(cg.step)(*one)
    step = jax.jit(cg.step)
    _, sh_out, _ = step(shard_tree(state, mesh, batch),
                        shard_tree(params, mesh, batch),
                        shard_tree(ext, mesh, batch))
    err = float(np.abs(np.asarray(ref_out["out"])
                       - np.asarray(sh_out["out"])).max())
    res["sharded_vs_unsharded_max_abs"] = err
    assert err <= STEP_ATOL, f"sharded != unsharded: {err}"

    # (2) cross-shard mix-minus: groups of 4 offset by 2 legs, so a group
    # straddles every shard boundary (segment-sum mixer; AGC off for a
    # deterministic gain)
    cg_x, pr_x = build_flagship(Factory(), batch=batch, conf_size=4,
                                uniform_groups=False)
    pr_x["conf"]["group_id"] = jnp.asarray(
        (np.arange(batch, dtype=np.int32) + 2) // 4)
    pr_x["agc"]["agc_enabled"] = jnp.zeros((batch,), bool)
    got, want = _dc_mix_minus(jax.jit(cg_x.step), cg_x, pr_x, batch, mesh,
                              shard_tree)
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    res["cross_shard_mix_minus_rel_err"] = rel
    np.testing.assert_allclose(got, want, rtol=0.05)

    # (3) a co-resident G.711 class interleaved with the flagship class
    g2 = GraphBuilder(Factory(), batch=batch)
    g2.chain(g2.add("ext_source", "in8k", fmt=Format(rate=8000)),
             g2.add("ulaw_enc"), g2.add("ulaw_dec"),
             g2.add("ext_sink", "out8k"))
    cg2 = g2.build()
    st2 = shard_tree(cg2.init_state(), mesh, batch)
    pr2 = shard_tree(cg2.init_params(), mesh, batch)
    step2 = jax.jit(cg2.step)
    sig = (0.25 * np.sin(2 * np.pi * 440 / 8000
                         * np.arange(80))).astype(np.float32)
    ext2 = shard_tree({"in8k": np.tile(sig, (batch, 1))}, mesh, batch)
    st_f = shard_tree(state, mesh, batch)
    pr_f = shard_tree(params, mesh, batch)
    ext_f = shard_tree(ext, mesh, batch)
    out2 = None
    for _ in range(3):
        st_f, _, _ = step(st_f, pr_f, ext_f)
        st2, out2, _ = step2(st2, pr2, ext2)
    g711_err = float(np.abs(np.asarray(out2["out8k"]) - sig).max())
    res["coresident_g711_max_abs"] = g711_err
    assert g711_err < 0.02, f"co-resident G.711 class diverged: {g711_err}"

    # (4) per-shard native SRTP edge feeding the sharded e2e step
    res["edge"] = _check_edge(mesh, batch)
    return res


def _check_edge(mesh, batch: int) -> str:
    import jax
    import jax.numpy as jnp
    from mediastreamer2_tpu.core.factory import Factory
    from mediastreamer2_tpu.models.e2e_bench import build_e2e_graph
    from mediastreamer2_tpu.native import (rtp_edge_available, BatchRtpTx,
                                           BatchRtpRx)
    from mediastreamer2_tpu.ops.g711 import (ulaw_decode, ulaw_encode,
                                             float_to_pcm16, pcm16_to_float)
    from mediastreamer2_tpu.parallel.sharding import shard_tree
    if not rtp_edge_available():
        return "native edge unavailable"
    n_dev = mesh.devices.size
    per = batch // n_dev
    cg, params = build_e2e_graph(Factory(), batch, conf_size=4)
    state = shard_tree(cg.init_state(), mesh, batch)
    params = shard_tree(params, mesh, batch)

    def step(st, pr, rx_u8, mic):
        dec = pcm16_to_float(ulaw_decode(rx_u8.astype(jnp.int32)))
        st, out, _ = cg.step(st, pr, {"rx": dec, "mic": mic})
        return st, ulaw_encode(float_to_pcm16(out["out"])).astype(jnp.uint8)

    jstep = jax.jit(step)
    edges = []
    key_rng = np.random.default_rng(42)
    for s in range(n_dev):                   # one netstack per device
        txs = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        txs.bind(("127.0.0.1", 0))
        rxs = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        rxs.bind(("127.0.0.1", 0))
        rxs.setblocking(False)
        for sk in (txs, rxs):
            try:
                sk.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 24)
                sk.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 1 << 24)
            except OSError:
                pass
        port = rxs.getsockname()[1]
        tx = BatchRtpTx(txs, per, 80)
        rx = BatchRtpRx(per, 80, ring_depth=16)
        rx.add_socket(rxs, gro=True)
        for i in range(per):
            mk, ms = key_rng.bytes(16), key_rng.bytes(14)
            tx.config(i, "127.0.0.1", port, ssrc=s * per + i, pt=0)
            rx.map_ssrc(s * per + i, i)
            rx.set_prefill(i, 0)
            tx.set_srtp(i, mk, ms)
            rx.set_srtp(i, mk, ms)
        tx.enable_gso(("127.0.0.1", port))
        edges.append((tx, rx, txs, rxs))
    mic = (0.1 * np.random.default_rng(7)
           .standard_normal((batch, 480))).astype(np.float32)
    mic_s = shard_tree({"m": mic}, mesh, batch)["m"]
    cur = np.full((batch, 80), 0xFF, np.uint8)
    prev_tx = None
    try:
        for _ in range(4):
            for s, (tx, rx, *_x) in enumerate(edges):
                tx.send(cur[s * per:(s + 1) * per], ts_inc=80)
            stage = np.empty((batch, 80), np.uint8)
            for s, (tx, rx, *_x) in enumerate(edges):
                got, deadline = 0, time.monotonic() + 2.0
                while got < per and time.monotonic() < deadline:
                    got += rx.poll()         # the whole tick, or time out
                    if got < per:
                        time.sleep(0.002)
                pay, fl = rx.read_tick()
                assert fl.all(), "localhost self-loop dropped packets"
                stage[s * per:(s + 1) * per] = pay
            if prev_tx is not None:          # ring delivers exactly what
                np.testing.assert_array_equal(stage, prev_tx)  # was sent
            rx_s = shard_tree({"x": stage}, mesh, batch)["x"]
            state, tx_pay = jstep(state, params, rx_s, mic_s)
            prev_tx = np.asarray(tx_pay)
            cur = prev_tx
    finally:
        for tx, rx, s1, s2 in edges:
            tx.close()
            rx.close()
            s1.close()
            s2.close()
    return "ok"
