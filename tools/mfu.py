"""Roofline accounting for the flagship AEC+resample+mix leg.

Computes an analytic per-tick FLOP and device-memory-byte model of the
flagship graph (the EC core dominates: 9 DFT matmuls + the [B,P,F] MDF
elementwise chain), times each piece on the GPU (a scanned program ended
by ``block_until_ready``), and reports achieved TFLOP/s and GB/s against
the card's published peaks.

Run on the GPU:  python tools/mfu.py [batch]
Outputs one JSON line per piece + a summary JSON (consumed by bench.py).
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

S = 480            # 10 ms @ 48 kHz
N2 = 960           # overlap-save block
F = 481            # rfft bins of N2
P = 8              # 80 ms tail partitions
FS = 241           # rfft bins of S (suppressor)
K_TICKS = 50

# Published peaks per card, dense (no sparsity), keyed by JAX device_kind:
#   (bf16 tensor-core FLOP/s, f32 non-tensor FLOP/s, device memory B/s).
# Sources: NVIDIA H100 Tensor Core GPU datasheet — SXM5: 989 TF bf16,
# 67 TF f32, 3.35 TB/s HBM3; PCIe: 756 TF bf16, 51 TF f32, 2.0 TB/s HBM2e.
# They assume the full power limit (700 W SXM, 350 W PCIe); report the
# card's power.limit beside any share of them.
CHIP_PEAKS = {
    "NVIDIA H100 80GB HBM3": (989e12, 67e12, 3.35e12),
    "NVIDIA H100 PCIe": (756e12, 51e12, 2.0e12),
}


def chip_peaks(kind: str = None):
    """(device_kind, peaks) for `kind` (default: the first JAX device).
    A device not in the table is an error, not a default."""
    if kind is None:
        import jax
        kind = jax.devices()[0].device_kind
    if kind not in CHIP_PEAKS:
        raise KeyError(f"no published peaks for device_kind {kind!r}; add "
                       f"it to CHIP_PEAKS with its source")
    return kind, CHIP_PEAKS[kind]


# --------------------------------------------------------------- analytic model
def flagship_flops_per_leg_tick() -> dict:
    """FLOPs per leg per tick, by stage (2 FLOP per MAC), crediting the
    ACTUAL matrix sizes issued after ops/rfft.py's structural shortcuts
    (rfft_tail/irfft_tail/apply_constraint halve the MACs):

      rfft(far, 960)      : [B,960]@[960,481] x2 (cos+sin)   — full
      irfft_tail x2       : [B,481]@[481,480] x2 each        — half (S: cols)
      rfft_tail(err)      : [B,480]@[480,481] x2             — half (h: rows)
      apply_constraint    : [B,481]@[481,481] x4             — folded [F,F]
      suppressor          : 3 DFTs at 480 pts ([480,241] x2 each)
    """
    d = {}
    d["ec_rfft_far_960"] = 2 * (2 * N2 * F)
    d["ec_irfft_tail_x2"] = 2 * (2 * (2 * F * S))
    d["ec_rfft_tail_err"] = 2 * (2 * S * F)
    d["ec_constraint_FF"] = 2 * (4 * F * F)
    d["ec_dft_480_sup"] = 2 * (3 * (2 * S * FS))
    # MDF: apply 2 filters (complex mul-sum over P*F), grad (cmul_conj),
    # NLMS update, history power, transfer wheres — ~6 complex ops over P*F
    d["ec_mdf_elem"] = 6 * 6 * P * F
    # resample 48k->16k polyphase (ops/resample.py: ~32 taps per output)
    d["resample"] = 2 * 32 * (S // 3)
    # volume + mixer + misc [B,S] elementwise
    d["misc"] = 20 * S
    d["total"] = sum(d.values())
    return d


def _shadow_itemsize() -> int:
    """Bytes per shadow-tap element in the PRODUCT path: 2 when the
    bf16+stochastic-rounding shadow is active (ops/aec.py, default on),
    4 under AEC_BF16_SHADOW=0.  The model must track the shipped dtype
    or the table silently re-bills the bandwidth the bf16 change saved."""
    try:
        from mediastreamer2_tpu.ops.aec import _bf16_shadow_on
        return 2 if _bf16_shadow_on() else 4
    except Exception:
        return 4


def flagship_bytes_per_leg_tick() -> dict:
    """Device-memory bytes per leg per tick (state read+write; activations
    that XLA cannot keep in registers across ops).  The [B,P,F] NLMS
    gradient is not billed: XLA fuses it into the tap update."""
    f32, bf16 = 4, 2
    sdt = _shadow_itemsize()                            # tracks ops/aec.py
    d = {}
    d["taps_main_read"] = 2 * P * F * bf16              # Wm r/i, read
    d["taps_shadow_rw"] = 2 * 2 * P * F * sdt           # Ws r/i, read+write
    d["far_hist_rw"] = 2 * 2 * P * F * bf16             # Xh r/i, read+write
    d["bins_vectors"] = 8 * F * f32                     # Hp, inv_norm, E, X...
    d["audio_blocks"] = 10 * S * f32                    # mic/far/e/y/out...
    d["total"] = sum(d.values())
    return d


# ------------------------------------------------------------------ measurement
def _time_scan(fn, state, repeats=3, k_ticks=None, out_info=None):
    """ms per iteration of fn scanned k_ticks times (best of `repeats`,
    timed to block_until_ready).  out_info (dict): populated with XLA
    cost-analysis bytes/FLOPs per tick for the same compiled program."""
    import jax

    k = k_ticks or K_TICKS

    @jax.jit
    def run(st):
        return jax.lax.scan(lambda s, _: (fn(s), None), st, None,
                            length=k)[0]

    compiled = run.lower(state).compile()
    if out_info is not None:
        ca = compiled.cost_analysis()
        if isinstance(ca, list):
            ca = ca[0]
        out_info["xla_bytes_per_tick"] = ca.get("bytes accessed", 0.0) / k
        out_info["xla_flops_per_tick"] = ca.get("flops", 0.0) / k
    state = jax.block_until_ready(compiled(state))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        state = jax.block_until_ready(compiled(state))
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best / k


def measure(batch: int) -> dict:
    import jax
    import jax.numpy as jnp

    res = {}
    key = jax.random.key(0)

    # --- piece 1: the PRODUCTION DFT set (post-shortcut shapes) ----------
    # Exactly the matmul inventory ops/aec.py issues per tick: full
    # rfft(far,960), two irfft_tail (basis cols S:), rfft_tail (rows h:),
    # the folded [F,F] constraint, three 480-pt suppressor DFTs.  Timed
    # with f32 and bf16 INPUTS; the basis matrices are f32 and every
    # product runs at Precision.HIGHEST (ops/rfft.py), so both rates are
    # judged against the f32 (non-tensor-core) peak.
    from mediastreamer2_tpu.ops.rfft import (rfft as _rfft,
                                             irfft_tail as _irt,
                                             rfft_tail as _rft,
                                             apply_constraint as _con,
                                             irfft as _irf)

    def dft_set(dtype):
        # CSE/composition guards: every round gets a DIFFERENT input
        # (roll) and a nonlinearity (abs) sits between transforms —
        # otherwise XLA folds dot(dot(x,A),B) into dot(x,A@B) with
        # constant A@B and CSEs identical rounds (first run of this
        # harness measured one matmul for "9 DFTs").
        def step(st):
            x, = st
            xr = x.astype(dtype)
            Fr, Fi = _rfft(xr, N2)                       # far spectrum
            Fr, Fi = jnp.abs(Fr), jnp.abs(Fi)
            y1 = _irt(Fr.astype(dtype), Fi.astype(dtype), N2)   # main
            y2 = _irt(jnp.roll(Fr, 1, 1).astype(dtype),
                      jnp.roll(Fi, 1, 1).astype(dtype), N2)     # shadow
            Er, Ei = _rft(jnp.abs(y1 - y2).astype(dtype), N2)   # err spec
            Gr, Gi = _con(jnp.abs(Er).astype(dtype),
                          jnp.abs(Ei).astype(dtype), N2)        # constraint
            h = (x[:, :S] + y1 * 1e-6).astype(dtype)
            H1r, H1i = _rfft(h, S)
            H2r, H2i = _rfft(jnp.roll(h, 1, 1), S)
            y3 = _irf(jnp.abs(H1r + H2r).astype(dtype),
                      jnp.abs(H1i + H2i).astype(dtype), S)
            y = (x + Gr.sum(1, keepdims=True) * 1e-7
                 + jnp.pad(y3, ((0, 0), (0, S))) * 1e-6)
            return (y,)
        return step

    x0 = 0.1 * jax.random.normal(key, (batch, N2), jnp.float32)
    res["dft_prod_f32in_ms"] = _time_scan(dft_set(jnp.float32), (x0,))
    res["dft_prod_bf16in_ms"] = _time_scan(dft_set(jnp.bfloat16), (x0,))

    # --- piece 2: MDF elementwise chain over [B,P,F] ----------------------
    # Shadow taps stored at the PRODUCT dtype (bf16 by default since the
    # stochastic-rounding change in ops/aec.py; f32 under
    # AEC_BF16_SHADOW=0).
    sdt = jnp.bfloat16 if _shadow_itemsize() == 2 else jnp.float32

    def mdf_elem(st):
        Wm_r, Wm_i, Ws_r, Ws_i, Xh_r, Xh_i, Er, Ei, inv_norm = st
        Xh_r2 = jnp.concatenate([Er[:, None, :].astype(jnp.bfloat16),
                                 Xh_r[:, :-1]], axis=1)
        Xh_i2 = jnp.concatenate([Ei[:, None, :].astype(jnp.bfloat16),
                                 Xh_i[:, :-1]], axis=1)
        xr = Xh_r2.astype(jnp.float32)
        xi = Xh_i2.astype(jnp.float32)
        Ym_r = jnp.sum(Wm_r.astype(jnp.float32) * xr
                       - Wm_i.astype(jnp.float32) * xi, axis=1)
        Ys_r = jnp.sum(Ws_r.astype(jnp.float32) * xr
                       - Ws_i.astype(jnp.float32) * xi, axis=1)
        Gr = (xr * Er[:, None, :] + xi * Ei[:, None, :]) * inv_norm[:, None, :]
        Gi = (xr * Ei[:, None, :] - xi * Er[:, None, :]) * inv_norm[:, None, :]
        Ws_r2 = (Ws_r.astype(jnp.float32) + 0.5 * Gr).astype(sdt)
        Ws_i2 = (Ws_i.astype(jnp.float32) + 0.5 * Gi).astype(sdt)
        return (Wm_r, Wm_i, Ws_r2, Ws_i2, Xh_r2, Xh_i2,
                Ym_r * 1e-6 + Er, Ys_r * 1e-6 + Ei, inv_norm)

    zb = lambda: jnp.zeros((batch, P, F), jnp.bfloat16)
    zs = lambda: jnp.zeros((batch, P, F), sdt)
    vf = lambda k: 0.01 * jax.random.normal(jax.random.key(k), (batch, F),
                                            jnp.float32)
    st0 = (zb(), zb(), zs(), zs(), zb(), zb(), vf(1), vf(2),
           jnp.ones((batch, F), jnp.float32))
    info = {}
    res["mdf_elem_ms"] = _time_scan(mdf_elem, st0, out_info=info)
    res["mdf_elem_xla_bytes_per_tick"] = info.get("xla_bytes_per_tick")

    # --- piece 3: pure memory stream over the same state footprint -------
    # factor must be exact in bf16 (1.0001 rounds to 1.0 and XLA deletes
    # the whole op)
    def stream(st):
        return tuple(x * 1.0625 for x in st)
    res["hbm_stream_ms"] = _time_scan(stream, st0)

    # --- piece 4: full flagship + no_suppress variant ---------------------
    from mediastreamer2_tpu.core.factory import Factory
    from mediastreamer2_tpu.core.graph import GraphBuilder
    from mediastreamer2_tpu.core.block import Format
    from mediastreamer2_tpu.models.flagship import build_flagship

    def time_graph(cg, params, out_info=None):
        state = cg.init_state()
        mic0 = 0.1 * jax.random.normal(key, (batch, S), jnp.float32)
        names = list(cg.ext_inputs)

        def step(carry):
            st, t = carry
            ext = {n: jnp.roll(mic0, t + 7 * i, axis=1)
                   for i, n in enumerate(names)}
            st, out, _ = cg.step(st, params, ext)
            return (st, t + 1)
        return _time_scan(step, (state, jnp.asarray(0, jnp.int32)),
                          out_info=out_info)

    cg, params = build_flagship(Factory(), batch=batch)
    info = {}
    res["flagship_ms"] = time_graph(cg, params, out_info=info)
    res["flagship_xla_bytes_per_tick"] = info.get("xla_bytes_per_tick")
    res["flagship_xla_flops_per_tick"] = info.get("xla_flops_per_tick")

    def build_nosup():
        g = GraphBuilder(Factory(), batch=batch)
        mic = g.add("ext_source", "mic", fmt=Format(rate=48000))
        spk = g.add("ext_source", "spk_ref", fmt=Format(rate=48000))
        ec = g.add("echo_canceller", "ec", tail_ms=80, no_suppress=True)
        agc = g.add("volume", "agc")
        rs = g.add("resample", "rs", out_rate=16000)
        mix = g.add("conf_mixer", "conf", sorted_groups=True,
                    uniform_group_size=4)
        out = g.add("ext_sink", "out")
        g.link(mic, 0, ec, 0)
        g.link(spk, 0, ec, 1)
        g.chain(ec, agc, rs, mix, out)
        cg2 = g.build()
        pr = cg2.init_params()
        pr["conf"]["group_id"] = jnp.asarray(
            np.arange(batch, dtype=np.int32) // 4)
        return cg2, pr
    res["flagship_nosup_ms"] = time_graph(*build_nosup())

    # --- piece 5: attribution — where does the whole tick go? ------------
    # Ablation graphs (fused, like production) + per-node isolation.
    # ec_only strips AGC/resample/mix; no_ec strips the canceller;
    # suppressor = flagship - nosup.
    def build_ec_only():
        g = GraphBuilder(Factory(), batch=batch)
        mic = g.add("ext_source", "mic", fmt=Format(rate=48000))
        spk = g.add("ext_source", "spk_ref", fmt=Format(rate=48000))
        ec = g.add("echo_canceller", "ec", tail_ms=80, no_suppress=True)
        out = g.add("ext_sink", "out")
        g.link(mic, 0, ec, 0)
        g.link(spk, 0, ec, 1)
        g.chain(ec, out)
        cg2 = g.build()
        return cg2, cg2.init_params()

    def build_no_ec():
        g = GraphBuilder(Factory(), batch=batch)
        mic = g.add("ext_source", "mic", fmt=Format(rate=48000))
        agc = g.add("volume", "agc")
        rs = g.add("resample", "rs", out_rate=16000)
        mix = g.add("conf_mixer", "conf", sorted_groups=True,
                    uniform_group_size=4)
        out = g.add("ext_sink", "out")
        g.link(mic, 0, agc, 0)
        g.chain(agc, rs, mix, out)
        cg2 = g.build()
        pr = cg2.init_params()
        pr["conf"]["group_id"] = jnp.asarray(
            np.arange(batch, dtype=np.int32) // 4)
        return cg2, pr

    info = {}
    res["ec_only_nosup_ms"] = time_graph(*build_ec_only(), out_info=info)
    res["ec_only_xla_bytes_per_tick"] = info.get("xla_bytes_per_tick")
    try:
        res["no_ec_chain_ms"] = time_graph(*build_no_ec())
    except Exception as e:                          # noqa: BLE001
        print(f"# no_ec variant failed: {type(e).__name__}: {str(e)[:80]}",
              file=sys.stderr)
    ext = {"mic": 0.1 * np.random.default_rng(0).standard_normal(
               (batch, S)).astype(np.float32),
           "spk_ref": 0.1 * np.random.default_rng(1).standard_normal(
               (batch, S)).astype(np.float32)}
    res["per_node_ms"] = {k: round(v, 3) for k, v in cg.profile_nodes(
        cg.init_state(), params, ext_in=ext, iters=3).items()}
    return res


def summarize(batch: int, res: dict, kind: str = None) -> dict:
    kind, (peak_bf16, peak_f32, peak_mem) = chip_peaks(kind)
    fl = flagship_flops_per_leg_tick()
    by = flagship_bytes_per_leg_tick()
    dft_flops = (fl["ec_rfft_far_960"] + fl["ec_irfft_tail_x2"]
                 + fl["ec_rfft_tail_err"] + fl["ec_constraint_FF"]
                 + fl["ec_dft_480_sup"]) * batch
    mdf_bytes = by["total"] * batch
    out = {
        "device_kind": kind, "batch": batch,
        # every DFT product is f32 at Precision.HIGHEST (ops/rfft.py): no
        # TF32, so matmul rates are judged against the f32 peak
        "matmul_precision": "f32 HIGHEST",
        "flops_per_leg_tick": fl, "bytes_per_leg_tick": by,
        "pieces": {k: (round(v, 3) if isinstance(v, float) else v)
                   for k, v in res.items()},
    }

    def rate(flops, ms):
        return flops / (ms * 1e-3) if ms and ms > 0 else 0.0
    out["dft_prod_f32in_tflops"] = round(
        rate(dft_flops, res["dft_prod_f32in_ms"]) / 1e12, 1)
    out["dft_prod_bf16in_tflops"] = round(
        rate(dft_flops, res["dft_prod_bf16in_ms"]) / 1e12, 1)
    out["dft_prod_f32in_util_vs_f32_peak"] = round(
        rate(dft_flops, res["dft_prod_f32in_ms"]) / peak_f32, 3)
    out["dft_prod_bf16in_util_vs_f32_peak"] = round(
        rate(dft_flops, res["dft_prod_bf16in_ms"]) / peak_f32, 3)
    out["mdf_elem_GBps"] = round(rate(mdf_bytes, res["mdf_elem_ms"]) / 1e9, 1)
    out["mdf_elem_bw_util"] = round(rate(mdf_bytes, res["mdf_elem_ms"])
                                    / peak_mem, 3)
    # stream footprint: 4 bf16 + 2 shadow-dtype [B,P,F] tensors + 3 f32
    # [B,F], r+w — the shadow itemsize must track ops/aec.py or the util
    # reads > 1
    stream_bytes = batch * 2 * (P * F * (4 * 2 + 2 * _shadow_itemsize())
                                + 3 * F * 4)
    out["hbm_stream_GBps"] = round(
        rate(stream_bytes, res["hbm_stream_ms"]) / 1e9, 1)
    out["hbm_stream_util"] = round(
        rate(stream_bytes, res["hbm_stream_ms"]) / peak_mem, 3)
    # whole-flagship: analytic FLOPs (actual issued matrix sizes) over
    # measured time vs the f32 peak, + bandwidth util
    t = res["flagship_ms"]
    out["flagship_analytic_gflops_per_tick"] = round(fl["total"] * batch / 1e9, 1)
    out["flagship_tflops"] = round(rate(fl["total"] * batch, t) / 1e12, 2)
    out["flagship_util_vs_f32_peak"] = round(
        rate(fl["total"] * batch, t) / peak_f32, 4)
    out["flagship_mem_util"] = round(rate(by["total"] * batch, t)
                                     / peak_mem, 3)
    # XLA's cost_analysis() bytes/FLOPs stay in `pieces` for reference;
    # no utilization is derived from them (they count intermediates that
    # fusion never writes).
    # attribution: ablation deltas must cover ~the whole tick
    attr = {}
    if "flagship_nosup_ms" in res:
        attr["suppressor_ms"] = round(t - res["flagship_nosup_ms"], 3)
    if "ec_only_nosup_ms" in res:
        attr["ec_core_ms"] = round(res["ec_only_nosup_ms"], 3)
    if "no_ec_chain_ms" in res:
        attr["agc_resample_mix_ms"] = round(res["no_ec_chain_ms"], 3)
    if attr:
        covered = sum(attr.values())
        attr["sum_ms"] = round(covered, 3)
        attr["flagship_ms"] = round(t, 3)
        attr["unattributed_ms"] = round(t - covered, 3)
        attr["coverage"] = round(covered / t, 3) if t else None
    out["attribution"] = attr
    return out


def main():
    import jax
    from mediastreamer2_tpu import enable_compile_cache
    enable_compile_cache()
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 8192
    dev = jax.devices()[0]
    chip_peaks(dev.device_kind)                     # fail before measuring
    print(f"# device={dev.device_kind} batch={batch}", file=sys.stderr)
    res = measure(batch)
    for k, v in res.items():
        if isinstance(v, (int, float)):
            unit = ("bytes/tick" if "bytes" in k
                    else "flops/tick" if "flops" in k else "ms/tick")
            print(f"# {k}: {v:.3f} {unit}", file=sys.stderr)
        else:
            print(f"# {k}: {v}", file=sys.stderr)
    print(json.dumps(summarize(batch, res, dev.device_kind)))


if __name__ == "__main__":
    main()
