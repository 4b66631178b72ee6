"""Device-vs-CPU correctness of the flagship leg, in one process.

Runs the identical flagship graph (48 kHz AEC + AGC + resample + conference
mix-minus, models/flagship.py) for T ticks on the accelerator and on the
host CPU backend of the same JAX process, with the same seeded,
echo-coupled inputs, and compares the mixed output streams.

Why a quality bar and not samplewise equality: sums run in another order on
each backend, and the AEC's discrete two-path transfer (shadow->main
promotion after an 8-tick sustained-improvement count, reseed, hard reset)
can then fire on another tick.  That leg's residual takes a different
(equally valid) trajectory, and the mix-minus spreads it to its
groupmates.  The bar:

* every leg: RMS error <= 5e-3 and output energy within 1.5 dB of the CPU
  (a backend with worse echo cancellation fails the energy gate);
* every leg whose conference group took the same transfer decisions on
  both backends (the AEC's ``xfer`` record, compared tick by tick):
  waveform similarity (audio_diff) >= 0.999;
* at most a quarter of the groups may take other decisions (a backend
  whose arithmetic is off diverges in most of them).

The spectral building blocks (ops/rfft.py) and the polyphase resampler are
also checked against numpy float64 at the tick sizes, to 1e-4 of the
signal RMS: that is what f32 at ``Precision.HIGHEST`` holds (~1e-6), and
what a TF32 matmul (~1e-3) would miss.
"""
from __future__ import annotations

import numpy as np

AUDIO_DIFF_MIN = 0.999
RMS_ERR_MAX = 5e-3
ENERGY_GAP_DB_MAX = 1.5
DIVERGED_GROUPS_MAX = 0.25
CONF_SIZE = 4               # models/flagship.py default
SPECTRAL_REL_TOL = 1e-4
SPECTRAL_SIZES = (160, 320, 640, 960)
RESAMPLE_PAIRS = ((8000, 48000), (48000, 8000), (48000, 16000))


def flagship_inputs(batch: int, ticks: int, seed: int = 7, rate: int = 48000):
    """Seeded far end + echo-coupled mic (so the AEC adapts): [T, B, S]."""
    S = rate // 100
    rng = np.random.default_rng(seed)
    far = (0.2 * rng.standard_normal((batch, ticks * S))).astype(np.float32)
    near = (0.05 * rng.standard_normal((batch, ticks * S))).astype(np.float32)
    mic = (near + 0.5 * np.roll(far, 400, axis=1)).astype(np.float32)
    tb = lambda a: np.ascontiguousarray(
        a.reshape(batch, ticks, S).transpose(1, 0, 2))
    return tb(mic), tb(far)


def run_flagship(device, mic, far):
    """T ticks of the flagship graph on `device` as one scanned program;
    returns the mixed output [B, T * S_out] and the AEC's per-tick
    transfer decisions [B, T]."""
    import jax
    import jax.numpy as jnp
    from mediastreamer2_tpu.core.factory import Factory
    from mediastreamer2_tpu.models.flagship import build_flagship

    ticks, batch, _ = mic.shape
    with jax.default_device(device):
        cg, params = build_flagship(Factory(), batch=batch)
        state = cg.init_state()

        def body(st, xs):
            m, f = xs
            st, out, _ = cg.step(st, params, {"mic": m, "spk_ref": f})
            return st, (out["out"], st["ec"]["xfer"])

        @jax.jit
        def run(st, m, f):
            return jax.lax.scan(body, st, (m, f))[1]

        outs, xfer = run(state, jnp.asarray(mic), jnp.asarray(far))
    outs = np.asarray(outs).transpose(1, 0, 2).reshape(batch, -1)
    return outs, np.asarray(xfer).T


def quality_gate(ref: np.ndarray, got: np.ndarray, ref_xfer=None,
                 got_xfer=None, conf_size: int = CONF_SIZE) -> dict:
    """Compare two [B, samples] output streams against the quality bar.
    ref_xfer/got_xfer: [B, T] AEC transfer decisions (None: all agree)."""
    from mediastreamer2_tpu.utils.audiodiff import audio_diff
    B = ref.shape[0]
    sims = np.array([audio_diff(ref[i], got[i])[0] for i in range(B)])
    same = (np.ones(B, bool) if ref_xfer is None
            else (ref_xfer == got_xfer).all(axis=1))
    group_same = same.reshape(-1, conf_size).all(axis=1)
    agree = np.repeat(group_same, conf_size)
    err = np.abs(ref.astype(np.float64) - got)
    rms = float(np.sqrt(np.mean(err ** 2)))
    # per-leg energy over the converged second half
    half = ref.shape[1] // 2
    e_ref = (ref[:, half:].astype(np.float64) ** 2).mean(axis=1) + 1e-12
    e_got = (got[:, half:].astype(np.float64) ** 2).mean(axis=1) + 1e-12
    gap_db = float(np.abs(10 * np.log10(e_ref / e_got)).max())
    sim_agree = float(sims[agree].min()) if agree.any() else 1.0
    diverged = 1.0 - float(group_same.mean())
    return {"audio_diff_min": float(sims.min()),
            "audio_diff_min_same_decisions": sim_agree,
            "diverged_group_share": diverged,
            "rms_err": rms,
            "max_abs_err": float(err.max()),
            "energy_gap_db_max": gap_db,
            "pass": bool(sim_agree >= AUDIO_DIFF_MIN and rms <= RMS_ERR_MAX
                         and gap_db <= ENERGY_GAP_DB_MAX
                         and diverged <= DIVERGED_GROUPS_MAX)}


def _rel(got, want) -> float:
    """RMS of the error over RMS of the float64 reference."""
    got = np.asarray(got, np.complex128)
    want = np.asarray(want, np.complex128)
    scale = np.sqrt(np.mean(np.abs(want) ** 2)) + 1e-30
    return float(np.sqrt(np.mean(np.abs(got - want) ** 2)) / scale)


def _resample_f64(x_ticks, R, H):
    """The resample filter's tick loop in float64: [T, B, n_in] -> out."""
    hist = np.zeros((x_ticks.shape[1], H))
    outs = []
    for x in x_ticks.astype(np.float64):
        x_ext = np.concatenate([hist, x], axis=1)
        outs.append(x_ext @ R.T)
        hist = x_ext[:, -H:]
    return np.stack(outs)


def spectral_errors(device, batch: int = 64, seed: int = 3) -> dict:
    """Relative RMS error of every ops/rfft.py transform at the tick sizes,
    and of the resample filter over a few ticks, against numpy float64."""
    import jax
    from mediastreamer2_tpu.core.block import Format, tick_samples
    from mediastreamer2_tpu.core.factory import Factory
    from mediastreamer2_tpu.core.graph import GraphBuilder
    from mediastreamer2_tpu.ops import rfft as R
    from mediastreamer2_tpu.ops.resample import resample_matrix

    rng = np.random.default_rng(seed)
    cplx = lambda p: np.asarray(p[0]) + 1j * np.asarray(p[1])
    errs = {}
    with jax.default_device(device):
        for n in SPECTRAL_SIZES:
            h = n // 2
            x = rng.standard_normal((batch, n)).astype(np.float32)
            x64 = x.astype(np.float64)
            errs[f"rfft_{n}"] = _rel(
                cplx(jax.jit(lambda a: R.rfft(a, n))(x)), np.fft.rfft(x64))
            errs[f"rfft_tail_{n}"] = _rel(
                cplx(jax.jit(lambda a: R.rfft_tail(a, n))(x[:, :h])),
                np.fft.rfft(np.pad(x64[:, :h], ((0, 0), (h, 0)))))
            # the inverse transforms take the same f32 spectrum both sides
            X = np.fft.rfft(x64).astype(np.complex64)
            xr, xi = X.real.copy(), X.imag.copy()
            t = np.fft.irfft(X.astype(np.complex128), n)
            errs[f"irfft_{n}"] = _rel(
                jax.jit(lambda r, i: R.irfft(r, i, n))(xr, xi), t)
            errs[f"irfft_tail_{n}"] = _rel(
                jax.jit(lambda r, i: R.irfft_tail(r, i, n))(xr, xi), t[:, h:])
            t[:, h:] = 0.0
            errs[f"apply_constraint_{n}"] = _rel(
                cplx(jax.jit(lambda r, i: R.apply_constraint(r, i, n))(
                    xr, xi)), np.fft.rfft(t))
        for rin, rout in RESAMPLE_PAIRS:
            g = GraphBuilder(Factory(), batch=batch)
            g.chain(g.add("ext_source", "in", fmt=Format(rate=rin)),
                    g.add("resample", "rs", out_rate=rout),
                    g.add("ext_sink", "out"))
            cg = g.build()
            xs = rng.standard_normal(
                (4, batch, tick_samples(rin))).astype(np.float32)

            def body(st, x, cg=cg):
                st, out, _ = cg.step(st, {}, {"in": x})
                return st, out["out"]

            got = jax.jit(lambda st, x: jax.lax.scan(body, st, x)[1])(
                cg.init_state(), xs)
            R_np, H, _ = resample_matrix(rin, rout)
            errs[f"resample_{rin}_{rout}"] = _rel(
                got, _resample_f64(xs, R_np.astype(np.float64), H))
    return errs


def device_vs_cpu(device=None, batch: int = 256, ticks: int = 100,
                  spectral_batch: int = 64) -> dict:
    """The whole check: flagship quality bar + spectral/resampler errors.
    `device` defaults to jax.devices()[0]; the reference is the CPU."""
    import jax
    device = device or jax.devices()[0]
    cpu = jax.devices("cpu")[0]
    mic, far = flagship_inputs(batch, ticks)
    ref, ref_x = run_flagship(cpu, mic, far)
    got, got_x = run_flagship(device, mic, far)
    res = quality_gate(ref, got, ref_x, got_x)
    res.update(batch=batch, ticks=ticks, device=str(device))
    spec = spectral_errors(device, batch=spectral_batch)
    res["spectral_rel_err"] = spec
    res["spectral_rel_err_max"] = max(spec.values())
    res["pass"] = bool(res["pass"]
                       and res["spectral_rel_err_max"] <= SPECTRAL_REL_TOL)
    return res
