"""Acoustic echo canceller — batched two-path partitioned-block FDAF.

Reference: MSSpeexEC wraps speexdsp's MDF adaptive filter + preprocess
denoiser (src/audiofilters/speexec.c:395-412; 64-sample frames, state blob
serialization at :119-150).  The algorithm family is the same here —
multi-delay-block frequency-domain adaptive filter (NLMS in the frequency
domain, overlap-save) — but re-architected as one batched device step:

* block size = one 10 ms tick (not 64 samples): fewer, bigger transforms;
* all spectra are **real (re, im) float pairs** and every DFT is a constant
  cos/sin **matmul** (ops/rfft.py) — no complex dtype, no FFT primitive;
* every leg adapts in parallel as a batch dim — [B, P, F] tap tensors, so
  thousands of echo cancellers run as a handful of fused XLA ops per tick;
* double-talk robustness via the classic **two-path** scheme: a *shadow*
  filter adapts with a fast unguarded NLMS step and is promoted into the
  *main* (filtering) path only on sustained, near-power-gated improvement;
  a diverged shadow is re-seeded from main. All transfer logic is per-leg
  masked `where` — no branches;
* a spectral residual-echo suppressor (over-subtraction scaled by a
  min-statistics leak estimate) replaces the speex-preprocess stage.

State serialization parity (speexec.c:119-150): the whole state pytree is
arrays — `get_state_blob`/`set_state_blob` round-trip it for warm restart.

Inputs: pin 0 = near-end (mic), pin 1 = far-end reference (speaker).
Output: echo-cancelled near-end.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from mediastreamer2_tpu.core.filter import FilterDef, register_filter
from mediastreamer2_tpu.ops.rfft import (rfft, irfft, rfft_tail, irfft_tail,
                                         apply_constraint, cmul, cmul_conj,
                                         cabs2)

DEFAULT_TAIL_MS = 80
MU = 0.6               # shadow NLMS step
ERR_EWMA = 0.6         # error-energy smoothing for transfer logic
COPY_RATIO = 0.4       # shadow must (sustainably) halve the error -> promote
ERLE_GATE = 0.2       # ...and cancel >=6 dB of the mic signal (blocks
                       # promotion during double-talk, when the best any
                       # filter can do is leave the near speech intact)
RESET_RATIO = 1.5      # shadow (sustainably) worse than main -> re-seed
HOLD_TICKS = 8         # hysteresis: condition must hold 50 ms
SUPPRESS_BETA = 2.5    # over-subtraction factor (on the *residual* estimate)
SUPPRESS_FLOOR = 0.15  # spectral floor (limits musical noise / distortion)
LEAK_RISE = 1.01       # min-statistics leak tracker creep-up per tick


def _partitions(ctx):
    tail_ms = int(ctx.params.get("tail_ms", DEFAULT_TAIL_MS))
    return max(1, -(-tail_ms // 10))       # ceil(tail / tick)


def _padded_bins(S: int) -> int:
    """Frequency-axis storage size: the natural S + 1 rfft bins. The
    padding plumbing in _aec_process stays (F_pad=0)."""
    return S + 1


# HBM layout: the chain is bandwidth-bound on the six [B,P,F] tensors.
# The MAIN taps are only read (written on rare promotes) and the far-end
# history is shifted wholesale every tick — both tolerate bf16 storage
# (compute upcasts to f32), halving their traffic. The SHADOW taps
# accumulate mu*G every tick and need stochastic rounding in bf16 (below):
# plain bf16 accumulation stalls once updates drop under one ulp. ERLE is
# unchanged (tests assert >15 dB).
STORE_DTYPE = jnp.bfloat16

# Gate the main-tap rewrite on any(promote) (lax.cond). A/B knob, default
# off; not measured on the GPU.
import os as _os
_COND_PROMOTE = _os.environ.get("AEC_COND_PROMOTE", "0") != "0"

# bf16 SHADOW taps with stochastic rounding (bandwidth lever): the shadow
# read-modify-write is the tick's top byte-mover (61.6 KB/leg-tick
# modeled, tools/mfu.py).  Plain bf16 shadow storage stalls NLMS
# accumulation once per-tick updates drop under one bf16 ulp (2^-8
# relative).  Stochastic rounding
# removes the stall: add a uniform 16-bit value to the f32 bit pattern's
# discarded mantissa bits before truncating, so a sub-ulp update is
# applied with probability proportional to its size — unbiased in
# expectation (the standard bf16-training recipe; NLMS is itself a noisy
# gradient method, so the added variance is in-family).  The PRNG is a
# counter+index integer hash: exact on every backend, so CPU and GPU
# produce bit-identical rounding decisions (device-vs-CPU check,
# models/device_check.py).
# Active only on the default update path: the half-update knob path
# assumes f32 shadow storage and stays that way.
def _bf16_shadow_on() -> bool:
    """Read at STATE-INIT time (the knob envs are runtime-toggled in
    tests); the created state's Ws dtype then drives the process path,
    so a state outlives any later env flips."""
    return (_os.environ.get("AEC_BF16_SHADOW", "1") != "0"
            and _os.environ.get("AEC_HALF_UPDATE", "0") == "0")


def _circ_hist_on() -> bool:
    """Circular far-history (A/B knob, default OFF):
    instead of the per-tick history SHIFT (concatenate new block + drop
    oldest = full [B,P,F] rewrite), keep a [B,2P,F] buffer, write each
    tick's block at TWO slots (hq and hq+P, hq decrementing mod P), and
    read the always-lag-ordered window [hq:hq+P] via dynamic_slice.
    Outputs are BIT-IDENTICAL to the shift form (same quantized values,
    same reduce order — tests/test_aec.py::test_circular_history_exact).
    Not measured on the GPU.  Read at state-init time; the Xh shape then
    drives the process path.  Requires the default update branch (the
    half-update knob path shifts in its own layout)."""
    return (_os.environ.get("AEC_CIRC_HIST", "0") == "1"
            and _os.environ.get("AEC_HALF_UPDATE", "0") == "0")


def _sround_bf16(x, salt):
    """Stochastically round f32 -> bf16 (unbiased; deterministic in
    (shape position, salt)).  IEEE sign-magnitude makes the +rnd carry
    round |x| away from zero with p = frac(|x|/ulp) — round-to-nearest
    in expectation for either sign."""
    bits = jax.lax.bitcast_convert_type(x, jnp.uint32)
    shp = x.shape
    lin = jnp.zeros(shp, jnp.uint32)
    for d in range(len(shp)):
        lin = lin * jnp.uint32(shp[d]) + jax.lax.broadcasted_iota(
            jnp.uint32, shp, d)
    h = lin * jnp.uint32(2654435761) + salt * jnp.uint32(0x9E3779B9)
    h = h ^ (h >> 16)
    h = h * jnp.uint32(0x85EBCA6B)
    h = h ^ (h >> 13)
    bits = bits + (h & jnp.uint32(0xFFFF))
    return jax.lax.bitcast_convert_type(
        (bits >> 16).astype(jnp.uint16), jnp.bfloat16)


# Selective-partial-update NLMS (A/B knob, default off): update only the
# partitions whose index parity matches the tick parity — the shadow-tap
# update (gradient + read-modify-write) runs on HALF the [B,P,F] taps per
# tick via a strided dynamic_update_slice.  Not measured on the GPU.
_HALF_UPDATE = _os.environ.get("AEC_HALF_UPDATE", "0") != "0"


def _aec_init(ctx):
    B = ctx.batch
    S = ctx.in_formats[0].samples_per_tick
    P = _partitions(ctx)
    F = _padded_bins(S)                    # storage bins (maybe lane-padded)
    sdt = jnp.bfloat16 if _bf16_shadow_on() else jnp.float32
    circ = _circ_hist_on()
    zc = lambda: jnp.zeros((B, P, F), sdt)
    zh = lambda: jnp.zeros((B, P, F), STORE_DTYPE)
    # circular history: [B,2P,F] double-buffer, window [hq:hq+P] (see
    # _circ_hist_on); plain lag-ordered [B,P,F] otherwise
    zx = lambda: jnp.zeros((B, 2 * P if circ else P, F), STORE_DTYPE)
    st = {
        "Wm_r": zh(), "Wm_i": zh(),        # main (filtering) taps, bf16
        "Ws_r": zc(), "Ws_i": zc(),        # shadow taps (bf16+stochastic
                                           # rounding by default, f32 knob)
        "Xh_r": zx(), "Xh_i": zx(),        # far-end block spectra history
        "far_prev": jnp.zeros((B, S), jnp.float32),   # overlap-save
        "Hp": jnp.zeros((B, F), jnp.float32),   # exact per-bin history power
        "Em": jnp.full((B,), 1e-6, jnp.float32),      # smoothed main error
        "Es": jnp.full((B,), 1e-6, jnp.float32),      # smoothed shadow error
        "Dn": jnp.full((B,), 1e-6, jnp.float32),      # smoothed near energy
        "promote_cnt": jnp.zeros((B,), jnp.int32),
        "reseed_cnt": jnp.zeros((B,), jnp.int32),
        "diverge_cnt": jnp.zeros((B,), jnp.int32),
        "Nf": jnp.ones((B,), jnp.float32),   # shadow-error floor (min stats)
        "leak": jnp.ones((B,), jnp.float32),
        "cpos": jnp.zeros((), jnp.int32),   # round-robin constraint cursor
        # this tick's two-path transfers per leg: promote | reseed << 1 |
        # hard_reset << 2 (observability; nothing reads it back)
        "xfer": jnp.zeros((B,), jnp.int8),
    }
    if circ:
        # this tick's write slot; decrements mod P (newest-first window)
        st["hq"] = jnp.full((), P - 1, jnp.int32)
    if sdt == jnp.bfloat16:
        st["srk"] = jnp.zeros((), jnp.uint32)   # stochastic-rounding salt
    return st


def _aec_params(ctx):
    B = ctx.batch
    return {
        "enabled": jnp.ones((B,), jnp.bool_),
        "adapt": jnp.ones((B,), jnp.bool_),
        "mu": jnp.full((B,), MU, jnp.float32),
        "suppress": jnp.ones((B,), jnp.bool_),
    }


def _aec_process(state, ins, params, ctx):
    near, far = ins
    B, S = near.shape
    two_s = 2 * S
    P = state["Wm_r"].shape[1]
    # the state's shadow dtype (set at init) picks the path: the
    # half-update knob branch is f32-only, so bf16-shadow states always
    # take the default branch regardless of later env flips
    bf16_shadow = state["Ws_r"].dtype == jnp.bfloat16
    circ = state["Xh_r"].shape[1] == 2 * P   # circular far-history layout
    half_update = _HALF_UPDATE and not bf16_shadow and not circ

    F_nat = S + 1
    F_pad = state["Hp"].shape[1] - F_nat            # lane padding columns
    far_blk = jnp.concatenate([state["far_prev"], far], axis=1)     # [B, 2S]
    Xr, Xi = rfft(far_blk, two_s)                                   # [B, F]
    if F_pad:
        Xr = jnp.pad(Xr, ((0, 0), (0, F_pad)))
        Xi = jnp.pad(Xi, ((0, 0), (0, F_pad)))
    # the block leaving the far-history window this tick (for the exact
    # running history-power sum; read pre-shift, in the storage dtype so
    # the telescoping sum adds and removes identical quantized values).
    # Circular layout: slot hq (about to be overwritten) holds the block
    # written P ticks ago — exactly the one leaving the window.
    hq = state["hq"] if circ else None
    if circ:
        dr = jax.lax.dynamic_slice_in_dim(state["Xh_r"], hq, 1,
                                          axis=1)[:, 0]
        di = jax.lax.dynamic_slice_in_dim(state["Xh_i"], hq, 1,
                                          axis=1)[:, 0]
    else:
        dr, di = state["Xh_r"][:, -1], state["Xh_i"][:, -1]
    drop_pow = cabs2(dr.astype(jnp.float32), di.astype(jnp.float32))
    inst_q = cabs2(Xr.astype(STORE_DTYPE).astype(jnp.float32),
                   Xi.astype(STORE_DTYPE).astype(jnp.float32))

    # --- history shift + dual filter apply ---------------------------------
    Wm_r_f = state["Wm_r"].astype(jnp.float32)
    Wm_i_f = state["Wm_i"].astype(jnp.float32)
    if circ:
        # circular write: the new block lands at slots hq and hq+P
        # (two one-slot in-place dus; see _circ_hist_on) and the
        # lag-ordered window is a fusible dynamic_slice — the full
        # [B,P,F] rewrite of the shift form never happens
        nr = Xr[:, None, :].astype(state["Xh_r"].dtype)
        ni = Xi[:, None, :].astype(state["Xh_i"].dtype)
        Xh_full_r = jax.lax.dynamic_update_slice_in_dim(
            state["Xh_r"], nr, hq, axis=1)
        Xh_full_r = jax.lax.dynamic_update_slice_in_dim(
            Xh_full_r, nr, hq + P, axis=1)
        Xh_full_i = jax.lax.dynamic_update_slice_in_dim(
            state["Xh_i"], ni, hq, axis=1)
        Xh_full_i = jax.lax.dynamic_update_slice_in_dim(
            Xh_full_i, ni, hq + P, axis=1)
        Xh_r = jax.lax.dynamic_slice_in_dim(Xh_full_r, hq, P, axis=1)
        Xh_i = jax.lax.dynamic_slice_in_dim(Xh_full_i, hq, P, axis=1)
    else:
        # history shift in the storage dtype (bf16 traffic), upcast
        # per use
        Xh_r = jnp.concatenate(
            [Xr[:, None, :].astype(state["Xh_r"].dtype),
             state["Xh_r"][:, :-1]], axis=1)
        Xh_i = jnp.concatenate(
            [Xi[:, None, :].astype(state["Xh_i"].dtype),
             state["Xh_i"][:, :-1]], axis=1)

    # BOTH filter applications as ONE variadic (multi-output) reduce:
    # XLA emits a single fusion whose loop body loads Wm/Ws/Xh once
    # per (b,p,f) element and accumulates all four sums — four
    # separate jnp.sum calls compiled to four reduce fusions that
    # re-read the [B,P,F] operand pairs each time (~1.5 GB/tick at
    # 8192 legs; the four fusions topped tools/hlo_traffic.py's
    # estimated-cycle ranking at a combined ~4.6 ms).  Values are
    # bit-identical (same products, same add order over P).
    xr = Xh_r.astype(jnp.float32)
    xi = Xh_i.astype(jnp.float32)
    ws_r_f = state["Ws_r"].astype(jnp.float32)
    ws_i_f = state["Ws_i"].astype(jnp.float32)
    terms = (Wm_r_f * xr - Wm_i_f * xi,
             Wm_r_f * xi + Wm_i_f * xr,
             ws_r_f * xr - ws_i_f * xi,
             ws_r_f * xi + ws_i_f * xr)
    Ym_r, Ym_i, Ys_r, Ys_i = jax.lax.reduce(
        terms, tuple(jnp.zeros((), jnp.float32) for _ in terms),
        lambda acc, val: tuple(a + v for a, v in zip(acc, val)), (1,))
    # overlap-save keeps only the block's second half: matmul on
    # the needed basis columns (half the MACs, identical values)
    y_m = irfft_tail(Ym_r[:, :F_nat], Ym_i[:, :F_nat], two_s)
    y_s = irfft_tail(Ys_r[:, :F_nat], Ys_i[:, :F_nat], two_s)
    e_m = near - y_m
    e_s = near - y_s

    # --- shadow adaptation inputs ------------------------------------------
    # E = rfft([0, e_s]): the zero half never enters the contraction
    Er, Ei = rfft_tail(e_s, two_s)
    if F_pad:
        Er = jnp.pad(Er, ((0, 0), (0, F_pad)))
        Ei = jnp.pad(Ei, ((0, 0), (0, F_pad)))
    # exact MDF-NLMS normalization: divide by the per-bin power of the
    # ACTUAL history window, maintained as a telescoping running sum
    # (+ incoming block, - dropped block, identical quantized values both
    # ways). The old P*EWMA proxy under-normalized at speech OFFSETS —
    # loud blocks still in the history while the smoothed PSD decays —
    # and the shadow diverged (measured Ws -> 1e18 on the double-talk
    # fixture); the reseed loop was masking it, costing 10+ s convergence.
    Hp = jnp.maximum(state["Hp"] + inst_q - drop_pow, 0.0)
    # bins where the far signal carries no energy give NLMS nothing to
    # identify — their gradients are noise and the taps random-walk large
    # over minutes (then a promote captures the garbage). Fade them out
    # with a CONTINUOUS ramp (hard thresholds flip per-bin between
    # backends whose Hp differs by ulps, and the flipped gradients
    # amplify into visible output deltas on the device-vs-CPU check).
    thr = 1e-3 * Hp.mean(axis=1, keepdims=True) + 1e-12
    bin_w = jnp.clip(Hp / thr - 1.0, 0.0, 1.0)
    inv_norm = bin_w / (Hp + 1e-5)
    mu = params["mu"] * params["adapt"].astype(jnp.float32)
    # causality (gradient) constraint, ONE partition per tick round-robin —
    # the classic MDF cost reduction (speexdsp constrains one block per
    # frame): the big [F]<->[2S] DFT matmuls run on 1/P of the taps, and
    # each partition still gets re-projected every P*10 ms.
    cpos = state["cpos"]
    hp_r = jax.lax.dynamic_slice_in_dim(Xh_r, cpos, 1, axis=1
                                        )[:, 0].astype(jnp.float32)
    hp_i = jax.lax.dynamic_slice_in_dim(Xh_i, cpos, 1, axis=1
                                        )[:, 0].astype(jnp.float32)
    gp_r, gp_i = cmul_conj(hp_r, hp_i, Er, Ei)
    gp_r = (gp_r * inv_norm)[:, :F_nat]
    gp_i = (gp_i * inv_norm)[:, :F_nat]
    # causality projection irfft -> zero tail -> rfft as one constant
    # [F,F] operator (ops/rfft.py apply_constraint): 2x fewer MACs and no
    # [B, 2S] time-domain intermediate
    gc_r, gc_i = apply_constraint(gp_r, gp_i, two_s)
    if F_pad:
        gc_r = jnp.pad(gc_r, ((0, 0), (0, F_pad)))
        gc_i = jnp.pad(gc_i, ((0, 0), (0, F_pad)))

    # --- two-path transfer decisions (per-leg, hysteretic) ------------------
    Em = ERR_EWMA * state["Em"] + (1 - ERR_EWMA) * (e_m * e_m).mean(axis=1)
    Es = ERR_EWMA * state["Es"] + (1 - ERR_EWMA) * (e_s * e_s).mean(axis=1)
    Dn = ERR_EWMA * state["Dn"] + (1 - ERR_EWMA) * (near * near).mean(axis=1)
    # shadow-error floor via min statistics: with ambient mic noise the
    # error can never reach ERLE_GATE*Dn, so ALSO promote when the shadow
    # error sits at its own long-term floor (and still sustainably halves
    # the main error — that gate stays). The floor creeps up slowly and is
    # capped at the current error, so sustained double-talk (error = near
    # speech energy, far above the between-words floor) never qualifies.
    Nf = jnp.where(Dn > 1e-7,
                   jnp.minimum(state["Nf"] * 1.01, Es), state["Nf"])
    # tight 2.0x margin: promotes stay RARE and decisive — a permanently
    # borderline gate would flip promote ticks between backends with
    # different rounding (the device-vs-CPU check flagged that at 4.0x)
    at_floor = Es < 2.0 * Nf
    better = (Es < COPY_RATIO * Em) & ((Es < ERLE_GATE * Dn) | at_floor)
    # a transiently-diverged shadow is only reseeded when the MAIN filter
    # actually cancels something (Em well under the mic energy) — early in
    # a call main is zero taps and Em==Dn, and repeatedly reseeding the
    # shadow from zeros just restarts its convergence (measured: 15 ms
    # single-tap echo took 15 s to converge from reseed thrash)
    worse = (Es > RESET_RATIO * Em) & (Em < 0.8 * Dn)
    promote_cnt = jnp.where(better, state["promote_cnt"] + 1, 0)
    reseed_cnt = jnp.where(worse, state["reseed_cnt"] + 1, 0)
    promote = promote_cnt >= HOLD_TICKS
    reseed = reseed_cnt >= HOLD_TICKS
    promote_cnt = jnp.where(promote, 0, promote_cnt)
    reseed_cnt = jnp.where(reseed, 0, reseed_cnt)
    # catastrophic-divergence insurance: if even the better filter is
    # sustainedly WORSE than doing nothing (error above raw mic energy),
    # zero the shadow for a fresh start. Ordinary echo-path changes do NOT
    # trip this (the shadow's error drops below the mic energy within
    # ~100 ms and re-converges by plain NLMS — ~6 s on the real-speech
    # delay-change scenario, tested); this guards sign flips / reference
    # slips where adaptation would otherwise chase a stale solution
    # leaky accumulator: speech pauses must not reset the evidence
    # (energies go quiet between words), so decay instead of clearing
    active = Dn > 1e-5
    # also catch a blown-up SHADOW alone (main healthy): with the main
    # filter converged the min() below never trips, but a diverged shadow
    # must not keep integrating garbage
    diverged = ((jnp.minimum(Em, Es) > 1.05 * Dn)
                | (Es > 10.0 * Dn)) & active
    diverge_cnt = jnp.where(
        diverged, state["diverge_cnt"] + 1,
        jnp.where(active, jnp.maximum(state["diverge_cnt"] - 1, 0),
                  state["diverge_cnt"]))
    hard_reset = diverge_cnt >= 2 * HOLD_TICKS
    diverge_cnt = jnp.where(hard_reset, 0, diverge_cnt)
    # The three transfer decisions are mutually exclusive per leg: promote
    # and reseed by construction (Es < 0.4*Em vs Es > 1.5*Em), but promote
    # and hard_reset CAN coincide (at_floor can hold while both paths are
    # diverged) — and promoting taps to MAIN in the very tick they are
    # declared catastrophically diverged was never intended.  Excluding it
    # also lets the promote select below read the FINAL shadow taps, which
    # matters for the fusion schedule.
    promote = promote & ~hard_reset
    xfer = (promote.astype(jnp.int8) | (reseed.astype(jnp.int8) << 1)
            | (hard_reset.astype(jnp.int8) << 2))

    # --- gradient + NLMS update + transfer copies ---------------------------
    if half_update:
        # Partial-update NLMS: gradient + tap RMW on the half of the
        # partitions whose parity matches the tick parity.  [B,P,F] is
        # viewed as [B,P//2,2,F] (p = 2*i + j), so the parity slice is a
        # contiguous-runs rectangle that dynamic_update_slice writes
        # without touching the other half's bytes.
        par = cpos & 1
        Ph = P // 2
        Fs = state["Ws_r"].shape[2]
        x4_r = jax.lax.dynamic_slice_in_dim(
            Xh_r.reshape(B, Ph, 2, Fs), par, 1, axis=2)[:, :, 0]
        x4_i = jax.lax.dynamic_slice_in_dim(
            Xh_i.reshape(B, Ph, 2, Fs), par, 1, axis=2)[:, :, 0]
        Gr, Gi = cmul_conj(x4_r.astype(jnp.float32),
                           x4_i.astype(jnp.float32),
                           Er[:, None, :], Ei[:, None, :])
        step_w = mu[:, None, None] * inv_norm[:, None, :]
        ws4_r = state["Ws_r"].reshape(B, Ph, 2, Fs)
        ws4_i = state["Ws_i"].reshape(B, Ph, 2, Fs)
        half_r = jax.lax.dynamic_slice_in_dim(ws4_r, par, 1,
                                              axis=2)[:, :, 0] + step_w * Gr
        half_i = jax.lax.dynamic_slice_in_dim(ws4_i, par, 1,
                                              axis=2)[:, :, 0] + step_w * Gi
        Ws_r = jax.lax.dynamic_update_slice_in_dim(
            ws4_r, half_r[:, :, None], par, axis=2).reshape(B, P, Fs)
        Ws_i = jax.lax.dynamic_update_slice_in_dim(
            ws4_i, half_i[:, :, None], par, axis=2).reshape(B, P, Fs)
    else:
        # Unconstrained NLMS step for ALL partitions + the round-robin
        # causality-constrained step for partition `cpos`, as ONE fused
        # read-modify-write pass over [B,P,F]: the step is selected
        # per-partition with an iota mask, so the constrained overwrite
        # rides the same fusion that reads Ws and writes Ws'.  The
        # previous dynamic_update_slice form compiled to a SECOND full
        # [B,P,F] f32 read+write per component (~500 MB/tick at 8192
        # legs, 40% of the EC core's HBM traffic — measured via
        # tools/hlo_traffic.py on the optimized HLO: two 126 MB
        # non-aliased dus fusions).  No [B,P,F] gradient tensor is
        # materialized either way, and the values are bit-identical to the
        # dus form.
        Gr, Gi = cmul_conj(Xh_r.astype(jnp.float32),
                           Xh_i.astype(jnp.float32),
                           Er[:, None, :], Ei[:, None, :])
        pmask = (jax.lax.broadcasted_iota(jnp.int32, (1, P, 1), 1)
                 == cpos)
        step_w = mu[:, None, None] * inv_norm[:, None, :]
        Ws_r = state["Ws_r"].astype(jnp.float32) + jnp.where(
            pmask, (mu[:, None] * gc_r)[:, None, :], step_w * Gr)
        Ws_i = state["Ws_i"].astype(jnp.float32) + jnp.where(
            pmask, (mu[:, None] * gc_i)[:, None, :], step_w * Gi)
    if half_update:
        # the A/B knob path skips the fused masked constraint: overwrite
        # the round-robin partition from the pre-update taps, as before
        ws_p_r = jax.lax.dynamic_slice_in_dim(state["Ws_r"], cpos, 1,
                                              axis=1)[:, 0]
        ws_p_i = jax.lax.dynamic_slice_in_dim(state["Ws_i"], cpos, 1,
                                              axis=1)[:, 0]
        Ws_r = jax.lax.dynamic_update_slice_in_dim(
            Ws_r, (ws_p_r + mu[:, None] * gc_r)[:, None], cpos, axis=1)
        Ws_i = jax.lax.dynamic_update_slice_in_dim(
            Ws_i, (ws_p_i + mu[:, None] * gc_i)[:, None], cpos, axis=1)
    p3 = promote[:, None, None]
    r3 = reseed[:, None, None]
    h3 = hard_reset[:, None, None]
    # reseed + hard-reset ride the update pass; the promote select then
    # reads the FINAL Ws (valid — the three decisions are mutually
    # exclusive per leg, see the mask note above).  Reading the
    # materialized final value instead of the pre-reseed intermediate
    # stops XLA REMATERIALIZING the whole NLMS update inside the
    # promote-select fusion (a second full read of Ws + Xh, ~630 MB/
    # tick at 8192 legs — tools/hlo_traffic.py ranked that remat
    # fusion equal-first in the tick).
    Ws_r = jnp.where(h3, 0.0, jnp.where(r3, Wm_r_f, Ws_r))
    Ws_i = jnp.where(h3, 0.0, jnp.where(r3, Wm_i_f, Ws_i))
    if bf16_shadow:
        # quantize ONCE, after all transfers, so the promote select
        # below copies exactly the stored shadow value; fresh salt per
        # tick keeps the rounding unbiased over time
        salt = state["srk"] * jnp.uint32(2)
        Ws_r = _sround_bf16(Ws_r, salt)
        Ws_i = _sround_bf16(Ws_i, salt + jnp.uint32(1))
    if _COND_PROMOTE:
        # promotes are rare (hysteretic, steady-state ~never): gate the
        # [B,P,F] bf16 main-tap rewrite on any(promote) so the common
        # tick aliases Wm through the scan carry instead of copying it
        Wm_r, Wm_i = jax.lax.cond(
            jnp.any(promote),
            lambda: (jnp.where(p3, Ws_r.astype(STORE_DTYPE),
                               state["Wm_r"]),
                     jnp.where(p3, Ws_i.astype(STORE_DTYPE),
                               state["Wm_i"])),
            lambda: (state["Wm_r"], state["Wm_i"]))
    else:
        Wm_r = jnp.where(p3, Ws_r.astype(STORE_DTYPE), state["Wm_r"])
        Wm_i = jnp.where(p3, Ws_i.astype(STORE_DTYPE), state["Wm_i"])
    Em = jnp.where(promote, Es, Em)
    Es = jnp.where(reseed, Em, Es)
    Es = jnp.where(hard_reset, Dn, Es)

    e = jnp.where(promote[:, None], e_s, e_m)
    y = jnp.where(promote[:, None], y_s, y_m)
    # per-tick output limiter: if the selected filter makes this block
    # WORSE than the raw mic (a stale/garbage main right after an echo
    # path change or a bad promote), blend back toward the mic —
    # cancellation can never be worse than doing nothing (the reference's
    # echo-limiter safety role). The blend is CONTINUOUS (ramps over
    # err/near 2x..4x) so a borderline block doesn't flip hard between
    # backends with different rounding (keeps the device-vs-CPU correctness
    # check meaningful).
    blk_near = (near * near).mean(axis=1)
    blk_err = (e * e).mean(axis=1)
    w_bad = jnp.clip(blk_err / (2.0 * blk_near + 1e-9) - 1.0,
                     0.0, 1.0)[:, None]
    e = (1.0 - w_bad) * e + w_bad * near
    y = (1.0 - w_bad) * y
    # what the state carries forward: the full ring (circ) or the shifted
    # lag-ordered window (all other paths)
    Xh_st_r = Xh_full_r if circ else Xh_r
    Xh_st_i = Xh_full_i if circ else Xh_i
    e = jnp.where(params["enabled"][:, None], e, near)

    # --- residual echo suppression ------------------------------------------
    # over-subtract only the *estimated residual* (leak * |Y|), not the full
    # echo estimate — otherwise near-end speech sharing bins with the echo is
    # destroyed during double-talk. `leak` = residual/echo power ratio,
    # tracked as a slow minimum so near speech never inflates it.
    if ctx.params.get("no_suppress"):
        # build-time suppressor bypass (static; also the perf-probe knob —
        # the runtime `suppress` param only masks the OUTPUT, XLA still
        # computes the stage)
        new_state = {"Wm_r": Wm_r, "Wm_i": Wm_i, "Ws_r": Ws_r,
                     "Ws_i": Ws_i, "Xh_r": Xh_st_r, "Xh_i": Xh_st_i,
                     "far_prev": far, "Hp": Hp, "Em": Em, "Es": Es,
                     "Dn": Dn, "Nf": Nf, "leak": state["leak"],
                     "promote_cnt": promote_cnt, "reseed_cnt": reseed_cnt,
                     "diverge_cnt": diverge_cnt, "cpos": (cpos + 1) % P,
                     "xfer": xfer}
        if circ:
            new_state["hq"] = (hq + P - 1) % P
        if bf16_shadow:
            new_state["srk"] = state["srk"] + jnp.uint32(1)
        return new_state, (e,), {}

    Ey = (y * y).mean(axis=1)
    inst_leak = (e * e).mean(axis=1) / (Ey + 1e-9)
    # creep up only while the mic is echo-dominated (Dn ~ Ey); during near
    # activity (Dn >> Ey) the estimate holds, so double-talk never inflates it
    rise = jnp.where(Dn < 1.5 * Ey, LEAK_RISE, 1.0)
    leak = jnp.clip(jnp.minimum(state["leak"] * rise, inst_leak), 0.01, 1.0)
    Ehr, Ehi = rfft(e, S)
    mag_e = jnp.sqrt(cabs2(Ehr, Ehi) + 1e-18)
    Yhr, Yhi = rfft(y, S)
    mag_y = jnp.sqrt(cabs2(Yhr, Yhi) + 1e-18)
    resid_mag = jnp.sqrt(leak)[:, None] * mag_y
    gain = jnp.clip((mag_e - SUPPRESS_BETA * resid_mag) / (mag_e + 1e-9),
                    SUPPRESS_FLOOR, 1.0)
    e_sup = irfft(Ehr * gain, Ehi * gain, S)
    out = jnp.where((params["suppress"] & params["enabled"])[:, None], e_sup, e)

    new_state = {"Wm_r": Wm_r, "Wm_i": Wm_i, "Ws_r": Ws_r, "Ws_i": Ws_i,
                 "Xh_r": Xh_st_r, "Xh_i": Xh_st_i, "far_prev": far,
                 "Hp": Hp,
                 "Em": Em, "Es": Es, "Dn": Dn, "Nf": Nf,
                 "leak": leak,
                 "promote_cnt": promote_cnt, "reseed_cnt": reseed_cnt,
                 "diverge_cnt": diverge_cnt,
                 "cpos": (cpos + 1) % P, "xfer": xfer}
    if circ:
        new_state["hq"] = (hq + P - 1) % P
    if bf16_shadow:
        new_state["srk"] = state["srk"] + jnp.uint32(1)
    return new_state, (out,), {}


register_filter(FilterDef(
    name="echo_canceller", ninputs=2, noutputs=1,
    out_formats=lambda ctx: (ctx.in_formats[0],),
    init=_aec_init, runtime_params=_aec_params, process=_aec_process,
    interfaces=("echo_canceller",),
))


def get_state_blob(state_entry) -> bytes:
    """Serialize EC state for warm restart (parity: speexec.c:119-150).
    bf16-stored tensors (numpy has no bfloat16) travel as float32 and are
    re-quantized on restore."""
    import io
    buf = io.BytesIO()
    arrays = {}
    bf16_keys = []
    for k, v in state_entry.items():
        a = np.asarray(jnp.asarray(v).astype(jnp.float32)) \
            if jnp.asarray(v).dtype == jnp.bfloat16 else np.asarray(v)
        if jnp.asarray(v).dtype == jnp.bfloat16:
            bf16_keys.append(k)
        arrays[k] = a
    arrays["__bf16__"] = np.array(bf16_keys)
    np.savez(buf, **arrays)
    return buf.getvalue()


def set_state_blob(blob: bytes):
    import io
    data = np.load(io.BytesIO(blob))
    bf16 = set(data["__bf16__"].tolist()) if "__bf16__" in data.files else set()
    return {k: (jnp.asarray(data[k]).astype(jnp.bfloat16) if k in bf16
                else jnp.asarray(data[k]))
            for k in data.files if k != "__bf16__"}
