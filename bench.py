"""Benchmark: concurrent 48 kHz AEC+resample+mix legs per GPU at the 10 ms
real-time deadline (reference analogue tools/bench.c — add legs until the
ticker misses).  Runs on an NVIDIA GPU only; without one it exits non-zero.

Two numbers are measured and both appear in the ONE output JSON line:

* value / metric (headline): **end-to-end** legs — every leg's G.711 audio
  crosses real localhost UDP both directions every tick (native
  sendmmsg/GSO + recvmmsg/GRO edge, jitter-ring playout), is decoded,
  resampled 8k->48k, echo-cancelled, AGC'd, conference-mixed (mix-minus),
  downsampled and re-encoded on the GPU, with a cross-correlation fidelity
  oracle (>= 0.9) between sent and received probe-leg audio.  Host work,
  device compute AND host<->device transfer all inside the deadline.
* device_only_legs: the device-compute-only capacity (device time from
  ``block_until_ready``); the delta to the headline is the host and
  transfer cost.

Device work is blocked K ticks per call with a D-deep pipeline and
downloads overlap uploads on a reader thread.  The resulting added latency
(K*(D+1)+prefill ticks) is reported, not hidden.  Every result is stamped
with the platform, device kind and device count it ran on.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

DEADLINE_MS = 10.0
SAFETY = 0.9            # require 10% headroom under the deadline
K_TICKS = 50            # ticks fused per device call (device-only metric)
MAX_BATCH = 1 << 20
E2E_BLOCKS = 24         # blocks per e2e trial (K=32 -> ~7.7 s paced)


def _is_oom(e: Exception) -> bool:
    return "RESOURCE_EXHAUSTED" in str(e) or "out of memory" in str(e).lower()


def measure_batch(batch: int, repeats: int = 3):
    """Device ms per tick at `batch` legs, or None when the device runs
    out of memory.  Any other failure (a compile error) propagates."""
    import jax
    import jax.numpy as jnp
    from mediastreamer2_tpu.core.block import tick_samples
    from mediastreamer2_tpu.core.factory import Factory
    from mediastreamer2_tpu.models.flagship import build_flagship

    S = tick_samples(48000)
    factory = Factory()
    try:
        cg, params = build_flagship(factory, batch=batch)
        state = cg.init_state()
        key = jax.random.key(0)
        mic0 = 0.1 * jax.random.normal(key, (batch, S), jnp.float32)

        def body(st, t):
            ext = {"mic": jnp.roll(mic0, t, axis=1),
                   "spk_ref": jnp.roll(mic0, t + 7, axis=1)}
            st, out, _ = cg.step(st, params, ext)
            return st, out["out"][:, 0].sum()

        @jax.jit
        def run(st):
            return jax.lax.scan(body, st, jnp.arange(K_TICKS))

        state, _ = jax.block_until_ready(run(state))     # compile + warm
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            state, _ = jax.block_until_ready(run(state))
            best = min(best, (time.perf_counter() - t0) * 1e3)
        return best / K_TICKS
    except Exception as e:
        if not _is_oom(e):
            raise
        print(f"# batch={batch}: out of device memory", file=sys.stderr)
        return None


def device_only_legs() -> tuple:
    budget = DEADLINE_MS * SAFETY
    lo, hi = 0, None
    b = 1024
    timings = {}
    while hi is None:
        ms = measure_batch(b)
        timings[b] = ms
        print(f"# device-only batch={b}: "
              f"{ms if ms is None else round(ms, 3)} ms/tick", file=sys.stderr)
        if ms is not None and ms <= budget:
            lo = b
            if b >= MAX_BATCH:
                hi = b + 1
                break
            b *= 2
        else:
            hi = b
    while hi - lo > max(256, lo // 8):
        mid = (lo + hi) // 2 // 256 * 256
        if mid <= lo or mid >= hi:
            break
        ms = measure_batch(mid)
        timings[mid] = ms
        print(f"# device-only batch={mid}: "
              f"{ms if ms is None else round(ms, 3)} ms/tick", file=sys.stderr)
        if ms is not None and ms <= budget:
            lo = mid
        else:
            hi = mid
    return lo, timings.get(lo)


def e2e_trial(n_legs: int, k_block: int, depth: int, srtp: bool = False,
              blocks: int = None, srtp_suite: str = "AES_CM_128_HMAC_SHA1_80"):
    """One paced e2e run; returns E2EResult or None on failure.

    Always traced: the per-tick phase attribution (edge / submit / pop)
    costs a few perf_counter calls and gives every published row — and
    every FAILED low-latency or SRTP row — a self-documenting breakdown
    in the artifact."""
    from mediastreamer2_tpu.core.factory import Factory
    from mediastreamer2_tpu.models.e2e_bench import E2EConferenceBench
    try:
        b = E2EConferenceBench(Factory(), n_legs, k_block=k_block,
                               pipeline_depth=depth, srtp=srtp,
                               srtp_suite=srtp_suite)
        try:
            # GC off during the paced window: one gen-2 pause can take
            # ~100 ms — a late-tick cluster in any row (core/rtgc.py)
            from mediastreamer2_tpu.core.rtgc import paused_gc
            with paused_gc():
                return b.run(blocks or E2E_BLOCKS, paced=True, trace=True)
        finally:
            b.close()
    except Exception as e:
        print(f"# e2e n={n_legs}{' srtp' if srtp else ''}: failed "
              f"({type(e).__name__}: {str(e)[:120]})", file=sys.stderr)
        return None


def _expired(deadline) -> bool:
    """Cooperative per-section deadline (checked BETWEEN trials: a single
    trial is bounded by its block count; compiles are the only spike)."""
    return deadline is not None and time.perf_counter() > deadline


def e2e_passes(res) -> bool:
    if res is None:
        return False
    ticks = res.ticks
    return (res.late_ticks <= max(1, ticks // 100)
            and res.ms_per_tick <= DEADLINE_MS * 1.03
            and res.loss_rate < 0.02 and res.fidelity >= 0.9)


def _kd_for(n: int) -> tuple:
    """Block size / pipeline depth ladder: bigger N gets more in-flight
    buffering (the latency cost is reported in the result)."""
    return (32, 3) if n <= 1536 else (64, 6)


def e2e_legs(deadline: float = None) -> tuple:
    """Largest N passing the paced e2e run. Returns (n, result).

    Strategy: start at a floor, climb ~1.5x while passing, then refine
    once between the last pass and the first fail."""

    def trial(n):
        K, D = _kd_for(n)
        res = e2e_trial(n, K, D)
        ok = e2e_passes(res)
        print(f"# e2e n={n}: "
              f"{None if res is None else round(res.ms_per_tick, 2)} ms/tick "
              f"late={getattr(res, 'late_ticks', '-')} "
              f"loss={None if res is None else round(res.loss_rate, 4)} "
              f"fid={None if res is None else round(res.fidelity, 3)} "
              f"-> {'PASS' if ok else 'FAIL'}", file=sys.stderr)
        return res, ok

    best = (0, None)
    cur = 1024
    first_fail = None
    retried = False
    for _ in range(10):                       # bounded number of trials
        if _expired(deadline) and best[0]:
            print("# e2e search: section budget reached — keeping best",
                  file=sys.stderr)
            return best
        res, ok = trial(cur)
        if ok:
            best = (cur, res)
            nxt = (cur * 3 // 2) // 256 * 256
            cur = nxt if nxt > cur else cur + 256
        elif best[0] == 0:
            if not retried:
                retried = True                # tolerate one transient fail
                continue
            if cur <= 256:
                break
            cur = max(256, cur // 2 // 256 * 256)   # walk down to a pass
        else:
            first_fail = cur
            break
    for _ in range(2):                        # refine between pass and fail
        if not (first_fail and best[0]):
            break
        mid = (best[0] + first_fail) // 2 // 128 * 128
        if not (best[0] < mid < first_fail):
            break
        res, ok = trial(mid)
        if ok:
            best = (mid, res)
        else:
            first_fail = mid
    return best


def srtp_e2e(n_start: int, suite: str = "AES_CM_128_HMAC_SHA1_80",
             deadline: float = None) -> tuple:
    """Largest N passing the e2e run with per-leg SRTP protect/unprotect
    inline on the native edge — the encrypted operating point the
    reference runs by default (ms_srtp.cpp inline protection). Walks down
    from the cleartext headline; the delta IS the measured cost of
    encryption at scale.  `suite` also benches the AEAD-GCM path
    (RFC 7714) so the at-scale AEAD claim is measured, not implied."""
    def trial(n):
        K, D = _kd_for(n)
        res = e2e_trial(n, K, D, srtp=True, srtp_suite=suite)
        ok = res is not None and e2e_passes(res) and res.auth_failures == 0
        print(f"# srtp-e2e[{suite}] n={n}: "
              f"{None if res is None else round(res.ms_per_tick, 2)} ms/tick "
              f"late={getattr(res, 'late_ticks', '-')} "
              f"auth_fail={getattr(res, 'auth_failures', '-')} "
              f"fid={None if res is None else round(res.fidelity, 3)} "
              f"-> {'PASS' if ok else 'FAIL'}", file=sys.stderr)
        return res, ok

    n = max(256, n_start // 256 * 256)
    last_fail = None
    best = (0, None)
    for _ in range(5):                    # walk down to a pass
        if _expired(deadline) and best[0]:
            return best
        res, ok = trial(n)
        if ok:
            best = (n, res)
            break
        last_fail = n
        if n <= 256:
            return 0, None
        n = max(256, int(n / 1.6) // 256 * 256)
    for _ in range(2):                    # refine upward toward the fail
        if not (best[0] and last_fail) or _expired(deadline):
            break
        mid = (best[0] + last_fail) // 2 // 128 * 128
        if not (best[0] < mid < last_fail):
            break
        res, ok = trial(mid)
        if ok:
            best = (mid, res)
        else:
            last_fail = mid
    return best


# (K, D, confirm): confirm=True rows re-verify their operating point
# before publication (reproduced, not hit once)
LATENCY_LADDER = [(1, 1, False), (1, 4, False), (4, 2, True),
                  (8, 2, True), (16, 3, False), (32, 3, False)]


def latency_curve(n_head: int, deadline: float = None) -> list:
    """Measured latency/capacity points: for each (K, D) in the ladder,
    the largest N found that passes (bounded trials), with the config's
    added mouth-to-ear latency (reference contract: ONE tick of latency,
    msticker.c:46).

    Robustness: a transient host stall must not zero a row — a fail that
    still delivered audio (fidelity held,
    bounded loss) is retried once at the same N before halving, the walk
    goes down to 64 legs (a 64-leg low-latency point beats a zero), and
    a pass climbs while budget remains so the row isn't capped by a
    conservative start."""
    from mediastreamer2_tpu.models.e2e_bench import E2EConferenceBench
    rows = []
    n_rungs = len(LATENCY_LADDER)
    for idx, (K, D, want_confirm) in enumerate(LATENCY_LADDER):
        if _expired(deadline) and rows:
            print("# latency curve: section budget reached — remaining "
                  "rows skipped", file=sys.stderr)
            break
        # Per-rung slice of the remaining section budget: one slow rung
        # (cold compiles) must not starve the later rungs — each rung may use at most its share of what is left.
        rung_dl = deadline
        if deadline is not None:
            rem = deadline - time.perf_counter()
            rung_dl = min(deadline,
                          time.perf_counter() + max(60.0,
                                                    rem / (n_rungs - idx)))
        # smaller K amortizes less transfer: start lower
        n = max(64, min(n_head, n_head * K // 64) // 64 * 64)
        best = None
        last_fail_res = None
        retried_here = False
        first_fail = None
        for _ in range(7):                       # bounded trial budget
            if _expired(rung_dl) and (best or rows):
                break
            t_tr = time.perf_counter()
            res = e2e_trial(n, K, D, blocks=max(12, 256 // max(K, 8)))
            ok = e2e_passes(res)
            print(f"# latency K={K} D={D} n={n}: "
                  f"{None if res is None else round(res.ms_per_tick, 2)} "
                  f"ms/tick late={getattr(res, 'late_ticks', '-')} "
                  f"loss={None if res is None else round(res.loss_rate, 4)} "
                  f"fid={None if res is None else round(res.fidelity, 3)} "
                  f"-> {'PASS' if ok else 'FAIL'} "
                  f"[{time.perf_counter() - t_tr:.0f}s]", file=sys.stderr)
            if ok:
                best = (n, res)
                # climb while budget lasts (at least one 64-leg step:
                # 64*3//2//64*64 == 64 would otherwise cap small starts)
                nxt = max(n + 64, (n * 3 // 2) // 64 * 64)
                if first_fail is not None and nxt >= first_fail:
                    break
                n = nxt
                retried_here = False
                continue
            last_fail_res = res or last_fail_res
            transient = (res is not None and res.fidelity >= 0.9
                         and res.loss_rate < 0.1)
            if transient and not retried_here:
                retried_here = True              # same N once more
                continue
            first_fail = n
            if best is not None or n <= 64:
                break                            # refined enough
            n = max(64, n // 2 // 64 * 64)
            retried_here = False
        confirmed = None
        if best is not None and want_confirm:
            # these rows are REPRODUCED, not hit once: `confirmed` certifies the published point passed TWICE — the
            # search pass + this re-run for best[0]; a demoted point (never
            # visited by the search) must pass two fresh runs before it
            # may claim the flag (a lower confirmed point beats a higher
            # one-off).
            confirmed, n_c = False, best[0]
            passes_needed = 1
            trials_left = 4
            while trials_left > 0:
                if _expired(rung_dl):
                    print(f"# latency K={K} D={D}: confirm cut short by "
                          "rung budget", file=sys.stderr)
                    break
                trials_left -= 1
                res_c = e2e_trial(n_c, K, D,
                                  blocks=max(12, 256 // max(K, 8)))
                ok_c = e2e_passes(res_c)
                print(f"# latency K={K} D={D} n={n_c}: confirm -> "
                      f"{'PASS' if ok_c else 'FAIL'}", file=sys.stderr)
                if ok_c:
                    passes_needed -= 1
                    if passes_needed <= 0:
                        confirmed = True
                        if n_c < best[0]:
                            best = (n_c, res_c)
                        break
                else:
                    n_c = max(64, n_c * 3 // 4 // 64 * 64)
                    passes_needed = 2          # fresh point: two fresh passes
        row = {
            "K": K, "D": D,
            "added_latency_ms": (best[1].mouth_to_ear_ms if best
                                 else E2EConferenceBench.added_latency_ms(K, D)),
            "legs": 0 if best is None else best[0],
            "ms_per_tick": (None if best is None
                            else round(best[1].ms_per_tick, 3)),
        }
        if confirmed is not None:
            row["confirmed"] = confirmed
        if best is None:
            # A zero must read as a diagnosed bind, not silent failure: the
            # oldest in-flight block must complete its device round trip
            # within K*D ticks, and the failed trial's phase breakdown
            # shows what ate the interval.
            row["inflight_budget_ms"] = K * D * 10.0
            if last_fail_res is not None and last_fail_res.phases_ms:
                row["fail_phases_ms"] = last_fail_res.phases_ms
        rows.append(row)
    return rows


def mixed_fleet(n_flagship: int, n_srtp: int, deadline: float = None) -> dict:
    """Heterogeneous co-residency on one GPU: G.711 flagship legs + SRTP legs + opus host-codec
    conference legs + VP8 video sharing the device under one 10 ms beat.
    Default shape: ONE paced loop interleaving all members (FleetTicker,
    models/mixed_fleet.py) — the reference's arbitrary-mix default
    condition (msticker.c:448) re-expressed for a few-core host.

    Search policy: start at a floor that plausibly
    passes, CONFIRM a pass by re-running the same built fleet (cheap: no
    rebuild/recompile), then grow while budget remains; a fail after a
    pass ends the search at the confirmed point.  The artifact reports
    per-class counts, the attempt history, the shape used, and a
    `confirmed` flag certifying the published point passed twice."""
    import os as _os
    from mediastreamer2_tpu.core.factory import Factory
    from mediastreamer2_tpu.models.mixed_fleet import MixedFleetBench
    cores = _os.cpu_count() or 1
    mode = _os.environ.get("MS2TPU_FLEET_MODE", "loop")
    caps = {                       # never grow past the homogeneous halves
        "n_flagship": max(256, n_flagship // 2 // 256 * 256),
        "n_srtp": max(128, n_srtp // 2 // 128 * 128),
        "n_opus": 64, "n_video": 4,
    }
    # few-core hosts start at a small floor that passes reliably and
    # GROW — an early confirmed pass beats opening with a coin-flip fail
    sizes = ({"n_flagship": 128, "n_srtp": 64, "n_opus": 8, "n_video": 1}
             if cores <= 2 else
             {"n_flagship": 512, "n_srtp": 256, "n_opus": 32, "n_video": 2})
    sizes = {k: min(v, caps[k]) for k, v in sizes.items()}
    try:
        from mediastreamer2_tpu.ops import host_codecs as hc
        if not hc.opus_available():
            sizes["n_opus"] = 0
        from mediastreamer2_tpu.ops.vp8 import vp8_available
        if not vp8_available():
            sizes["n_video"] = 0
    except Exception:
        pass

    out = {"error": "no attempt ran", "passes": False}
    attempts = []
    best = None
    fail_at = None                 # smallest flagship size that failed
    floor_retries = 2              # transient-fail retries at the floor
    retried_sizes = set()          # growth sizes granted a transient retry

    def one_fleet(sz):
        """Build+run at sz; on a pass, immediately confirm on the SAME
        instance (no recompile).  Returns (summary, confirmed)."""
        fleet = MixedFleetBench(Factory, k_block=32, depth=3,
                                video_depth=2, **sz)
        try:
            s = fleet.run(seconds=8.0).summary()
            conf = None
            if s.get("passes"):
                s2 = fleet.run(seconds=8.0).summary()
                conf = bool(s2.get("passes"))
                if conf:
                    s = s2                  # publish the confirming run
                s["confirmed"] = conf
            return s, conf
        finally:
            fleet.close()

    for attempt in range(8):       # retries consume attempts; budget gates
        if attempts and _expired(deadline):
            print("# mixed-fleet: section budget reached", file=sys.stderr)
            break
        try:
            out, confirmed = one_fleet(sizes)
        except Exception as e:                       # noqa: BLE001
            print(f"# mixed-fleet failed: {type(e).__name__}: "
                  f"{str(e)[:160]}", file=sys.stderr)
            out = {"error": f"{type(e).__name__}: {str(e)[:160]}",
                   "passes": False}
            confirmed = None
        attempts.append({"sizes": dict(sizes), "passes": out.get("passes"),
                         "confirmed": confirmed})
        print(f"# mixed-fleet attempt {attempt + 1} sizes={sizes}: "
              f"{json.dumps(out)}", file=sys.stderr)
        if "error" in out:
            break                     # errors are structural, not capacity
        if out.get("passes"):
            best = out
            if _expired(deadline):
                break
            # grow toward (not onto) a known-fail point; double otherwise
            fl = sizes["n_flagship"]
            nxt = (min(caps["n_flagship"], (fl + fail_at) // 2 // 128 * 128)
                   if fail_at is not None
                   else min(caps["n_flagship"], fl * 2))
            if nxt <= fl or (fail_at is not None and nxt >= fail_at):
                break                 # at the cap / the edge is bracketed
            sizes = dict(sizes,
                         n_flagship=nxt,
                         n_srtp=min(caps["n_srtp"],
                                    max(64, sizes["n_srtp"] * nxt
                                        // max(fl, 1) // 64 * 64)))
        else:
            # One transient-retry courtesy at ANY size (not just the floor):
            # a single CFS stall cluster (late ticks with full delivery and
            # fidelity) must not halve the published fleet.  Same signature test as
            # the floor retry; each size gets at most one.
            transient_grow = (not out.get("errors")
                              and all((out.get(m) or {}).get("fidelity", 1.0)
                                      >= 0.9
                                      for m in ("flagship", "srtp"))
                              and (out.get("opus") or {}).get(
                                  "delivery", 1.0) >= 0.9)
            if (transient_grow and sizes["n_flagship"] not in retried_sizes
                    and not _expired(deadline)):
                retried_sizes.add(sizes["n_flagship"])
                print("# mixed-fleet: fail at "
                      f"{sizes['n_flagship']} looks transient — retrying",
                      file=sys.stderr)
                continue
            fail_at = (sizes["n_flagship"] if fail_at is None
                       else min(fail_at, sizes["n_flagship"]))
            if best is not None:
                # bisect the pass/fail bracket (same upgrade as the video
                # walk: a 512-pass/1024-fail must not publish 512 with
                # 640-896 unexplored) while the section budget holds
                fl_pass = int((best.get("flagship") or {}).get("legs") or 0)
                nxt = (fl_pass + fail_at) // 2 // 128 * 128
                if nxt <= fl_pass or nxt >= fail_at or _expired(deadline):
                    break             # bracket tight / out of budget
                sizes = dict(sizes,
                             n_flagship=nxt,
                             n_srtp=min(caps["n_srtp"],
                                        max(64, sizes["n_srtp"] * nxt
                                            // max(sizes["n_flagship"], 1)
                                            // 64 * 64)))
                continue
            shrunk = {
                "n_flagship": max(128, sizes["n_flagship"] // 2
                                  // 128 * 128),
                "n_srtp": max(64, sizes["n_srtp"] // 2 // 64 * 64),
                "n_opus": (sizes["n_opus"] // 2 if sizes["n_opus"] > 8
                           else sizes["n_opus"]),
                "n_video": min(sizes["n_video"], 1),
            }
            if shrunk == sizes:
                # At the floor a TRANSIENT-looking fail (audio delivered
                # with full fidelity, only late-tick counts over bar — the
                # signature of a host CFS stall cluster) gets the same one-retry courtesy
                # every homogeneous row already has; the round's #1 row
                # must not die on one scheduler hiccup with zero retries.
                transient = (not out.get("errors")
                             and all((out.get(m) or {}).get("fidelity", 1.0)
                                     >= 0.9
                                     for m in ("flagship", "srtp"))
                             and (out.get("opus") or {}).get(
                                 "delivery", 1.0) >= 0.9)
                if transient and floor_retries > 0 \
                        and not _expired(deadline):
                    floor_retries -= 1
                    print("# mixed-fleet: floor fail looks transient — "
                          "retrying", file=sys.stderr)
                    continue
                break                 # already at the floor
            sizes = shrunk
    if best is not None:
        out = best
    out["host_cores"] = cores
    out["mode"] = mode
    out["attempts"] = attempts
    return out


def video_e2e(deadline: float = None) -> tuple:
    """Largest N video streams (mire -> device pixel path -> VP8 host codec
    -> RTP over localhost UDP -> decode -> device analyse) holding the
    10 ms beat at 15 fps, plus a PLI/FIR loss-recovery pass."""
    from mediastreamer2_tpu.core.factory import Factory
    from mediastreamer2_tpu.models.video_e2e_bench import VideoE2EBench
    best, best_res, recovery = 0, None, False
    n = 4
    retried_at = None
    fail_at = None                 # smallest stream count that failed
    trials = 0
    while 1 <= n <= 256 and trials < 10:
        if trials and _expired(deadline):
            print("# video walk: section budget reached", file=sys.stderr)
            break
        trials += 1
        try:
            b = VideoE2EBench(Factory(), n, codec="vp8", fps=15.0,
                              pipeline_depth=2, frame_tick=True)
            from mediastreamer2_tpu.core.rtgc import paused_gc
            with paused_gc():                 # see e2e_trial's GC note
                res = b.run(seconds=2.5, paced=True)
            ok = res.passes()
            print(f"# video-e2e n={n}: {res.ms_per_tick:.2f} ms/tick "
                  f"late={res.late_ticks} fps_min={res.fps_received_min:.1f} "
                  f"-> {'PASS' if ok else 'FAIL'}", file=sys.stderr)
            if ok and best == 0:
                recovery = b.run_loss_recovery(seconds=1.0)
            b.close()
        except Exception as e:
            print(f"# video-e2e n={n}: failed ({type(e).__name__}: "
                  f"{str(e)[:120]})", file=sys.stderr)
            break
        if not ok:
            # a near-miss (frames flowed, fps just short) gets one retry at
            # the same N — a transient host spike must not zero or
            # halve the row (same policy as the latency-curve rows)
            if (retried_at != n
                    and res.fps_received_min >= 0.5 * res.fps_nominal):
                retried_at = n
                continue
            fail_at = n if fail_at is None else min(fail_at, n)
            if best == 0 and n > 1:
                n //= 2             # walk DOWN: 1 stream beats a zero row
                continue
            # bisect the best..fail gap instead of publishing the last
            # power of two (8 passing with 16 failing leaves 10-14
            # unexplored)
            nxt = (best + fail_at) // 2 // 2 * 2
            if best and best < nxt < fail_at:
                n = nxt
                continue
            break
        best, best_res = n, res
        nxt = (n * 2 if fail_at is None
               else (n + fail_at) // 2 // 2 * 2)
        if nxt <= n or (fail_at is not None and nxt >= fail_at):
            break                   # at the cap / the edge is bracketed
        n = nxt
    return best, best_res, recovery


def mfu_summary() -> dict:
    """Roofline accounting (tools/mfu.py): analytic FLOPs/bytes vs
    measured per-piece time -> utilization against the card's peaks."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tools"))
    import mfu as _mfu
    return _mfu.summarize(8192, _mfu.measure(8192))


def device_vs_cpu() -> dict:
    """GPU-vs-CPU flagship quality equivalence, in this process
    (models/device_check.py)."""
    from mediastreamer2_tpu.models.device_check import device_vs_cpu as run
    return run()


def device_info() -> dict:
    """The accelerator every result is stamped with; refuses to run on
    anything but a GPU (no silent CPU fallback)."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench.py needs an NVIDIA GPU; JAX found "
                         f"{devs[0].platform!r}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def _bench_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "BENCH.json")


def _write_artifact(result: dict):
    try:
        with open(_bench_path(), "w") as f:
            json.dump(result, f)
            f.write("\n")
    except OSError as e:
        print(f"# BENCH.json write failed: {e}", file=sys.stderr)


def _compact_line(result: dict) -> str:
    compact = {k: v for k, v in result.items()
               if k not in ("mfu", "device_vs_cpu", "latency_curve",
                            "mixed_fleet", "e2e_phases_ms",
                            "srtp_phases_ms", "section_s")}
    compact["latency_curve_legs"] = {
        f"{r['added_latency_ms']:g}ms": r["legs"]
        for r in result.get("latency_curve") or []}
    mf = result.get("mixed_fleet") or {}
    compact["mixed_fleet_passes"] = mf.get("passes")
    compact["mixed_fleet_counts"] = {
        k: (v or {}).get("legs", (v or {}).get("streams"))
        for k, v in mf.items()
        if isinstance(v, dict)}
    return json.dumps(compact)


def _arm_hard_deadline(result: dict, deadline_s: float):
    """Last-resort watchdog: if ANY section wedges the device and hangs the
    main thread past `deadline_s`, dump whatever has been measured so far
    (the `result` dict is updated in place after every section) and exit.
    Without this, a wedge inside a main-thread section (e2e search, latency
    curve) produces NO artifact at all — the one failure mode that cost the
    round-3 latency rows. os._exit is deliberate: if we are wedged, the
    device claim is already stale and a clean interpreter teardown would
    hang too."""
    import threading

    def fire():
        print(f"# HARD DEADLINE {deadline_s:.0f}s reached — emitting "
              f"partial artifact and exiting", file=sys.stderr)
        result.setdefault("error", "hard deadline: partial artifact")
        _write_artifact(result)
        print(json.dumps(result), flush=True)
        print(_compact_line(result), flush=True)
        os._exit(0)

    t = threading.Timer(deadline_s, fire)
    t.daemon = True
    t.start()
    return t


def _bounded_section(name, fn, timeout_s: float, fallback):
    """Run a bench section on a daemon thread with a hard wall-clock
    bound.  A section that hangs must cost only ITSELF, never the rows
    already measured — the artifact is written either way.  Returns
    (result, hung)."""
    import threading
    box = {}
    th = threading.Thread(target=lambda: box.update(r=fn()),
                          name=f"bench-{name}", daemon=True)
    th.start()
    th.join(timeout_s)
    if th.is_alive():
        print(f"# {name}: watchdog fired after {timeout_s:.0f}s — "
              f"abandoning section (daemon thread left behind)",
              file=sys.stderr)
        return fallback, True
    return box.get("r", fallback), False


def main():
    from mediastreamer2_tpu import enable_compile_cache
    enable_compile_cache()
    device = device_info()
    skip = set(os.environ.get("BENCH_SKIP", "").split(","))
    budget_s = float(os.environ.get("BENCH_TIME_BUDGET_S", "2400"))
    t_start = time.perf_counter()
    t_end = t_start + budget_s

    # progressive artifact: updated after every section and checkpointed to
    # disk, so a hang in any later section still leaves the measured rows
    result = {
        "metric": ("end-to-end 48kHz AEC+resample+mix G.711 legs per GPU "
                   "over real localhost UDP at 10ms deadline"),
        "value": 0, "unit": "legs", "device": device,
        "partial": True,
    }
    # the hard deadline must fire BEFORE any plausible outer timeout so
    # the capture always ends with a parseable artifact
    deadline_timer = _arm_hard_deadline(result, float(
        os.environ.get("BENCH_HARD_DEADLINE_S", str(budget_s * 1.2 + 240))))

    section_s = {}
    result["section_s"] = section_s
    _t_sec = [time.perf_counter()]

    def checkpoint(section):
        """Per-section bookkeeping: record wall time, persist the artifact,
        and print the COMPACT line so a kill at ANY point still leaves a
        parseable JSON line in the stdout tail."""
        now = time.perf_counter()
        section_s[section] = round(now - _t_sec[0], 1)
        _t_sec[0] = now
        _write_artifact(result)
        print(_compact_line(result), flush=True)

    def sec_deadline(frac_of_remaining: float) -> float:
        """Cooperative deadline for the NEXT section: a fraction of the
        time left in the whole budget (sections that finish early donate
        their slack to later ones; a section that starts late gets a
        proportionally smaller slice)."""
        rem = max(0.0, t_end - time.perf_counter())
        return time.perf_counter() + rem * frac_of_remaining

    def over_budget(section):
        if time.perf_counter() > t_end:
            print(f"# skipping {section}: over time budget", file=sys.stderr)
            skip.add(section)
            return True
        return section in skip

    # Host context the encrypted/host-codec rows must be read against:
    # edge crypto, opus, and VP8 all ride host cores (reference analogue:
    # per-stream ticker threads scale with cores, msticker.c:448)
    result["host_cores"] = os.cpu_count() or 1

    dev_legs, dev_ms = device_only_legs()
    result["device_only_legs"] = int(dev_legs)
    result["device_only_ms_per_tick"] = (None if dev_ms is None
                                         else round(dev_ms, 3))
    checkpoint("device_only")

    n_e2e, res = e2e_legs(deadline=sec_deadline(0.30))
    result.update({
        "value": int(n_e2e),
        "e2e_ms_per_tick": (None if res is None
                            else round(res.ms_per_tick, 3)),
        "e2e_loss_rate": None if res is None else round(res.loss_rate, 5),
        "e2e_fidelity": None if res is None else round(res.fidelity, 4),
        "e2e_added_latency_ms": (None if res is None
                                 else res.mouth_to_ear_ms),
        "e2e_phases_ms": getattr(res, "phases_ms", None),
    })
    checkpoint("e2e")

    n_srtp, res_s = (0, None) if over_budget("srtp") \
        else srtp_e2e(n_e2e or 1024, deadline=sec_deadline(0.25))
    result.update({
        "srtp_e2e_legs": int(n_srtp),
        "srtp_e2e_ms_per_tick": (None if res_s is None
                                 else round(res_s.ms_per_tick, 3)),
        "srtp_e2e_fidelity": (None if res_s is None
                              else round(res_s.fidelity, 4)),
        "srtp_auth_failures": (None if res_s is None
                               else int(res_s.auth_failures)),
        # per-tick phase attribution at the SRTP operating point: the
        # crypto+edge cost reads directly off `edge` vs the cleartext
        # headline's
        "srtp_phases_ms": getattr(res_s, "phases_ms", None),
    })
    checkpoint("srtp")

    # The fleet row runs EARLY (right after the headlines it needs for
    # sizing caps), not last, so an outer timeout cannot eat it; the
    # watchdog bounds a hang.
    fleet_hung = False
    if over_budget("fleet"):
        fleet = {}
    else:
        fl_deadline = sec_deadline(0.35)
        fleet, fleet_hung = _bounded_section(
            "fleet", lambda: mixed_fleet(n_e2e or 1024, n_srtp or 512,
                                         deadline=fl_deadline),
            # the search self-bounds on fl_deadline; the watchdog exists
            # only for a genuine hang (it must not fire mid-search) — give
            # it the section slice plus one attempt
            timeout_s=max(300.0, fl_deadline - time.perf_counter() + 240),
            fallback={"error": "hung (watchdog)", "passes": False})
    result["mixed_fleet"] = fleet
    checkpoint("fleet")

    member_hung = any("hung" in str(v)
                      for v in ((fleet or {}).get("errors") or {}).values())
    if fleet_hung or member_hung:
        # a hung fleet member may hold the device — later sections would
        # hang too; keep what's measured and stop device work (the
        # artifact says why the rows are absent)
        result["error"] = "fleet hung: later device sections skipped"
        skip.update({"latency", "video", "srtp_gcm", "mfu", "corr"})

    curve = [] if over_budget("latency") \
        else latency_curve(n_e2e or 1024, deadline=sec_deadline(0.55))
    result["latency_curve"] = curve
    checkpoint("latency")

    if over_budget("video"):
        n_vid, res_v, rec = 0, None, False
    else:
        n_vid, res_v, rec = video_e2e(deadline=sec_deadline(0.55))
    result.update({
        "video_e2e_streams": int(n_vid),
        "video_e2e_fps_min": (None if res_v is None
                              else round(res_v.fps_received_min, 2)),
        "video_pli_recovery_ok": bool(rec),
    })
    checkpoint("video")

    n_gcm, res_g = (0, None) if over_budget("srtp_gcm") \
        else srtp_e2e(n_srtp or n_e2e or 1024, suite="AEAD_AES_128_GCM",
                      deadline=sec_deadline(0.5))
    result["srtp_gcm_e2e_legs"] = int(n_gcm)
    result["srtp_gcm_e2e_fidelity"] = (None if res_g is None
                                       else round(res_g.fidelity, 4))
    checkpoint("srtp_gcm")

    result["mfu"] = {} if over_budget("mfu") else mfu_summary()
    checkpoint("mfu")

    if "corr" in skip or over_budget("corr"):
        # a hung fleet (or member) may still hold the device
        corr = ({"skipped": "fleet hung"} if (fleet_hung or member_hung)
                else {})
    else:
        corr = device_vs_cpu()
    result["device_vs_cpu"] = corr
    checkpoint("corr")
    result.pop("partial", None)
    result["total_s"] = round(time.perf_counter() - t_start, 1)
    deadline_timer.cancel()

    # Artifact robustness: a capture may keep only a bounded TAIL of stdout, and the full line (mfu/correctness subdicts)
    # can overflow it, cutting off the leading headline fields.  So: (1)
    # persist the full result to BENCH.json on disk, (2) print the full
    # line, (3) print a COMPACT line LAST — short enough that any sane
    # tail capture keeps it intact, with the headline fields parseable.
    _write_artifact(result)
    print(json.dumps(result))
    print(_compact_line(result))


if __name__ == "__main__":
    main()
