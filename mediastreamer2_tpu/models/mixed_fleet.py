"""Mixed-fleet co-residency bench: heterogeneous graph classes on ONE chip.

The reference trivially runs arbitrary stream mixes concurrently — G.711
calls + opus calls + video + conferences — because every stream owns a
ticker thread (src/base/msticker.c:448, src/voip/mediastream.c:227-239) and
the OS scheduler shares the cores.  This repo's answer is shape-class
bucketing (SURVEY §7): each class compiles to ONE batched device program,
and co-residency means those programs SHARE the chip under one deadline.

This bench runs the deployment mix for real:

  * ``flagship``: N G.711 legs — device DSP (AEC+AGC+mix-minus) + native
    sendmmsg/GSO UDP edge (models/e2e_bench.py), cleartext.
  * ``srtp``: M more of the same with per-leg SRTP inline on the edge.
  * ``opus``: P host-codec conference legs (libopus encode/decode on the
    host, device conference mix) over per-leg self-looped UDP.
  * ``video``: Q VP8 streams — device pixel path + libvpx + RTP/UDP
    (models/video_e2e_bench.py).

Two co-residency shapes, selected by ``mode`` / ``MS2TPU_FLEET_MODE``:

* ``"loop"`` (default): ONE paced host loop interleaves every member at
  its own cadence — the FleetTicker shape, the right fit for a host with
  few cores.  ALL device dispatch rides one shared uploader worker
  (single-threaded issuance); the loop does only native edge I/O +
  submits; readbacks ride a second nice-0 worker.
* ``"threads"``: each class keeps its own paced loop/ticker on its own
  host thread (the reference's per-stream-ticker shape,
  msticker.c:448) behind a start barrier.  Right on many-core hosts; it
  oversubscribes a host with one core.

A class passes by its own bench's criteria while co-resident; the fleet
passes iff every class does.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import threading
import time
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass
class MixedFleetResult:
    seconds: float
    flagship: Optional[object]          # E2EResult
    srtp: Optional[object]              # E2EResult
    opus: Optional[dict]
    video: Optional[object]             # VideoE2EResult
    errors: Dict[str, str]
    trace: Optional[dict] = None        # loop-mode host-time attribution

    def summary(self) -> dict:
        def _e2e(r):
            return None if r is None else {
                "legs": r.n_legs, "ms_per_tick": round(r.ms_per_tick, 3),
                "late_ticks": r.late_ticks,
                "loss_rate": round(r.loss_rate, 5),
                "fidelity": round(r.fidelity, 4),
                "auth_failures": getattr(r, "auth_failures", 0),
            }
        return {
            "flagship": _e2e(self.flagship),
            "srtp": _e2e(self.srtp),
            "opus": self.opus,
            "video": None if self.video is None else {
                "streams": self.video.n_streams,
                "fps_min": round(self.video.fps_received_min, 2),
                "late_ticks": self.video.late_ticks,
            },
            "errors": self.errors or None,
            "passes": self.passes(),
            "trace": self.trace,
        }

    def passes(self) -> bool:
        if self.errors:
            return False

        def _e2e_ok(r):
            return (r is not None
                    and r.late_ticks <= max(1, r.ticks // 50)
                    and r.ms_per_tick <= 10.0 * 1.03
                    and r.loss_rate < 0.02 and r.fidelity >= 0.9)
        ok = True
        if self.flagship is not None or "flagship" in self.errors:
            ok &= _e2e_ok(self.flagship)
        if self.srtp is not None or "srtp" in self.errors:
            ok &= _e2e_ok(self.srtp) and self.srtp.auth_failures == 0
        if self.opus is not None:
            ok &= (self.opus["late_ticks"] <= max(1, self.opus["ticks"] // 50)
                   and self.opus["delivery"] >= 0.95)
        if self.video is not None:
            ok &= self.video.passes()
        return bool(ok)


def _elevate_paced_thread() -> None:
    """Best-effort SCHED_RR for the calling (paced member) thread.

    Parity with the reference ticker's elevated priority
    (ms_ticker_set_priority, msticker.c:330-399; env MS_TICKER_SCHEDPRIO).

    Default: per-thread niceness -10 (CFS weight ~10x) — the paced thread
    wins the wakeup race at its tick edge but canNOT starve the
    normal-priority publish/codec workers it depends on (CFS always
    schedules everyone).  SCHED_RR is available via MS2TPU_SCHEDPRIO=<prio>
    but is DANGEROUS on a host with one core: an RT loop that falls behind
    stops sleeping (catch-up path) and livelocks the fleet.
    MS2TPU_SCHEDPRIO=0 disables both; non-root / non-Linux silently
    degrade."""
    import os
    import threading
    env = os.environ.get("MS2TPU_SCHEDPRIO", "")
    try:
        prio = int(env) if env else None
        if prio is not None and prio > 0:
            os.sched_setscheduler(0, os.SCHED_RR, os.sched_param(prio))
        elif prio is None:               # default: safe CFS boost
            os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), -10)
    except (AttributeError, OSError, ValueError):
        pass


class MixedFleetBench:
    """Build the classes, compile everything, then run them concurrently."""

    def __init__(self, factory_cls, n_flagship: int = 1024,
                 n_srtp: int = 256, n_opus: int = 32, n_video: int = 2,
                 k_block: int = 32, depth: int = 3,
                 opus_depth: int = 4, video_depth: int = 2):
        """factory_cls: the Factory class (each member builds its own
        instance; registries are cheap and per-class isolation keeps graph
        names independent)."""
        from mediastreamer2_tpu.models.e2e_bench import E2EConferenceBench
        self._members: Dict[str, object] = {}
        self._closers = []
        if n_flagship:
            b = E2EConferenceBench(factory_cls(), n_flagship,
                                   k_block=k_block, pipeline_depth=depth)
            self._members["flagship"] = b
            self._closers.append(b.close)
        if n_srtp:
            b = E2EConferenceBench(factory_cls(), n_srtp, k_block=k_block,
                                   pipeline_depth=depth, srtp=True, seed=7)
            self._members["srtp"] = b
            self._closers.append(b.close)
        if n_opus:
            self._members["opus"] = self._build_opus(factory_cls(), n_opus,
                                                     opus_depth)
        if n_video:
            from mediastreamer2_tpu.models.video_e2e_bench import VideoE2EBench
            b = VideoE2EBench(factory_cls(), n_video, codec="vp8", fps=15.0,
                              pipeline_depth=video_depth, frame_tick=True)
            self._members["video"] = b
            self._closers.append(b.close)

    def _build_opus(self, factory, n: int, depth: int):
        from mediastreamer2_tpu.models.audio_stream import AudioStreamBatch
        from mediastreamer2_tpu.net.rtp import UdpTransport
        rate = 48000
        S = rate // 100
        t = np.arange(S * 100, dtype=np.float32) / rate
        mic = (0.2 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
        ab = AudioStreamBatch(factory, n, codec="opus", rate=rate,
                              conference=True, mic_signal=mic)
        transports = []
        for i in range(n):
            tr = UdpTransport()
            tr.set_remote("127.0.0.1", tr.local_port)      # self-loop
            ab.set_transport(i, tr)
            transports.append(tr)
        if depth:
            ab.ticker.pipeline_depth = depth
            ab.ticker.async_publish = True
        self._closers.append(lambda: [tr.close() for tr in transports])
        return ab

    def close(self):
        for c in self._closers:
            try:
                c()
            except Exception:
                pass

    def _warm_all(self):
        """Compile everything serially (the device is shared) so compile
        time never lands inside another member's paced window."""
        for name in ("flagship", "srtp"):
            if name in self._members:
                self._members[name].warm()
        if "opus" in self._members:
            self._members["opus"].ticker.warm_up()
        if "video" in self._members:
            self._members["video"].vs.ticker.warm_up()

    def run(self, seconds: float = 8.0,
            mode: Optional[str] = None) -> MixedFleetResult:
        """Compile all members, then run every class concurrently for
        `seconds` of paced wall time; returns per-class results.
        mode: "loop" (one paced host loop, default) or "threads"
        (per-member paced threads); MS2TPU_FLEET_MODE overrides."""
        mode = mode or os.environ.get("MS2TPU_FLEET_MODE", "loop")
        self._warm_all()
        if mode == "loop":
            return self._run_loop(seconds)
        return self._run_threads(seconds)

    def _run_threads(self, seconds: float) -> MixedFleetResult:
        """Per-member paced threads behind one start barrier (the
        reference's per-stream-ticker shape)."""
        results: Dict[str, object] = {}
        errors: Dict[str, str] = {}
        barrier = threading.Barrier(len(self._members))

        def guarded(name, fn):
            try:
                _elevate_paced_thread()
                barrier.wait(timeout=120)
                results[name] = fn()
            except Exception as e:                     # noqa: BLE001
                errors[name] = f"{type(e).__name__}: {str(e)[:200]}"

        def run_e2e(b):
            blocks = max(3, int(seconds * 100 / b.K))
            return lambda: b.run(blocks, paced=True)

        def run_opus(ab):
            def go():
                tk = ab.ticker
                tk.realtime = True
                n_ticks = int(seconds * 100)
                sent0 = sum(s.stats.sent_packets for s in ab.sessions if s)
                recv0 = sum(s.stats.recv_packets for s in ab.sessions if s)
                base_late, base_ticks = tk.stats.late_ticks, tk.stats.ticks
                tk.run(n_ticks)
                tk.drain()
                _drain_until_stable(ab.sessions)
                return _opus_summary(ab, sent0, recv0, base_late, base_ticks)
            return go

        def run_video(b):
            return lambda: b.run(seconds=max(1.0, seconds - 1.0),
                                 paced=True, warmup_seconds=1.0)

        runners = {}
        for name, m in self._members.items():
            fn = {"flagship": run_e2e, "srtp": run_e2e,
                  "opus": run_opus, "video": run_video}[name](m)
            runners[name] = threading.Thread(
                target=guarded, args=(name, fn), name=f"fleet-{name}",
                daemon=True)
        from mediastreamer2_tpu.core.rtgc import paused_gc
        with paused_gc():
            for th in runners.values():
                th.start()
            # a member must NEVER hang the fleet (a hung join here would
            # cost the whole bench artifact): bounded join, report the
            # straggler as an error and move on (threads are daemonic)
            deadline = time.monotonic() + seconds * 3 + 240
            for name, th in runners.items():
                th.join(timeout=max(5.0, deadline - time.monotonic()))
                if th.is_alive():
                    errors[name] = "hung (member did not finish in time)"
        return MixedFleetResult(
            seconds=seconds,
            flagship=results.get("flagship"),
            srtp=results.get("srtp"),
            opus=results.get("opus"),
            video=results.get("video"),
            errors=errors)

    def _run_loop(self, seconds: float) -> MixedFleetResult:
        """ONE paced host loop interleaving every member at its own cadence
        (the FleetTicker shape, core/ticker.py:FleetTicker generalized to
        per-member intervals and the e2e steppers).

        The loop itself issues NO device commands: every member's device
        dispatch (e2e K-blocks, opus/video do_tick) rides the ONE shared
        uploader worker, so issuance is single-threaded by construction.
        The loop only does native edge I/O and submits.
        Missed edges are skipped forward (late accounting, never a burst
        catch-up), exactly like _PacedBeat.run."""
        from mediastreamer2_tpu.core.worker import (normal_priority_pool,
                                                    priority_pool)
        from mediastreamer2_tpu.models.e2e_bench import E2EStepper
        results: Dict[str, object] = {}
        errors: Dict[str, str] = {}
        # dispatch worker at nice -5: between the paced loop (-10) and the
        # publish/codec pools (0) — it executes every member's deadline
        # work, so it must not lose the CPU race to pipeline-buffered
        # publish work (see worker.priority_pool)
        uploader = priority_pool(1, "fleet-upload", nice=-5)
        reader = normal_priority_pool(1, "fleet-read")
        steppers: Dict[str, object] = {}
        try:
            for name in ("flagship", "srtp"):
                if name in self._members:
                    b = self._members[name]
                    n_blocks = max(b.default_warmup_blocks() + 3,
                                   int(seconds * 100 / b.K))
                    steppers[name] = E2EStepper(b, uploader, reader,
                                                n_blocks)
            if "opus" in self._members:
                steppers["opus"] = _OpusStepper(self._members["opus"],
                                                seconds, uploader)
            if "video" in self._members:
                steppers["video"] = _VideoStepper(self._members["video"],
                                                  seconds, uploader)
            _elevate_paced_thread()          # the loop IS the paced thread
            # A gen-2 GC pause can take ~100 ms — one pause blows every
            # member's 10 ms edge at once (core/rtgc.py).
            from mediastreamer2_tpu.core.rtgc import paused_gc
            gc_guard = contextlib.ExitStack()
            gc_guard.enter_context(paused_gc())
            # Cap worker-thread GIL holds at 1 ms: the paced loop's sleep
            # wakeups otherwise slip behind dispatch/codec Python frames
            # on a 1-core host (measured as whole-interval edge misses).
            import sys as _sys
            switch0 = _sys.getswitchinterval()
            _sys.setswitchinterval(0.001)
            # per-member host-time attribution (MS2TPU_FLEET_TRACE=1, or
            # always-on cheap counters): names which member's tick() work
            # is eating the shared loop when a co-resident run goes late
            tick_s = {n: 0.0 for n in steppers}
            tick_max = {n: 0.0 for n in steppers}
            tick_n = {n: 0 for n in steppers}
            sleep_s = 0.0
            stalls: list = []       # (t_rel_s, member, behind_ms) capped
            t_loop0 = time.perf_counter()
            now = time.perf_counter()
            # small start stagger so members' edge work interleaves; srtp
            # additionally starts HALF a K-block after flagship so their
            # block-boundary ticks (the loop's costliest, pipeline swap +
            # submit) alternate instead of stacking inside one 10 ms
            # window and stealing the opus/video edges
            edges = {n: now + 0.002 * i for i, n in enumerate(steppers)}
            if "flagship" in steppers and "srtp" in steppers:
                half_block_s = (steppers["srtp"].interval_ms / 1e3
                                * self._members["srtp"].K / 2)
                edges["srtp"] += half_block_s
            order = list(steppers)
            active = set(order)
            while active:
                now = time.perf_counter()
                nxt = min(edges[n] for n in active)
                if nxt > now:
                    time.sleep(nxt - now)
                    t_w = time.perf_counter()
                    sleep_s += t_w - now
                    now = t_w
                for name in order:
                    if name not in active or edges[name] > now + 5e-4:
                        continue
                    iv = steppers[name].interval_ms / 1e3
                    late_by = 0
                    behind = now - edges[name]
                    if behind > iv:
                        late_by = int(behind / iv)
                        edges[name] = now    # skip forward, count the miss
                        if len(stalls) < 24:
                            stalls.append((round(now - t_loop0, 3), name,
                                           round(behind * 1e3, 1)))
                    try:
                        alive = steppers[name].tick(late_by)
                    except Exception as e:                 # noqa: BLE001
                        errors[name] = (f"{type(e).__name__}: "
                                        f"{str(e)[:200]}")
                        active.discard(name)
                        continue
                    edges[name] += iv
                    if not alive:
                        active.discard(name)
                    t_d = time.perf_counter()
                    d = t_d - now
                    tick_s[name] += d
                    tick_max[name] = max(tick_max[name], d)
                    tick_n[name] += 1
                    now = t_d
            loop_wall = time.perf_counter() - t_loop0
            self.loop_trace = {
                "wall_s": round(loop_wall, 3),
                "sleep_s": round(sleep_s, 3),
                "busy_other_s": round(loop_wall - sleep_s
                                      - sum(tick_s.values()), 3),
                "per_member_ms_mean": {
                    n: round(tick_s[n] * 1e3 / max(tick_n[n], 1), 3)
                    for n in steppers},
                "per_member_ms_max": {n: round(tick_max[n] * 1e3, 2)
                                      for n in steppers},
                "per_member_busy_s": {n: round(tick_s[n], 3)
                                      for n in steppers},
                "per_member_worker": {
                    n: st.worker_trace() for n, st in steppers.items()
                    if hasattr(st, "worker_trace")},
                # loop-wake stall events (first 24): clustering in time
                # means ONE host stall charged every member at once
                "stalls": stalls,
            }
            for name, st in steppers.items():
                if name in errors:
                    continue
                try:
                    results[name] = st.finish()
                except Exception as e:                     # noqa: BLE001
                    errors[name] = f"{type(e).__name__}: {str(e)[:200]}"
        finally:
            import sys as _sys2
            try:
                _sys2.setswitchinterval(switch0)
            except NameError:        # failed before the loop set it up
                pass
            try:
                gc_guard.close()
            except NameError:
                pass
            uploader.shutdown(wait=True)
            reader.shutdown(wait=True)
        return MixedFleetResult(
            seconds=seconds,
            flagship=results.get("flagship"),
            srtp=results.get("srtp"),
            opus=results.get("opus"),
            video=results.get("video"),
            errors=errors,
            trace=getattr(self, "loop_trace", None))


def _drain_until_stable(sessions, max_wait_s: float = 2.0,
                        quiet_polls: int = 3, poll_s: float = 0.03) -> None:
    """Poll sessions until recv counts stop changing (bounded).

    The opus fleet class's delivery oracle previously slept a fixed 50 ms
    and polled ONCE after drain — any in-flight self-loop tail beyond that
    counted as loss.  Steady state = `quiet_polls` consecutive unchanged
    counts; bounded by max_wait_s so a dead socket can't hang the fleet."""
    last, quiet = -1, 0
    deadline = time.monotonic() + max_wait_s
    while time.monotonic() < deadline:
        for s in sessions:
            if s:
                s.poll()
        cur = sum(s.stats.recv_packets for s in sessions if s)
        if cur == last:
            quiet += 1
            if quiet >= quiet_polls:
                return
        else:
            quiet, last = 0, cur
        time.sleep(poll_s)


def _opus_summary(ab, sent0: int, recv0: int, base_late: int,
                  base_ticks: int) -> dict:
    tk = ab.ticker
    sent = sum(s.stats.sent_packets for s in ab.sessions if s) - sent0
    recv = sum(s.stats.recv_packets for s in ab.sessions if s) - recv0
    return {
        "legs": ab.batch, "ticks": tk.stats.ticks - base_ticks,
        "late_ticks": tk.stats.late_ticks - base_late,
        "sent_packets": sent, "recv_packets": recv,
        # self-loop: everything sent must come back — delivery is the
        # class's loss oracle (drained to steady state first)
        "delivery": round(min(1.0, recv / max(sent, 1)), 4),
    }


class _TickerStepper:
    """Fleet-loop driver base for ticker-owned members (opus, video).

    tick() only SUBMITS the member's do_tick to the shared dispatch
    worker: inline dispatch (the jit call + transfer issuance) on the
    shared loop steals every other member's edges.  Routing through the
    ONE shared worker keeps device-command issuance single-threaded and
    preserves tick order (FIFO executor).  Backlog is bounded: when the worker falls
    MAX_BACKLOG ticks behind, the edge is skipped and counted late —
    deadline-honest, like the reference ticker's late accounting
    (msticker.c:448)."""

    MAX_BACKLOG = 4

    def __init__(self, ticker, worker):
        ticker.realtime = False              # the fleet loop owns pacing
        self._tk = ticker
        self._worker = worker
        self._pending: collections.deque = collections.deque()
        # worker-side do_tick cost (the time the shared dispatch worker is
        # OCCUPIED per tick — queueing theory input for backlog lateness)
        self.w_ms_sum = 0.0
        self.w_ms_max = 0.0
        self.w_n = 0
        self.late_wake = 0      # fleet loop behind at this member's edge
        self.late_backlog = 0   # worker >MAX_BACKLOG ticks behind

    def _timed_tick(self):
        t0 = time.perf_counter()
        out = self._tk.do_tick()
        d = (time.perf_counter() - t0) * 1e3
        self.w_ms_sum += d
        self.w_ms_max = max(self.w_ms_max, d)
        self.w_n += 1
        return out

    def _reap(self) -> None:
        """Drop completed do_tick futures, re-raising worker errors on
        the fleet loop (where the member gets error-discarded)."""
        while self._pending and self._pending[0].done():
            self._pending.popleft().result()

    def _submit_tick(self) -> bool:
        """Submit one do_tick unless backlogged; True if submitted."""
        self._reap()
        if len(self._pending) >= self.MAX_BACKLOG:
            return False
        self._pending.append(self._worker.submit(self._timed_tick))
        return True

    def worker_trace(self) -> dict:
        ph = getattr(self._tk, "phase_ms", None)
        out = {"worker_ms_mean": round(self.w_ms_sum / max(self.w_n, 1), 3),
               "worker_ms_max": round(self.w_ms_max, 2),
               "late_wake": self.late_wake,
               "late_backlog": self.late_backlog}
        if ph and self.w_n:
            out["phase_ms_mean"] = {k: round(ph[k] / self.w_n, 3)
                                    for k in ("pull", "dispatch", "publish")}
            out["phase_ms_max"] = {k: round(ph[k + "_max"], 2)
                                   for k in ("pull", "dispatch", "publish")}
        return out

    def _flush(self) -> None:
        while self._pending:
            self._pending.popleft().result()


class _OpusStepper(_TickerStepper):
    """Fleet-loop driver for the opus host-codec class (AudioStreamBatch
    ticker at the 10 ms beat), dispatching via the shared worker."""

    def __init__(self, ab, seconds: float, worker):
        super().__init__(ab.ticker, worker)
        self.ab = ab
        tk = ab.ticker
        self.interval_ms = float(tk.interval_ms)
        self.total = max(1, int(seconds * 1000.0 / self.interval_ms))
        self.i = 0
        self.fleet_late = 0
        self._sent0 = sum(s.stats.sent_packets for s in ab.sessions if s)
        self._recv0 = sum(s.stats.recv_packets for s in ab.sessions if s)
        self._base_late = tk.stats.late_ticks
        self._base_ticks = tk.stats.ticks

    def tick(self, late_by: int = 0) -> bool:
        if self.i >= self.total:
            return False
        self.fleet_late += late_by
        self.late_wake += late_by
        if not self._submit_tick():
            self.fleet_late += 1             # backlogged = missed cadence
            self.late_backlog += 1
        self.i += 1
        return self.i < self.total

    def finish(self) -> dict:
        self._flush()
        tk = self.ab.ticker
        tk.drain()
        _drain_until_stable(self.ab.sessions)
        out = _opus_summary(self.ab, self._sent0, self._recv0,
                            self._base_late, self._base_ticks)
        # fold fleet-loop missed edges into the class's lateness (the
        # member's own stats only see host step time, not loop backlog)
        out["late_ticks"] += self.fleet_late
        return out


class _VideoStepper(_TickerStepper):
    """Fleet-loop driver for the video class: the member ticks at its own
    frame cadence (fractional interval) inside the shared loop, with
    do_tick dispatched via the shared worker; fps is measured over the
    steady-state window after a warmup cut, matching VideoE2EBench.run().
    The steady-state snapshot is itself a worker task so it is FIFO-ordered
    with the do_ticks it delimits."""

    def __init__(self, bench, seconds: float, worker,
                 warmup_seconds: float = 1.0):
        super().__init__(bench.vs.ticker, worker)
        self.b = bench
        tk = bench.vs.ticker
        self.interval_ms = float(tk.interval_ms)
        self.total = max(2, int(seconds * bench.ticks_per_s))
        self.warm_ticks = max(1, int(warmup_seconds * bench.ticks_per_s))
        self.i = 0
        self.fleet_late = 0
        self._snap_fut = None

    def _take_snap(self):
        b, tk = self.b, self.b.vs.ticker
        return (time.perf_counter(), tk.stats.ticks, tk.stats.late_ticks,
                [s.frames_received for s in b.vs.stats])

    def tick(self, late_by: int = 0) -> bool:
        if self.i >= self.total:
            return False
        if self.i == self.warm_ticks:
            self._snap_fut = self._worker.submit(self._take_snap)
        if self.i >= self.warm_ticks:
            self.fleet_late += late_by
            self.late_wake += late_by
        if not self._submit_tick() and self.i >= self.warm_ticks:
            self.fleet_late += 1             # backlogged = missed cadence
            self.late_backlog += 1
        self.i += 1
        return self.i < self.total

    def finish(self):
        from mediastreamer2_tpu.models.video_e2e_bench import VideoE2EResult
        self._flush()
        b = self.b
        tk = b.vs.ticker
        tk.drain()
        t_end = time.perf_counter()
        snap = (self._snap_fut.result() if self._snap_fut is not None
                else (t_end, tk.stats.ticks, tk.stats.late_ticks,
                      [s.frames_received for s in b.vs.stats]))
        t0, base_ticks, base_late, base_rx = snap
        wall = max(t_end - t0, 1e-9)
        ticks = tk.stats.ticks - base_ticks
        rx = np.array([s.frames_received - r0
                       for s, r0 in zip(b.vs.stats, base_rx)], float)
        fps_rx = rx / wall
        luma = b.vs._last_rx
        luma_ok = bool((np.abs(luma).mean(
            axis=(1, 2, 3) if luma.ndim == 4 else (1, 2)) > 0.05).all())
        return VideoE2EResult(
            n_streams=b.vs.batch, ticks=ticks,
            ms_per_tick=wall * 1e3 / max(ticks, 1),
            late_ticks=(tk.stats.late_ticks - base_late) + self.fleet_late,
            fps_nominal=b.fps,
            fps_received_min=float(fps_rx.min()) if len(fps_rx) else 0.0,
            fps_received_mean=float(fps_rx.mean()) if len(fps_rx) else 0.0,
            luma_ok=luma_ok)
