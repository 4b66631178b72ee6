"""Host tick loop — the MSTicker re-designed for one-device-step-per-tick.

Reference: src/base/msticker.c — one POSIX thread per ticker, every 10 ms
(`TICKER_INTERVAL`, :46) it runs attached graphs by DFS, measures load
(EWMA of time-in-tick / interval, :486-491) and late ticks (:505-515).

Batched design: the graph is already compiled into one device program,
so the ticker is a host loop that

  1. gathers host-boundary inputs (RTP jitter buffers, files, sound I/O),
  2. launches the (async-dispatched) device step,
  3. publishes outputs/events,
  4. sleeps until the next tick edge.

Scaling doesn't add tickers (reference spawns a thread per stream,
mediastream.c:227-239) — it adds *rows to the batch*.  Throughput mode
(files, tests, benchmarks) free-runs with K ticks fused per device call via
``CompiledGraph.run_scan``.

The reference's MSTickerSynchronizer (slaving the tick clock to a sound
card's sample clock, msticker.c:614-713) is `TickerSynchronizer` below.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from mediastreamer2_tpu.core.block import TICK_MS
from mediastreamer2_tpu.core.events import EventQueue


def start_host_copies(tree) -> None:
    """Start device->host copies for every leaf that supports it (no wait).
    Issuing at pipeline-pop time lets a later read overlap the transfer
    instead of paying one round trip per item; a later read of the same
    values just waits."""
    for v in jax.tree_util.tree_leaves(tree):
        f = getattr(v, "copy_to_host_async", None)
        if f is not None:
            f()


def read_to_host(tree):
    """Device->host readback of a pytree: issue every copy first, then
    wait, so the leaves transfer concurrently."""
    start_host_copies(tree)
    return jax.tree_util.tree_map(np.asarray, tree)


@dataclasses.dataclass
class TickerStats:
    ticks: int = 0
    late_ticks: int = 0
    last_late_tick: int = 0          # cf. ms_ticker_get_last_late_tick
    avg_load: float = 0.0            # EWMA, cf. msticker.c:486-491 (coef 0.9)
    max_step_ms: float = 0.0
    total_step_ms: float = 0.0

    @property
    def mean_step_ms(self) -> float:
        return self.total_step_ms / max(self.ticks, 1)

    def record(self, dt_ms: float, interval_ms: float):
        """Fold one tick's host step time into the beat accounting
        (EWMA load + late-tick telemetry, parity msticker.c:486-515).
        Shared by Ticker and FleetTicker so the two can never drift."""
        self.ticks += 1
        self.total_step_ms += dt_ms
        self.max_step_ms = max(self.max_step_ms, dt_ms)
        self.avg_load = 0.9 * self.avg_load + 0.1 * (dt_ms / interval_ms)
        if dt_ms > interval_ms:
            self.late_ticks += 1
            self.last_late_tick = self.ticks


class _PacedBeat:
    """Shared tick-loop plumbing for Ticker and FleetTicker: realtime
    pacing against absolute edges (cf. wait_next_tick msticker.c:419-445),
    background-thread start/stop, and optional SCHED_RR elevation.
    Subclasses provide do_tick(), drain(), and the realtime/interval_ms/
    name/stats attributes."""

    def _elevate_priority(self):
        """Elevated real-time scheduling for the tick loop, parity with
        ms_ticker_start's SCHED_RR/FIFO escalation (msticker.c:330-399):
        the MS2TPU_TICKER_SCHEDPRIO env var (like MS_TICKER_SCHEDPRIO,
        msticker.c:370) requests a priority; failures degrade gracefully
        to normal scheduling with a log line, exactly like the reference
        falling back when not privileged."""
        import logging
        import os
        prio = os.environ.get("MS2TPU_TICKER_SCHEDPRIO")
        if not prio or not self.realtime:
            return
        try:
            want = min(int(prio), os.sched_get_priority_max(os.SCHED_RR))
            os.sched_setscheduler(0, os.SCHED_RR, os.sched_param(want))
            logging.getLogger(__name__).info(
                "ticker %s: SCHED_RR priority %d", self.name, want)
        except (OSError, PermissionError, ValueError) as e:
            logging.getLogger(__name__).warning(
                "ticker %s: cannot elevate scheduling (%s); continuing "
                "with normal priority", self.name, e)

    def run(self, n_ticks: int):
        """Run n ticks; paced to the interval if realtime, else free-run."""
        self._elevate_priority()
        next_edge = time.perf_counter()
        for _ in range(n_ticks):
            if self._stop.is_set():
                break
            self.do_tick()
            if self.realtime:
                next_edge += self.interval_ms / 1e3
                now = time.perf_counter()
                if now < next_edge:
                    time.sleep(next_edge - now)
                else:
                    next_edge = now
        self.drain()

    def start(self, n_ticks: int = 10**9):
        self._stop.clear()
        self._run_thread = threading.Thread(
            target=self.run, args=(n_ticks,), name=self.name, daemon=True)
        self._run_thread.start()

    def stop(self):
        self._stop.set()
        if self._run_thread:
            self._run_thread.join()
            self._run_thread = None


class Ticker(_PacedBeat):
    # interval_ms is a float contract: pacing, stats and time_ms all use it
    # as float, and frame-tick video legs set fractional intervals
    # (1000/15 ms).
    def __init__(self, graph, name: str = "ticker",
                 interval_ms: float = TICK_MS,
                 realtime: bool = True, event_queue: Optional[EventQueue] = None,
                 pipeline_depth: int = 0, step_fn=None):
        """pipeline_depth > 0 enables double-buffered async dispatch: tick
        t's device step is launched and tick (t - depth)'s outputs are read
        back in the same iteration, so device compute and device<->host
        transfer overlap host I/O instead of serializing (SURVEY §7's
        "double-buffered pinned rings"; the reference hides the same
        latency inside oRTP's jitter buffer).  Outputs reach `io_push`
        `depth` ticks late — callers absorb that as jitter-buffer depth."""
        self.graph = graph
        self.name = name
        self.interval_ms = interval_ms
        self.realtime = realtime
        self.pipeline_depth = pipeline_depth
        self.stats = TickerStats()
        self.event_queue = event_queue or EventQueue()
        self.time_ms = 0             # virtual stream clock, cf. ticker->time
        self.state = graph.init_state()
        self.params = graph.init_params()
        # step_fn overrides the jitted program (e.g. a wrapper that casts
        # the ext boundary to uint8 so frame transfers shrink 4x); it must
        # have graph.step's signature.
        self._step = jax.jit(step_fn or graph.step)
        # warmup_ext: zeros matching what io_pull will actually feed (set
        # it when step_fn changes ext dtypes, or warm_up compiles a program
        # the first real tick never uses)
        self.warmup_ext: Optional[Dict[str, np.ndarray]] = None
        self._io_pull: Optional[Callable[[int], Dict]] = None
        self._io_push: Optional[Callable[[int, Dict], None]] = None
        self._run_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._mutations: list = []
        self._mut_lock = threading.Lock()
        self._tick_lock = threading.RLock()
        self._inflight: list = []    # [(tick, ext_out_futures, ev_futures)]
        # async_publish=True moves the forced device->host readback AND the
        # io_push callback (host codec work, for video legs) onto one
        # worker thread, so the paced tick loop never blocks on transfers
        # — the Ticker-level version of e2e_bench's reader thread. Only
        # meaningful with pipeline_depth > 0; ordering is preserved (single
        # worker). Opt-in: io_push must be thread-compatible.
        self.async_publish = False
        self._publish_pool = None
        self._publish_err: Optional[BaseException] = None
        # always-on per-phase host-time accumulators (sum + max, ms):
        # pull = io_pull (host codec decode / capture), dispatch = the
        # jitted step issuance, publish = pipeline pop + publish/submit.
        # Two extra perf_counter() calls per tick; lets a co-residency
        # trace name WHICH phase of a member's tick eats the shared loop.
        self.phase_ms = {"pull": 0.0, "dispatch": 0.0, "publish": 0.0,
                         "pull_max": 0.0, "dispatch_max": 0.0,
                         "publish_max": 0.0}

    # host I/O callbacks: pull(tick)->ext_in dict, push(tick, ext_out)
    def set_io(self, pull: Optional[Callable] = None, push: Optional[Callable] = None):
        self._io_pull = pull
        self._io_push = push

    def warm_up(self):
        """Pre-compile so the first real tick doesn't blow the deadline
        (the analogue of the reference attaching filters with
        ``preprocess`` before the first tick, msticker.c:145-185)."""
        ext_in = self.warmup_ext if self.warmup_ext is not None else {
            k: np.zeros(shape, dtype) for k, (shape, dtype) in
            self.graph.ext_inputs.items()}
        jax.block_until_ready(self._step(self.state, self.params, ext_in))

    def mutate(self, fn: Callable[["Ticker"], None]):
        """Queue a state/params mutation to run at the next tick boundary —
        the functional replacement for the reference's per-filter lock
        guarding method calls against process() (msfilter.c ms_filter_lock)."""
        with self._mut_lock:
            self._mutations.append(fn)

    def _publish(self, tick: int, ext_out, events):
        """Read outputs/events back to the host and hand them to the app."""
        ext_out, ev_np = read_to_host(
            (ext_out, dict(events) if events else None))
        if self._io_push:
            self._io_push(tick, ext_out)
        if ev_np:
            self.event_queue.post_tensor_events(ev_np, tick)
        return ext_out

    def do_tick(self) -> Dict:
        # one tick at a time: a caller manually ticking while the start()ed
        # run-thread also ticks must serialize — concurrent ticks ran two
        # threads into the same io_push host codec contexts (observed as an
        # intermittent libvpx segfault under the full test suite)
        with self._tick_lock:
            return self._do_tick_locked()

    def _do_tick_locked(self) -> Dict:
        with self._mut_lock:
            muts, self._mutations = self._mutations, []
        for fn in muts:
            fn(self)
        t0 = time.perf_counter()
        ext_in = self._io_pull(self.stats.ticks) if self._io_pull else {
            k: np.zeros(shape, dtype) for k, (shape, dtype) in self.graph.ext_inputs.items()}
        t1 = time.perf_counter()
        self.state, ext_out, events = self._step(self.state, self.params,
                                                 ext_in)
        t2 = time.perf_counter()
        ph = self.phase_ms
        d = (t1 - t0) * 1e3
        ph["pull"] += d
        ph["pull_max"] = max(ph["pull_max"], d)
        d = (t2 - t1) * 1e3
        ph["dispatch"] += d
        ph["dispatch_max"] = max(ph["dispatch_max"], d)
        if self.pipeline_depth > 0:
            # async: dispatch returned immediately; publish the tick that
            # has had `depth` intervals to complete, then return.
            self._inflight.append((self.stats.ticks, ext_out, events))
            if len(self._inflight) > self.pipeline_depth:
                tick, out, ev = self._inflight.pop(0)
                if self.async_publish:
                    # start the D2H copies NOW so the single publish worker
                    # overlaps transfers instead of paying one round-trip
                    # per tick
                    start_host_copies((out, ev))
                    if self._publish_err is not None:
                        err, self._publish_err = self._publish_err, None
                        raise err
                    if self._publish_pool is None:
                        # nice 0 even when created from an elevated paced
                        # thread (an inherited -10 would erase the
                        # paced-vs-worker priority differential)
                        from mediastreamer2_tpu.core.worker import (
                            normal_priority_pool)
                        self._publish_pool = normal_priority_pool(
                            1, f"{self.name}-publish")
                    self._publish_pool.submit(self._publish_guarded,
                                              tick, out, ev)
                    ext_out = {}
                else:
                    ext_out = self._publish(tick, out, ev)
            else:
                ext_out = {}
        else:
            ext_out = self._publish(self.stats.ticks, ext_out, events)
        t3 = time.perf_counter()
        d = (t3 - t2) * 1e3
        ph["publish"] += d
        ph["publish_max"] = max(ph["publish_max"], d)
        self.time_ms += self.interval_ms
        self.stats.record((t3 - t0) * 1e3, self.interval_ms)
        return ext_out

    def drain(self):
        """Publish all in-flight pipelined ticks (call after the last tick).
        Async mode: flush the worker's queued (older) publishes FIRST so
        io_push keeps seeing ticks in order."""
        if self._publish_pool is not None:
            self._publish_pool.shutdown(wait=True)
            self._publish_pool = None
        while self._inflight:
            tick, out, ev = self._inflight.pop(0)
            self._publish(tick, out, ev)
        if self._publish_err is not None:        # surface worker failures
            err, self._publish_err = self._publish_err, None
            raise err

    def _publish_guarded(self, tick, out, ev):
        try:
            self._publish(tick, out, ev)
        except BaseException as e:               # noqa: BLE001
            self._publish_err = e

    def get_average_load(self) -> float:
        return self.stats.avg_load

    # -- checkpoint / resume (cf. media_stream_reclaim_sessions +
    # speexec.c state blobs: survive a stream re-creation warm) ----------
    def save_state(self) -> bytes:
        """Serialize the full graph state tree (every filter's carried
        state: codec predictors, EC taps, ring positions, ...)."""
        import io
        import numpy as np
        buf = io.BytesIO()
        flat = {}
        for node, st in self.state.items():
            for k, v in (st or {}).items():
                arr = jnp.asarray(v)
                key = f"{node}::{k}"
                if arr.dtype == jnp.bfloat16:
                    flat[key + "::bf16"] = np.asarray(
                        arr.astype(jnp.float32))
                else:
                    flat[key] = np.asarray(arr)
        np.savez(buf, **flat)
        return buf.getvalue()

    def load_state(self, blob: bytes):
        """Restore a save_state() snapshot into a compatible graph
        (applied at the next tick boundary)."""
        import io
        import numpy as np
        data = np.load(io.BytesIO(blob))
        tree: Dict[str, dict] = {}
        for key in data.files:
            parts = key.split("::")
            node, k = parts[0], parts[1]
            v = jnp.asarray(data[key])
            if len(parts) == 3 and parts[2] == "bf16":
                v = v.astype(jnp.bfloat16)
            tree.setdefault(node, {})[k] = v

        def apply(tk):
            tk.state = {node: (tree.get(node, st) if st is not None else st)
                        for node, st in tk.state.items()}
        self.mutate(apply)


class FleetTicker(_PacedBeat):
    """Drive SEVERAL compiled graphs from ONE paced loop — heterogeneous
    co-residency on one chip.

    The reference trivially runs arbitrary graph mixes concurrently: every
    stream gets its own ticker thread (msticker.c:448, mediastream.c:227-239)
    and the OS scheduler shares the cores.  The batched equivalent is one
    host loop that interleaves the member graphs' (async-dispatched) device
    programs each tick: XLA queues them on the device stream back-to-back,
    so the fleet fits the deadline iff the members' combined device time
    (plus host I/O) does — which this class MEASURES per member and overall.

    Single-threaded by construction: member do_tick()s are called from the
    fleet loop only, so no two threads ever tick one graph (the c5f8759
    do_tick race cannot occur), while each member's own pipeline_depth /
    async_publish still overlap its transfers.

    `stride` runs a member every Nth fleet tick (e.g. coarse-interval
    members); members keep their own Ticker stats, the fleet keeps the
    combined beat.
    """

    def __init__(self, members=(), interval_ms: int = TICK_MS,
                 realtime: bool = True, name: str = "fleet"):
        self.members: list = []           # [(ticker, stride)]
        self.interval_ms = interval_ms
        self.realtime = realtime
        self.name = name
        self.stats = TickerStats()
        self._stop = threading.Event()
        self._run_thread: Optional[threading.Thread] = None
        for m in members:
            self.add(m)

    def add(self, ticker: Ticker, stride: int = 1):
        """Attach a member; the fleet owns pacing, so the member free-runs
        (its own realtime pacing is disabled)."""
        ticker.realtime = False
        self.members.append((ticker, max(1, int(stride))))
        return ticker

    def warm_up(self):
        for t, _ in self.members:
            t.warm_up()

    def do_tick(self):
        t0 = time.perf_counter()
        for t, stride in self.members:
            if self.stats.ticks % stride == 0:
                t.do_tick()
        self.stats.record((time.perf_counter() - t0) * 1e3, self.interval_ms)

    def drain(self):
        for t, _ in self.members:
            t.drain()


class TickerSynchronizer:
    """Skew estimator slaving tick time to an external sample clock.

    cf. ms_ticker_synchronizer_update (reference: msticker.c:673-698):
    given cumulative samples consumed by a sound device at rate R, estimate
    the offset between the device clock and the wall clock with an EWMA, so
    the tick loop can resample/drop to stay locked.
    """
    def __init__(self, alpha: float = 0.01):
        self.alpha = alpha
        self.skew_ms = 0.0
        self._init = False

    def update(self, nb_samples: int, rate: int, host_time_ms: float) -> float:
        device_time_ms = nb_samples * 1000.0 / rate
        off = host_time_ms - device_time_ms
        if not self._init:
            self.skew_ms = off
            self._init = True
        else:
            self.skew_ms = (1 - self.alpha) * self.skew_ms + self.alpha * off
        return self.skew_ms

    def drift_ms(self, nb_samples: int, rate: int, host_time_ms: float) -> float:
        """Positive => device clock is slow relative to host."""
        return (host_time_ms - nb_samples * 1000.0 / rate) - self.skew_ms
