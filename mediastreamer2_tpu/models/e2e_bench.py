"""End-to-end conference bench: real UDP RTP legs through the device graph.

The served form of the flagship benchmark:
every leg's audio actually crosses the network edge both ways each tick —

  [device] mix/AEC output -> ulaw -> (download) -> BatchRtpTx -> localhost UDP
  localhost UDP -> BatchRtpRx (recvmmsg+GRO, jitter ring) -> (upload)
  -> ulaw decode -> resample 8k->48k -> AEC -> AGC -> mix-minus -> ...

matching the reference's bench shape (tools/bench.c:69-80: fileplay->enc->
RTP->dec->record legs over localhost, stacked until the ticker misses) plus
the conference DSP (audioconference.c semantics).

Topology: self-loop — leg i's RTP output is addressed to leg i's own SSRC
on the shared receive socket, so traffic is self-sustaining and every tick
moves N packets each way.  Device work is blocked K ticks per call with a
D-deep pipeline; K=1 gives per-tick dispatch over PCIe, larger K amortizes
launch and transfer overhead (mouth-to-ear latency grows by K*(D+1) ticks —
recorded in the result, not hidden).

Fidelity: legs 0..3 record on device both the payload they transmitted and
the payload they later received+decoded; `audio_diff` between the two
streams (cross-correlation, the reference's ms_audio_diff oracle) asserts
the transport path delivered the right audio in the right order.
"""
from __future__ import annotations

import dataclasses
import socket
import time
from typing import Optional

import jax
import numpy as np

from mediastreamer2_tpu.core.block import Format, tick_samples
from mediastreamer2_tpu.core.graph import GraphBuilder
from mediastreamer2_tpu.core.ticker import read_to_host, start_host_copies

FIDELITY_LEGS = 4


def build_e2e_graph(factory, batch: int, rate: int = 48000,
                    conf_size: int = 4, tail_ms: int = 80,
                    mix_rate: int = 16000):
    """Device program for one tick: decoded-rx + mic -> flagship chain -> 8k out.

    rx path feeds the AEC far-end (the speaker reference) exactly as the
    reference wires rtprecv->decoder->soundwrite + EC.1 capture
    (src/voip/audiostream.c:1812-1832).  The EC->AGC->resample->mix core IS
    models/flagship.py's graph (same topology, same 16 kHz mix) so the
    device-only and e2e benchmarks differ only by the codec boundary and
    transfer."""
    g = GraphBuilder(factory, batch=batch)
    rx = g.add("ext_source", "rx", fmt=Format(rate=8000))   # decoded 8 kHz
    mic = g.add("ext_source", "mic", fmt=Format(rate=rate))
    up = g.add("resample", "up", out_rate=rate)
    ec = g.add("echo_canceller", "ec", tail_ms=tail_ms)
    agc = g.add("volume", "agc")
    rs = g.add("resample", "rs", out_rate=mix_rate)
    mix = g.add("conf_mixer", "conf", sorted_groups=True,
                uniform_group_size=conf_size)
    dn = g.add("resample", "dn", out_rate=8000)
    out = g.add("ext_sink", "out")
    g.link(rx, 0, up, 0)
    g.link(mic, 0, ec, 0)
    g.link(up, 0, ec, 1)
    g.chain(ec, agc, rs, mix, dn, out)
    cg = g.build()
    params = cg.init_params()
    import jax.numpy as jnp
    params["agc"]["agc_enabled"] = jnp.ones((batch,), bool)
    params["conf"]["group_id"] = jnp.asarray(
        np.arange(batch, dtype=np.int32) // conf_size)
    return cg, params


@dataclasses.dataclass
class E2EResult:
    n_legs: int
    ticks: int
    k_block: int
    pipeline_depth: int
    ms_per_tick: float          # sustained wall time per tick, host+device+net
    late_ticks: int             # tick edges missed by > 1 interval
    loss_rate: float            # jitter-buffer misses after warmup
    fidelity: float             # audio_diff(sent, received) on probe legs
    mouth_to_ear_ms: float      # added pipeline latency (K*(D+1) + prefill)
    srtp: bool = False          # per-leg AES_CM_128_HMAC_SHA1_80 on the edge
    auth_failures: int = 0      # SRTP auth failures across all legs
    # per-tick phase attribution (ms), present when run(trace=True):
    # edge_tx = pack/protect/sendmmsg, edge_rx = recvmmsg/verify/decrypt/
    # jitter-insert, submit = staging copy + uploader handoff, pop = wait
    # on the oldest in-flight block's device round trip.  The SRTP-vs-
    # cleartext capacity delta reads directly off edge_tx/edge_rx.
    phases_ms: Optional[dict] = None

    @property
    def realtime_ok(self) -> bool:
        return self.ms_per_tick <= 10.0


class E2EConferenceBench:
    """N self-looped G.711 conference legs over real localhost UDP."""

    @staticmethod
    def prefill_for(k_block: int) -> int:
        """Jitter-ring priming: small-K (low-latency) configs pace per tick
        and need less slack than big blocked configs."""
        return max(3, k_block // 2) if k_block <= 8 else max(8, k_block // 2)

    @classmethod
    def added_latency_ms(cls, k_block: int, depth: int) -> float:
        """Mouth-to-ear latency this (K, D) config adds — the single source
        for bench.py's latency-curve reporting."""
        return (k_block * (depth + 1) + cls.prefill_for(k_block)) * 10.0

    def __init__(self, factory, n_legs: int, k_block: int = 16,
                 pipeline_depth: int = 2, conf_size: int = 4,
                 rate: int = 48000, seed: int = 0, srtp: bool = False,
                 srtp_suite: str = "AES_CM_128_HMAC_SHA1_80",
                 adaptive_prefill: bool = True):
        import jax.numpy as jnp
        from mediastreamer2_tpu.ops.g711 import (ulaw_decode, ulaw_encode,
                                                 float_to_pcm16,
                                                 pcm16_to_float)
        from mediastreamer2_tpu.native import BatchRtpTx, BatchRtpRx

        self.n = n_legs
        self.K = k_block
        self.D = pipeline_depth
        self.S8 = tick_samples(8000)                    # 80
        S48 = tick_samples(rate)
        self.cg, self.params = build_e2e_graph(factory, n_legs,
                                               rate=rate, conf_size=conf_size)
        self.state = self.cg.init_state()

        rng = np.random.default_rng(seed)
        mic0 = (0.05 * rng.standard_normal((n_legs, S48))).astype(np.float32)
        mic0_dev = jnp.asarray(mic0)
        cgstep, params = self.cg.step, self.params
        K = self.K

        def body(carry, xt):
            st, t = carry
            dec = pcm16_to_float(ulaw_decode(xt.astype(jnp.int32)))
            ext = {"rx": dec, "mic": jnp.roll(mic0_dev, t * 7, axis=1)}
            st, out, _ = cgstep(st, params, ext)
            tx = ulaw_encode(float_to_pcm16(out["out"])).astype(jnp.uint8)
            probe = (tx[:FIDELITY_LEGS], dec[:FIDELITY_LEGS])
            return (st, t + 1), (tx, probe)

        S8 = self.S8

        @jax.jit
        def run_block(st, t0, xs):                       # xs: [K,N,80] u8
            (st, t), (txs, probes) = jax.lax.scan(body, (st, t0), xs)
            # pack payloads + both probe streams into ONE u8 buffer so the
            # reader forces a single device->host transfer per block instead
            # of three sequential readbacks
            ptx, prx = probes
            prx_u8 = jax.lax.bitcast_convert_type(
                prx, jnp.uint8).reshape(xs.shape[0], -1, S8)
            packed = jnp.concatenate([txs, ptx, prx_u8], axis=1)
            return st, t, packed

        self._run_block = run_block
        self._t_dev = jnp.asarray(0, jnp.int32)

        # --- network edge -------------------------------------------------
        tx_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        tx_sock.bind(("127.0.0.1", 0))
        rx_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        rx_sock.bind(("127.0.0.1", 0))
        rx_sock.setblocking(False)
        for s in (tx_sock, rx_sock):
            try:
                s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 24)
                s.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 1 << 24)
            except OSError:
                pass
        port = rx_sock.getsockname()[1]
        # packets arrive paced (one per leg per tick), so the ring only
        # needs slack for scheduling hiccups at block boundaries — NOT the
        # whole pipeline depth (the self-loop's latency shows up as stream
        # offset, which seq-keyed playout absorbs for free).
        self.prefill = self.prefill_for(self.K)
        depth = 1 << max(6, (self.prefill * 4 - 1).bit_length())
        self.tx = BatchRtpTx(tx_sock, n_legs, self.S8)
        self.rx = BatchRtpRx(n_legs, self.S8, ring_depth=depth)
        self.rx.add_socket(rx_sock, gro=True)
        # Per-leg SRTP (AES_CM_128_HMAC_SHA1_80): protect on the batched tx,
        # auth+decrypt before the jitter-ring insert on rx — the encrypted
        # operating point the reference runs by default (ms_srtp.cpp inline
        # protection). Self-loop => leg i's tx and rx share key material.
        self.srtp = srtp
        key_rng = np.random.default_rng(seed + 1)
        if srtp:
            from mediastreamer2_tpu.net.srtp import SUITES
            _, klen, slen, _ = SUITES[srtp_suite]
        for i in range(n_legs):
            self.tx.config(i, "127.0.0.1", port, ssrc=i, pt=0)
            self.rx.map_ssrc(i, i)
            self.rx.set_prefill(i, self.prefill)
            if srtp:
                mk, ms = key_rng.bytes(klen), key_rng.bytes(slen)
                self.tx.set_srtp(i, mk, ms, srtp_suite)
                self.rx.set_srtp(i, mk, ms, srtp_suite)
        self.tx.enable_gso(("127.0.0.1", port))
        # Shard the edge (pack+SRTP+syscalls each way) across host worker
        # threads when cores are available — the batched analogue of the
        # reference's one-ticker-thread-per-stream scaling (msticker.c:448).
        # MS2TPU_EDGE_THREADS overrides; 1-core hosts stay single-threaded.
        import os as _os
        t = int(_os.environ.get("MS2TPU_EDGE_THREADS", "0")) \
            or min(8, _os.cpu_count() or 1)
        self.edge_threads = t
        if t > 1:
            self.tx.set_threads(t)
            self.rx.set_threads(t)
        self._socks = (tx_sock, rx_sock)
        self._sent_probe: list = []
        self._recv_probe: list = []
        # Adaptive prefill, WARMUP ONLY (net/jitter.py controller): the
        # heuristic prefill_for() start can be one packet short for the
        # host's scheduling jitter and a single refill gap then fails the
        # whole trial.  During the warmup blocks the controller walks each leg's
        # prefill up on observed misses; it is FROZEN before the measured
        # window so the added latency reported is the converged value, not
        # a moving target.
        self.adaptive_prefill = adaptive_prefill
        self._jitter_ctrl = None

    def close(self):
        for s in self._socks:
            s.close()
        self.tx.close()
        self.rx.close()

    def warm(self):
        """Compile + first-execute the device block (idempotent).  Call
        before a co-resident run so compile time never lands inside
        another member's paced window (models/mixed_fleet.py)."""
        if getattr(self, "_warmed", False):
            return
        jax.block_until_ready(self._run_block(
            self.state, self._t_dev,
            np.full((self.K, self.n, self.S8), 0xFF, np.uint8)))
        self._warmed = True

    def default_warmup_blocks(self) -> int:
        """Blocks to exclude from measurement: pipeline fill + jitter-ring
        priming (shared by run() and E2EStepper so the two paths can never
        drift)."""
        return self.D + 2 + (self.prefill + self.K - 1) // self.K

    def _fetch(self, packed):
        """Force the ONE packed device->host transfer for a block and split
        it into (tx payloads, sent probe, recv probe) — see run_block's
        packing note.  Runs on the reader worker."""
        N, K, S8 = self.n, self.K, self.S8
        nprobe = min(FIDELITY_LEGS, N)
        a = read_to_host(packed)
        txs = a[:, :N]
        # .copy(): sent probes are retained for the whole trial — a view
        # would pin each block's full packed buffer (MBs) for ~10 KB
        sent_p = a[:, N:N + nprobe].copy()
        recv_p = np.ascontiguousarray(a[:, N + nprobe:]).reshape(
            K, nprobe, S8, 4).view(np.float32)[..., 0]
        return txs, sent_p, recv_p

    def _gpu_block(self, stage_copy, reader):
        """Upload + dispatch one K-tick block (uploader worker), handing
        the transfer-forcing fetch to the reader worker.

        The D2H copy is ISSUED here, at dispatch time — not when the reader
        reaches the block.  With one reader worker, reads serialize; if each
        read also had to issue its own copy, every block would cost a full
        round trip on the reader.  Issued here, all in-flight blocks'
        copies overlap and the reader's wait is bandwidth-bound."""
        x = jax.device_put(stage_copy)
        self.state, self._t_dev, packed = self._run_block(
            self.state, self._t_dev, x)
        start_host_copies(packed)
        return reader.submit(self._fetch, packed)

    def make_jitter_ctrl(self):
        """Warmup-only adaptive prefill controller (see __init__ note)."""
        from mediastreamer2_tpu.net.jitter import BatchEdgeJitterController
        return BatchEdgeJitterController(
            self.rx, self.n, min_prefill=self.prefill,
            max_prefill=self.prefill + 8,
            shrink_after=10 ** 9,            # no shrink inside a trial
            apply_initial=False)             # ring already primed

    def run(self, n_blocks: int, paced: bool = True,
            warmup_blocks: Optional[int] = None,
            trace: Optional[bool] = None) -> E2EResult:
        from mediastreamer2_tpu.core.worker import normal_priority_pool
        N, K, D, S8 = self.n, self.K, self.D, self.S8
        if warmup_blocks is None:
            warmup_blocks = self.default_warmup_blocks()
        # The paced thread must NEVER block on the device: uploads+dispatch
        # run on one worker (calls serialize there, so device state chains
        # correctly) and downloads on another, overlapping both transfer
        # directions with the tick loop (np.asarray/device_put release the
        # GIL during PCIe I/O).  nice 0 even when run() is called from an
        # elevated fleet member thread.
        uploader = normal_priority_pool(1, "e2e-upload")
        reader = normal_priority_pool(1, "e2e-read")

        def gpu_block(stage_copy):
            return self._gpu_block(stage_copy, reader)

        # 0xFF is mu-law digital silence; zeros would decode loud (-0.24)
        stage = np.full((K, N, S8), 0xFF, np.uint8)
        cur_tx = np.full((K, N, S8), 0xFF, np.uint8)    # block being sent
        q: list = []                                     # in-flight device calls
        flags_missing = 0
        flags_total = 0
        late_ticks = 0
        t_start: Optional[float] = None
        ticks_timed = 0
        interval = 0.01

        # warm compile before timing (no-op if warm() already ran)
        self.warm()

        if self.adaptive_prefill and paced:
            self._jitter_ctrl = self.make_jitter_ctrl()

        # phase trace (MS2TPU_E2E_TRACE=1): attribute overruns to the
        # loop phase that ate the interval
        import os as _os
        if trace is None:
            trace = _os.environ.get("MS2TPU_E2E_TRACE", "0") != "0"
        # Paced-loop priority: the deadline thread runs at nice -10 (CFS
        # weight ~10x) over the nice-0 upload/read workers — the policy
        # the mixed fleet measured into its default (_elevate_paced_thread,
        # models/mixed_fleet.py; reference ticker parity msticker.c:330).
        # At nice 0, edge-phase tails are CFS wakeup losses, not work.
        # MS2TPU_E2E_NICE overrides; restored on exit (root can re-raise).
        nice_prev = None
        if paced:
            try:
                import threading as _th
                want = int(_os.environ.get("MS2TPU_E2E_NICE", "-10"))
                tid = _th.get_native_id()
                cur = _os.getpriority(_os.PRIO_PROCESS, tid)
                if want != cur:
                    _os.setpriority(_os.PRIO_PROCESS, tid, want)
                    nice_prev = (tid, cur)
            except (AttributeError, OSError, ValueError):
                pass
        # edge is split tx/rx so an SRTP row's cost lands on the phase
        # that carries it: edge_tx = pack+protect+sendmmsg, edge_rx =
        # recvmmsg+verify+decrypt+jitter-insert
        ph = ({"edge_tx": 0.0, "edge_rx": 0.0, "submit": 0.0, "pop": 0.0}
              if trace else None)
        ph_max = dict(ph) if trace else None
        pop_waits: list = [] if trace else None

        next_edge = time.perf_counter()
        for blk in range(n_blocks):
            if blk == warmup_blocks:
                t_start = time.perf_counter()
            if self._jitter_ctrl is not None and 0 < blk < warmup_blocks:
                self._jitter_ctrl.control()      # warmup-only adaptation
            for k in range(K):
                if paced:
                    now = time.perf_counter()
                    if now < next_edge:
                        time.sleep(next_edge - now)
                    elif now > next_edge + interval:
                        if blk >= warmup_blocks:
                            # a stall spanning M intervals is M late ticks
                            # (cf. msticker late accounting) — otherwise a
                            # block-boundary pause of 100 ms counts once
                            late_ticks += int((now - next_edge) / interval)
                        next_edge = now
                    next_edge += interval
                t_a = time.perf_counter() if trace else 0.0
                self.tx.send(cur_tx[k], ts_inc=S8)
                if trace:
                    t_b = time.perf_counter()
                    d = t_b - t_a
                    ph["edge_tx"] += d
                    ph_max["edge_tx"] = max(ph_max["edge_tx"], d)
                    t_a = t_b
                self.rx.poll()
                pay, fl = self.rx.read_tick()
                if trace:
                    d = time.perf_counter() - t_a
                    ph["edge_rx"] += d
                    ph_max["edge_rx"] = max(ph_max["edge_rx"], d)
                stage[k] = pay
                missing = fl == 0
                if missing.any():
                    stage[k][missing] = 0xFF             # silence, not 0x00
                if blk >= warmup_blocks:
                    flags_total += N
                    flags_missing += int(N - fl.sum())
            t_a = time.perf_counter() if trace else 0.0
            q.append(uploader.submit(gpu_block, stage.copy()))
            if trace:
                d = time.perf_counter() - t_a
                ph["submit"] += d
                ph_max["submit"] = max(ph_max["submit"], d)
            if len(q) > D:
                t_a = time.perf_counter() if trace else 0.0
                cur_tx, sent_p, recv_p = q.pop(0).result().result()
                if trace:
                    d = time.perf_counter() - t_a
                    ph["pop"] += d
                    ph_max["pop"] = max(ph_max["pop"], d)
                    pop_waits.append(round(d * 1e3, 1))
                if blk >= warmup_blocks:   # keep fidelity streams steady-state
                    self._sent_probe.append(sent_p)
                    self._recv_probe.append(recv_p)
        total_s = time.perf_counter() - (t_start or time.perf_counter())
        if trace:
            import sys as _sys
            print(f"# e2e-trace N={N} K={K} D={D}: totals(s) {ph} "
                  f"max(s) {ph_max} pop_waits_ms={pop_waits[-24:]}",
                  file=_sys.stderr)
        for fut in q:
            _, sent_p, recv_p = fut.result().result()
            self._sent_probe.append(sent_p)
            self._recv_probe.append(recv_p)
        uploader.shutdown(wait=True)
        reader.shutdown(wait=True)
        if nice_prev is not None:
            # best-effort restore (root may lower niceness); an exception
            # path leaves the thread elevated, which is benign — the same
            # thread is the paced loop of any next trial
            try:
                _os.setpriority(_os.PRIO_PROCESS, *nice_prev)
            except OSError:
                pass
        ticks_timed = (n_blocks - warmup_blocks) * K
        auth_fail = 0
        if self.srtp:
            auth_fail = sum(self.rx.auth_failures(i) for i in range(N))
        # converged (worst-leg) prefill is the honest latency component
        eff_prefill = (max(self._jitter_ctrl.prefill)
                       if self._jitter_ctrl is not None else self.prefill)
        phases_ms = None
        if trace:
            total_ticks = n_blocks * K
            phases_ms = {k: round(v * 1e3 / max(total_ticks, 1), 4)
                         for k, v in ph.items()}
            phases_ms.update({f"{k}_max": round(v * 1e3, 2)
                              for k, v in ph_max.items()})
        return E2EResult(
            n_legs=N, ticks=ticks_timed, k_block=K, pipeline_depth=D,
            ms_per_tick=total_s * 1e3 / max(ticks_timed, 1),
            late_ticks=late_ticks,
            loss_rate=flags_missing / max(flags_total, 1),
            fidelity=self.fidelity(),
            mouth_to_ear_ms=(K * (D + 1) + eff_prefill) * 10.0,
            srtp=self.srtp, auth_failures=auth_fail,
            phases_ms=phases_ms)

    def fidelity(self) -> float:
        """audio_diff between what probe legs sent and what they received
        back (decoded), across the whole run."""
        if not self._sent_probe:
            return 0.0
        # sent: u8 payloads [T,4,80] -> mu-law decode in numpy (host side;
        # no device round trip)
        sent = np.concatenate(self._sent_probe, axis=0)   # [T,4,80]
        recv = np.concatenate(self._recv_probe, axis=0)
        u = (~sent.astype(np.int64)) & 0xFF
        t = (((u & 0xF) << 3) + 0x84) << ((u & 0x70) >> 4)
        sent_f = np.where((u & 0x80) != 0, 0x84 - t, t - 0x84) / 32768.0
        sims = []
        for leg in range(min(FIDELITY_LEGS, self.n)):
            a = sent_f[:, leg].reshape(-1)
            b = recv[:, leg].reshape(-1)
            if np.abs(a).max() < 1e-6 or np.abs(b).max() < 1e-6:
                continue
            # The recv stream lags the sent stream by the loop delay
            # (pipeline + jitter prefill), always a whole number of ticks.
            # Search tick-aligned shifts and score overlap-normalized
            # correlation — whole-stream normalization (audio_diff) would
            # penalize the non-overlapping edges, i.e. measure latency.
            max_shift = (self.K * (self.D + 2) + self.prefill + 8) * 80
            best = 0.0
            for s in range(0, min(max_shift, len(b) - 800), 80):
                n = min(len(a), len(b) - s)
                aa, bb = a[:n], b[s:s + n]
                denom = np.linalg.norm(aa) * np.linalg.norm(bb)
                if denom > 0:
                    best = max(best, float(np.dot(aa, bb) / denom))
            sims.append(best)
        return float(min(sims)) if sims else 0.0


class E2EStepper:
    """Tick-at-a-time driver over an E2EConferenceBench — the single-loop
    (FleetTicker-shaped) alternative to run()'s self-paced loop, used by
    the mixed fleet so MANY heterogeneous members share ONE paced host
    thread (models/mixed_fleet.py; reference contrast: one ticker thread
    per stream, msticker.c:448 — the right shape for many cores, the wrong
    one for a host with few).

    The fleet loop calls tick() once per 10 ms edge.  Edge I/O runs inline
    (native, bounded); device upload+dispatch runs on the SHARED uploader
    worker at block (K-tick) granularity and the transfer-forcing fetch on
    the shared reader worker, so the loop never blocks on the device
    except at block pops whose data has had K*D ticks to land.

    Accounting matches run(): same warmup window, same loss/fidelity
    oracles, same E2EResult.
    """

    def __init__(self, bench: E2EConferenceBench, uploader, reader,
                 n_blocks: int, warmup_blocks: Optional[int] = None):
        b = bench
        self.b = b
        self.uploader, self.reader = uploader, reader
        self.n_blocks = n_blocks
        self.warmup_blocks = (b.default_warmup_blocks()
                              if warmup_blocks is None else warmup_blocks)
        self.stage = np.full((b.K, b.n, b.S8), 0xFF, np.uint8)
        self.cur_tx = np.full((b.K, b.n, b.S8), 0xFF, np.uint8)
        self.q: list = []
        self._next = None            # opportunistically-popped block result
        self.tick_i = 0
        self.flags_missing = 0
        self.flags_total = 0
        self.late_ticks = 0
        # co-residency trace: how often the boundary swap had to BLOCK the
        # shared loop (pipeline slack exhausted) and for how long, plus
        # worker-side _gpu_block occupancy
        self.boundary_waits = 0
        self.boundary_wait_s = 0.0
        self.w_ms_sum = 0.0
        self.w_ms_max = 0.0
        self.w_n = 0
        self._t_start: Optional[float] = None
        self._t_end: Optional[float] = None
        b.warm()
        b._sent_probe, b._recv_probe = [], []
        b._jitter_ctrl = b.make_jitter_ctrl() if b.adaptive_prefill else None

    @property
    def done(self) -> bool:
        return self.tick_i >= self.n_blocks * self.b.K

    @property
    def interval_ms(self) -> float:
        return 10.0

    def _timed_block(self, stage_copy):
        """_gpu_block with worker-occupancy accounting (runs ON the shared
        uploader worker; returns the reader future like _gpu_block)."""
        t0 = time.perf_counter()
        out = self.b._gpu_block(stage_copy, self.reader)
        d = (time.perf_counter() - t0) * 1e3
        self.w_ms_sum += d
        self.w_ms_max = max(self.w_ms_max, d)
        self.w_n += 1
        return out

    def worker_trace(self) -> dict:
        return {"worker_ms_mean": round(self.w_ms_sum / max(self.w_n, 1), 3),
                "worker_ms_max": round(self.w_ms_max, 2),
                "boundary_waits": self.boundary_waits,
                "boundary_wait_ms": round(self.boundary_wait_s * 1e3, 2)}

    def tick(self, late_by: int = 0) -> bool:
        """One 10 ms edge.  late_by: whole intervals the fleet loop was
        behind at this member's edge (folded into late_ticks during the
        measured window — parity with run()'s missed-edge accounting)."""
        b = self.b
        blk, k = divmod(self.tick_i, b.K)
        if blk >= self.n_blocks:
            return False
        measured = blk >= self.warmup_blocks
        if k == 0:
            if blk == self.warmup_blocks:
                self._t_start = time.perf_counter()
            if b._jitter_ctrl is not None and 0 < blk < self.warmup_blocks:
                b._jitter_ctrl.control()      # warmup-only adaptation
        if measured and late_by:
            self.late_ticks += late_by
        b.tx.send(self.cur_tx[k], ts_inc=b.S8)
        b.rx.poll()
        pay, fl = b.rx.read_tick()
        self.stage[k] = pay
        missing = fl == 0
        if missing.any():
            self.stage[k][missing] = 0xFF             # mu-law silence
        if measured:
            self.flags_total += b.n
            self.flags_missing += int(b.n - fl.sum())
        self.tick_i += 1
        # Opportunistic pipeline pop: the block due at the NEXT boundary
        # was submitted D blocks ago — poll it non-blocking each tick so
        # the boundary swap almost never blocks the shared fleet loop
        # (the inline .result() there measured 6-8 ms max and, stacked
        # across co-resident members, stole other members' 10 ms edges).
        if self._next is None and len(self.q) >= b.D and self.q[0].done():
            inner = self.q[0].result()
            if inner.done():
                self.q.pop(0)
                self._next = inner.result()
        if k == b.K - 1:
            self.q.append(self.uploader.submit(self._timed_block,
                                               self.stage.copy()))
            in_flight = len(self.q) + (self._next is not None)
            if in_flight > b.D:
                if self._next is None:       # pipeline has no slack: wait
                    t_w = time.perf_counter()
                    self._next = self.q.pop(0).result().result()
                    self.boundary_waits += 1
                    self.boundary_wait_s += time.perf_counter() - t_w
                self.cur_tx, sent_p, recv_p = self._next
                self._next = None
                if measured:
                    b._sent_probe.append(sent_p)
                    b._recv_probe.append(recv_p)
            if self.done:
                self._t_end = time.perf_counter()
        return not self.done

    def finish(self) -> E2EResult:
        b = self.b
        if self._t_end is None:
            self._t_end = time.perf_counter()
        if self._next is not None:
            _, sent_p, recv_p = self._next
            self._next = None
            b._sent_probe.append(sent_p)
            b._recv_probe.append(recv_p)
        for fut in self.q:
            _, sent_p, recv_p = fut.result().result()
            b._sent_probe.append(sent_p)
            b._recv_probe.append(recv_p)
        self.q = []
        blocks_run = min(self.tick_i // b.K, self.n_blocks)
        ticks_timed = max(0, blocks_run - self.warmup_blocks) * b.K
        total_s = ((self._t_end - self._t_start)
                   if self._t_start is not None else 0.0)
        auth_fail = (sum(b.rx.auth_failures(i) for i in range(b.n))
                     if b.srtp else 0)
        eff_prefill = (max(b._jitter_ctrl.prefill)
                       if b._jitter_ctrl is not None else b.prefill)
        return E2EResult(
            n_legs=b.n, ticks=ticks_timed, k_block=b.K,
            pipeline_depth=b.D,
            ms_per_tick=total_s * 1e3 / max(ticks_timed, 1),
            late_ticks=self.late_ticks,
            loss_rate=self.flags_missing / max(self.flags_total, 1),
            fidelity=b.fidelity(),
            mouth_to_ear_ms=(b.K * (b.D + 1) + eff_prefill) * 10.0,
            srtp=b.srtp, auth_failures=auth_fail)
