"""RTP (RFC 3550) packetization and sessions — host side.

The reference delegates RTP to the external oRTP library (RtpSession held by
every stream, reference include/mediastreamer2/mediastream.h:100; the graph
edge filters are src/otherfilters/msrtp.c).  Sequential, byte-oriented and
branchy, this layer is the wrong shape for an accelerator — so, as in the reference,
it lives on the host CPU: sessions packetize device-produced payload blocks
into RTP and feed received packets into the jitter buffer, which assembles
the fixed-shape tick tensors the device graph consumes.

Transports: real UDP sockets (localhost/WAN) or an in-process loopback pair
(for tests and SFU-style routing), both optionally shaped by
:mod:`mediastreamer2_tpu.net.netsim` (parity with oRTP's network simulator).
"""
from __future__ import annotations

import dataclasses
import random
import socket
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

RTP_VERSION = 2
_HDR = struct.Struct("!BBHII")      # V/P/X/CC, M/PT, seq, timestamp, ssrc

# RFC 4733 telephone-event (DTMF over RTP) — reference: the MSRtpSend DTMF
# insertion path (src/otherfilters/msrtp.c) + msrtp.h:46-113 methods.
TELEPHONE_EVENT_PT = 101            # common dynamic PT for telephone-event
DTMF_DIGITS = "0123456789*#ABCD"    # event codes 0..15 (RFC 4733 §3.2)
DTMF_END_REDUNDANCY = 3             # end packet sent 3x (RFC 4733 §5)


@dataclasses.dataclass
class _DtmfTx:
    event: int
    volume: int
    total_units: int                # duration in RTP clock units
    start_ts: int = 0
    sent_units: int = 0
    end_sent: int = 0
    first: bool = True


@dataclasses.dataclass
class RtpPacket:
    payload_type: int
    seq: int
    timestamp: int
    ssrc: int
    payload: bytes
    marker: bool = False
    csrcs: Tuple[int, ...] = ()
    # RFC 5285 one-byte header extensions: {ext_id: data}
    extensions: Optional[Dict[int, bytes]] = None

    def pack(self) -> bytes:
        x_bit = 1 if self.extensions else 0
        b0 = (RTP_VERSION << 6) | (x_bit << 4) | (len(self.csrcs) & 0x0F)
        b1 = ((1 if self.marker else 0) << 7) | (self.payload_type & 0x7F)
        hdr = _HDR.pack(b0, b1, self.seq & 0xFFFF,
                        self.timestamp & 0xFFFFFFFF, self.ssrc & 0xFFFFFFFF)
        csrc = b"".join(struct.pack("!I", c) for c in self.csrcs)
        ext = b""
        if self.extensions:
            body = b"".join(bytes([(eid << 4) | (len(d) - 1)]) + d
                            for eid, d in self.extensions.items())
            body += b"\x00" * ((-len(body)) % 4)
            ext = struct.pack("!HH", 0xBEDE, len(body) // 4) + body
        return hdr + csrc + ext + self.payload

    @classmethod
    def unpack(cls, data: bytes) -> "RtpPacket":
        if len(data) < _HDR.size:
            raise ValueError("short RTP packet")
        b0, b1, seq, ts, ssrc = _HDR.unpack_from(data)
        if b0 >> 6 != RTP_VERSION:
            raise ValueError("bad RTP version")
        cc = b0 & 0x0F
        has_ext = (b0 >> 4) & 1
        off = _HDR.size + 4 * cc
        if len(data) < off:
            raise ValueError("truncated CSRC list")
        csrcs = tuple(struct.unpack_from("!I", data, _HDR.size + 4 * i)[0]
                      for i in range(cc))
        extensions = None
        if has_ext:
            if len(data) < off + 4:
                raise ValueError("truncated extension header")
            profile, ext_len = struct.unpack_from("!HH", data, off)
            body = data[off + 4: off + 4 + 4 * ext_len]
            off += 4 + 4 * ext_len
            if profile == 0xBEDE:            # RFC 5285 one-byte form
                extensions = {}
                i = 0
                while i < len(body):
                    b = body[i]
                    if b == 0:               # padding
                        i += 1
                        continue
                    eid, ln = b >> 4, (b & 0x0F) + 1
                    if eid == 15:
                        break
                    extensions[eid] = body[i + 1: i + 1 + ln]
                    i += 1 + ln
        payload = data[off:]
        if (b0 >> 5) & 1:                      # padding
            payload = payload[: -payload[-1]] if payload else payload
        return cls(payload_type=b1 & 0x7F, seq=seq, timestamp=ts, ssrc=ssrc,
                   payload=payload, marker=bool(b1 >> 7), csrcs=csrcs,
                   extensions=extensions)


@dataclasses.dataclass
class RtpStats:
    """cf. oRTP rtp_stats_t surfaced via media_stream_get_*"""
    sent_packets: int = 0
    sent_bytes: int = 0
    recv_packets: int = 0
    recv_bytes: int = 0
    lost: int = 0
    late: int = 0
    discarded: int = 0
    out_of_order: int = 0
    packet_dup_recv: int = 0    # oRTP rtp_stats_t.packet_dup_recv


class BandwidthMeter:
    """Sliding-window bits/s meter — media_stream_get_up_bw / get_down_bw
    parity (mediastream.c:647-684 on oRTP's averaged bandwidth)."""

    def __init__(self, window_s: float = 1.0):
        self.window_s = window_s
        self._events: List[Tuple[float, int]] = []   # (time, bytes)

    def add(self, nbytes: int, now: Optional[float] = None):
        now = time.monotonic() if now is None else now
        self._events.append((now, nbytes))

    def bps(self, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        floor = now - self.window_s
        while self._events and self._events[0][0] < floor:
            self._events.pop(0)
        return sum(b for _, b in self._events) * 8.0 / self.window_s


def is_multicast(host: str) -> bool:
    """ms_is_multicast_addr parity (framework tester 'Is multicast'):
    IPv4 224.0.0.0/4 and IPv6 ff00::/8."""
    import ipaddress
    try:
        return ipaddress.ip_address(host).is_multicast
    except ValueError:
        return False


class Transport:
    """Abstract datagram transport; subclasses: UDP, loopback."""
    def send(self, data: bytes): ...
    def recv_all(self) -> List[bytes]: ...

    def recv_all_ts(self) -> List[Tuple[float, bytes]]:
        """(arrival_time, packet) pairs; default stamps at drain time.
        Transports with better knowledge (netsim delivery schedule, native
        pump kernel timestamps) override this."""
        now = time.monotonic()
        return [(now, d) for d in self.recv_all()]

    def close(self): ...


class UdpTransport(Transport):
    """UDP datagram transport; optionally drained by the native C++ epoll
    pump (mediastreamer2_tpu.native.NativeIoPump) so packet reception and
    arrival timestamping happen off the Python thread — the role oRTP's
    socket layer plays under the reference's ticker."""

    def __init__(self, local_port: int = 0, remote: Optional[Tuple[str, int]] = None,
                 bind_host: str = "127.0.0.1", reuse_addr: bool = False):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        if reuse_addr:       # multicast receivers share the group port
            self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((bind_host, local_port))
        self.sock.setblocking(False)
        self.local_port = self.sock.getsockname()[1]
        self.remote = remote
        self._pump = None
        self.last_recv_ns: Optional[int] = None
        self.symmetric = False

    def attach_pump(self, pump) -> None:
        pump.add_socket(self.sock)
        self._pump = pump

    def set_remote(self, host: str, port: int):
        self.remote = (host, port)

    def set_symmetric(self, enabled: bool = True):
        """Symmetric RTP (rtp_session_set_symmetric_rtp): redirect sends to
        the source address of received packets — recovers from a wrong
        signalled address (reference tester 'Symetric rtp with wrong
        address').  Python recv path only (the native pump does not carry
        per-packet source addresses)."""
        self.symmetric = enabled

    def set_dscp(self, dscp: int):
        """QoS marking (media_stream_set_dscp, mediastream.c): DSCP is the
        upper 6 bits of the IP TOS byte."""
        self.sock.setsockopt(socket.IPPROTO_IP, socket.IP_TOS,
                             (dscp & 0x3F) << 2)

    def join_multicast_group(self, group: str, ttl: int = 1,
                             loopback: bool = True, iface: str = "0.0.0.0"):
        """Receive (and address sends) on an IPv4 multicast group — the
        rtp_session_set_multicast_* / media_stream_join_multicast_group
        surface (mediastream.h; used by the reference's multicast audio
        stream tests).  `iface` pins both membership and egress to one
        interface address (e.g. "127.0.0.1" for host-local fan-out)."""
        mreq = socket.inet_aton(group) + socket.inet_aton(iface)
        self.sock.setsockopt(socket.IPPROTO_IP, socket.IP_ADD_MEMBERSHIP, mreq)
        self.sock.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_IF,
                             socket.inet_aton(iface))
        self.sock.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_TTL, ttl)
        self.sock.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_LOOP,
                             1 if loopback else 0)
        self.multicast_group = group

    def send(self, data: bytes):
        if self.remote:
            try:
                self.sock.sendto(data, self.remote)
            except (BlockingIOError, OSError):
                pass

    def recv_all(self) -> List[bytes]:
        if self._pump is not None:
            pkts = self._pump.read(self.sock)
            if pkts:
                self.last_recv_ns = pkts[-1][0]
            return [d for _, d in pkts]
        out = []
        while True:
            try:
                data, addr = self.sock.recvfrom(65536)
                out.append(data)
                if self.symmetric and addr != self.remote:
                    self.remote = addr
            except (BlockingIOError, OSError):
                break
        return out

    def close(self):
        if self._pump is not None:
            self._pump.remove_socket(self.sock)
        self.sock.close()


class LoopbackPair:
    """Two in-process endpoints with optional network simulation."""
    def __init__(self, netsim=None):
        self.queues = ([], [])
        self.lock = threading.Lock()
        self.netsim = netsim        # applied on both directions

    def endpoint(self, idx: int) -> "LoopbackTransport":
        return LoopbackTransport(self, idx)

    def _send(self, from_idx: int, data: bytes):
        now = time.monotonic()
        items = [(now, data)]
        if self.netsim is not None:
            items = self.netsim.shape(now, data)
        with self.lock:
            self.queues[1 - from_idx].extend(items)

    def _recv(self, idx: int) -> List[bytes]:
        return [d for _, d in self._recv_ts(idx)]

    def _recv_ts(self, idx: int) -> List[Tuple[float, bytes]]:
        now = time.monotonic()
        with self.lock:
            q = self.queues[idx]
            ready = [(t, d) for t, d in q if t <= now]
            self.queues[idx][:] = [(t, d) for t, d in q if t > now]
        return ready


class LoopbackTransport(Transport):
    def __init__(self, pair: LoopbackPair, idx: int):
        self.pair = pair
        self.idx = idx

    def send(self, data: bytes):
        self.pair._send(self.idx, data)

    def recv_all(self) -> List[bytes]:
        return self.pair._recv(self.idx)

    def recv_all_ts(self) -> List[Tuple[float, bytes]]:
        """Packets with their (simulated) delivery times — the bandwidth
        estimators need real inter-arrival spacing."""
        return self.pair._recv_ts(self.idx)

    def close(self):
        pass


class RtpBundle:
    """BUNDLE multiplexing: many SSRCs share one transport (reference:
    oRTP RtpBundle, used for multi-SSRC recv branches in audiostream.c:
    1855-1879 / videostream bundle branches).

    Sessions register by SSRC (or are auto-assigned on first sight when a
    default factory is installed); send goes straight through."""

    def __init__(self, transport: Transport):
        self.transport = transport
        self.by_ssrc: Dict[int, "RtpSession"] = {}
        self.by_mid: Dict[str, "RtpSession"] = {}
        self.mid_ext_id: Optional[int] = None
        self.on_unknown_ssrc: Optional[Callable[[RtpPacket], None]] = None
        self.unknown_dropped = 0

    def set_mid_extension_id(self, ext_id: int):
        """cf. rtp_bundle_set_mid_extension_id: enable RFC 8843 MID-based
        demultiplexing — streams sharing a MID (or whose SSRC the receiver
        has never seen, e.g. behind a relay) route by the MID header
        extension; SSRC association is learned from it."""
        self.mid_ext_id = ext_id
        for s in self.by_mid.values():
            s._mid_ext_id = ext_id

    def attach(self, session: "RtpSession", recv_ssrc: Optional[int] = None,
               mid: Optional[str] = None):
        session.transport = _BundleSendProxy(self)
        if recv_ssrc is not None:
            self.by_ssrc[recv_ssrc] = session
        if mid is not None:
            self.by_mid[mid] = session
            session._bundle_mid = mid
            if self.mid_ext_id is not None:
                session._mid_ext_id = self.mid_ext_id

    def poll(self):
        for data in self.transport.recv_all():
            try:
                pkt = RtpPacket.unpack(data)
            except ValueError:
                continue
            sess = self.by_ssrc.get(pkt.ssrc)
            if sess is None and self.mid_ext_id is not None \
                    and pkt.extensions:
                raw = pkt.extensions.get(self.mid_ext_id)
                if raw:
                    sess = self.by_mid.get(raw.decode("ascii", "ignore"))
                    if sess is not None:
                        # learn the SSRC for extension-less packets later
                        self.by_ssrc[pkt.ssrc] = sess
            if sess is None:
                if self.on_unknown_ssrc:
                    self.on_unknown_ssrc(pkt)
                    sess = self.by_ssrc.get(pkt.ssrc)
                if sess is None:
                    self.unknown_dropped += 1
                    continue
            sess._deliver(pkt)


class _BundleSendProxy(Transport):
    def __init__(self, bundle: RtpBundle):
        self.bundle = bundle

    def send(self, data: bytes):
        self.bundle.transport.send(data)

    def recv_all(self) -> List[bytes]:
        return []                 # recv is demuxed by the bundle


class AudioStreamVolumes:
    """ssrc -> audio level map fed from the RFC 6464/6465 header
    extensions on received packets (parity: src/voip/
    audiostreamvolumes.cpp — the map linphone uses to show per-participant
    volume bars from a mixed conference leg).

    Levels are stored as dBov in [-127, 0]; unknown ssrc returns
    AUDIOSTREAMVOLUMES_NOT_FOUND (-130, below any real level)."""

    NOT_FOUND = -130

    def __init__(self, level_ext_id: int = 1, csrc_level_ext_id: int = 3):
        self.level_ext_id = level_ext_id
        self.csrc_level_ext_id = csrc_level_ext_id
        self._vol: Dict[int, int] = {}

    def update_from_packet(self, pkt: "RtpPacket"):
        if not pkt.extensions:
            return
        one = pkt.extensions.get(self.level_ext_id)
        if one:
            self._vol[pkt.ssrc] = -(one[0] & 0x7F)
        many = pkt.extensions.get(self.csrc_level_ext_id)
        if many:
            for csrc, db in zip(pkt.csrcs, many):
                self._vol[csrc] = -(db & 0x7F)

    def get(self, ssrc: int) -> int:
        return self._vol.get(ssrc, self.NOT_FOUND)

    def items(self):
        return self._vol.items()

    def clear(self):
        self._vol.clear()


class RtpSession:
    """Per-leg RTP send/recv state (the host half of MSRtpSend/MSRtpRecv,
    reference src/otherfilters/msrtp.c:705-714 send, :1050-1091 recv)."""

    def __init__(self, transport: Transport, payload_type: int = 0,
                 clock_rate: int = 8000, ssrc: Optional[int] = None,
                 jitter_buffer=None):
        self.transport = transport
        self.payload_type = payload_type
        self.clock_rate = clock_rate
        self.ssrc = ssrc if ssrc is not None else random.getrandbits(32)
        self.seq = random.getrandbits(16)
        self.ts = random.getrandbits(31)
        self.stats = RtpStats()
        self.up_bw = BandwidthMeter()     # media_stream_get_up_bw parity
        self.down_bw = BandwidthMeter()
        self.jitter_buffer = jitter_buffer
        self.recv_ssrc: Optional[int] = None
        self.on_packet: Optional[Callable[[RtpPacket], None]] = None
        self.accepted_payload_types: Optional[set] = None  # None => {payload_type}
        self.created_time = time.monotonic()
        self.last_recv_time: Optional[float] = None
        self.rtcp = None     # RtcpSession when attach_rtcp() enabled
        self._rtx_history = None
        self._rtx_depth = 0
        self._last_transit = None
        self.jitter_units = 0.0    # RFC3550 interarrival jitter (ts units)
        # RFC 4733 telephone-event state
        self.telephone_event_pt = TELEPHONE_EVENT_PT
        self.on_dtmf: Optional[Callable[[str, int], None]] = None
        self._dtmf_queue: List[_DtmfTx] = []
        self._dtmf_cur: Optional[_DtmfTx] = None
        self._dtmf_rx_ts: Optional[int] = None   # current inbound event ts
        # encryption-mandatory mode (ms_media_stream_sessions_set_
        # encryption_mandatory, ms_srtp.cpp:1576): while the transport is
        # not an encrypting one, outbound media is dropped instead of sent
        # in clear, and inbound plaintext is discarded
        self.encryption_mandatory = False
        self.mandatory_dropped = 0
        # receive-side bandwidth estimators (oRTP OrtpVideo/Audio
        # BandwidthEstimator parity, net/bwe.py)
        self.vbe = None
        self.abe = None
        self._abe_dup_every = 0
        self._abe_dup_active = False
        self._abe_pending_dup: Optional[bytes] = None
        self._abe_count = 0
        self.abe_duplicates_sent = 0

    def enable_video_bandwidth_estimator(self, params=None):
        """cf. rtp_session_enable_video_bandwidth_estimator."""
        from mediastreamer2_tpu.net.bwe import VideoBandwidthEstimator
        self.vbe = VideoBandwidthEstimator(params)
        return self.vbe

    def enable_audio_bandwidth_estimator(self, params=None):
        """cf. rtp_session_enable_audio_bandwidth_estimator — measures on
        the receive side AND arms the sender's duplicate machinery (clusters
        only flow once set_abe_duplicates(True), mirroring the reference
        where duplicates start when the sender is bitrate-capped)."""
        from mediastreamer2_tpu.net.bwe import (AudioBandwidthEstimator,
                                                BweParams)
        p = params or BweParams()
        self.abe = AudioBandwidthEstimator(p)
        self._abe_dup_every = max(2, p.duplicate_every)
        return self.abe

    def set_abe_duplicates(self, active: bool):
        self._abe_dup_active = bool(active)

    def set_duplication_ratio(self, ratio: float):
        """cf. rtp_session_set_duplication_ratio (oRTP): every packet is
        re-sent `ratio` extra times (fractional ratios accumulate), a blunt
        redundancy tool the adaptive tester measures via packet_dup_recv
        and the (1+ratio)x upload bandwidth."""
        self._dup_ratio = max(0.0, float(ratio))
        if not hasattr(self, "_dup_accum"):
            self._dup_accum = 0.0

    def set_encryption_mandatory(self, yesno: bool = True):
        self.encryption_mandatory = bool(yesno)

    def _cleartext_blocked(self) -> bool:
        return self.encryption_mandatory and \
            not getattr(self.transport, "encrypting", False)

    @property
    def jitter_ms(self) -> float:
        return self.jitter_units * 1000.0 / self.clock_rate

    def reconfigure(self, payload_type: int, clock_rate: int,
                    jitter_buffer=None):
        """Re-point the session at a new codec while keeping its identity —
        SSRC, sequence numbering and transport survive, like the reference's
        codec change over reclaimed sessions (media_stream_reclaim_sessions,
        mediastream.h:384 + codec_change_for_audio_stream tester case)."""
        self.payload_type = payload_type
        self.clock_rate = clock_rate
        if jitter_buffer is not None:
            self.jitter_buffer = jitter_buffer
        self.recv_ssrc = None            # resync on the peer's next packet
        self._last_transit = None

    # -- send path ------------------------------------------------------
    def enable_retransmission(self, history: int = 256):
        """Keep a send history so NACKed packets can be resent
        (cf. video_stream_enable_retransmission_on_nack,
        src/voip/videostream.c:725)."""
        self._rtx_history = {}
        self._rtx_depth = history

    def enable_frame_marking_ext(self, ext_id: int = 5):
        """RFC 7941 frame-marking header extension (msrtp.c frame-marking
        insert): S/E/I/D bits let SFUs spot frame boundaries and keyframes
        without parsing — or decrypting — the payload."""
        self._fm_ext_id = ext_id
        self._fm_byte = None

    def set_frame_marking(self, start: bool, end: bool, independent: bool,
                          discardable: bool = False):
        """Marking for the NEXT sent packet (cleared after each send)."""
        self._fm_byte = ((0x80 if start else 0) | (0x40 if end else 0)
                         | (0x20 if independent else 0)
                         | (0x10 if discardable else 0))

    @staticmethod
    def parse_frame_marking(data: bytes):
        """-> (start, end, independent, discardable) from an ext value."""
        b = data[0] if data else 0
        return bool(b & 0x80), bool(b & 0x40), bool(b & 0x20), bool(b & 0x10)

    def enable_audio_level_ext(self, ext_id: int = 1):
        """RFC 6464 client-to-mixer audio level header extension
        (reference: msrtp.c audio-level extension insertion; negotiated id
        via SDP extmap). Call set_audio_level(dBov) per tick."""
        self._level_ext_id = ext_id
        self._level_dbov = 127

    def set_audio_level(self, dbov: int, voice: bool = False):
        self._level_dbov = (0x80 if voice else 0) | (min(127, max(0, dbov)))

    def enable_csrc_audio_level_ext(self, ext_id: int = 3):
        """RFC 6465 mixer-to-client audio levels: one level octet per
        contributing source, parallel to the packet's CSRC list (the
        reference carries these via AudioStreamVolumes, src/voip/
        audiostreamvolumes.cpp, inserted by the mixer/router leg).
        Call set_csrc_audio_levels per tick on mixed output legs."""
        self._csrc_level_ext_id = ext_id
        self._csrc_levels: List[Tuple[int, int]] = []

    def set_csrc_audio_levels(self, levels):
        """levels: iterable of (csrc_ssrc, dBov 0..127) — RFC 6465 caps
        the list at 15 CSRCs (the RTP header's CC field width)."""
        self._csrc_levels = [(ssrc, min(127, max(0, int(db))))
                             for ssrc, db in list(levels)[:15]]

    def send_payload(self, payload: bytes, ts_increment: int, marker: bool = False):
        ext = None
        csrcs = ()
        if getattr(self, "_level_ext_id", None) is not None:
            ext = {self._level_ext_id: bytes([self._level_dbov])}
        if getattr(self, "_csrc_level_ext_id", None) is not None \
                and self._csrc_levels:
            ext = dict(ext or {})
            ext[self._csrc_level_ext_id] = bytes(
                db for _, db in self._csrc_levels)
            csrcs = tuple(ssrc for ssrc, _ in self._csrc_levels)
        if getattr(self, "_fm_ext_id", None) is not None \
                and self._fm_byte is not None:
            ext = dict(ext or {})
            ext[self._fm_ext_id] = bytes([self._fm_byte])
            self._fm_byte = None
        if getattr(self, "_mid_ext_id", None) is not None \
                and getattr(self, "_bundle_mid", None):
            # RFC 8843: stamp the MID so bundle receivers/relays can route
            # without prior SSRC knowledge
            ext = dict(ext or {})
            ext[self._mid_ext_id] = self._bundle_mid.encode("ascii")
        pkt = RtpPacket(self.payload_type, self.seq, self.ts, self.ssrc,
                        payload, marker, extensions=ext, csrcs=csrcs)
        wire = pkt.pack()
        if self._cleartext_blocked():
            # mandatory encryption, no SRTP yet: drop instead of leaking
            # plaintext (ms_srtp.cpp:460); the clock still advances
            self.mandatory_dropped += 1
            self.seq = (self.seq + 1) & 0xFFFF
            self.ts = (self.ts + ts_increment) & 0xFFFFFFFF
            return
        if self._abe_pending_dup is not None:
            # glue the scheduled duplicate to this packet: the two leave
            # back-to-back, so their arrival spacing at the receiver is one
            # serialization time (the audio bandwidth estimator's probe)
            self.transport.send(self._abe_pending_dup)
            self._abe_pending_dup = None
            self.abe_duplicates_sent += 1
        self.transport.send(wire)
        if self._abe_dup_active and self._abe_dup_every:
            self._abe_count += 1
            if self._abe_count % self._abe_dup_every == 0:
                self._abe_pending_dup = wire
        ratio = getattr(self, "_dup_ratio", 0.0)
        if ratio > 0:
            self._dup_accum += ratio
            while self._dup_accum >= 1.0:
                self.transport.send(wire)       # redundancy duplicate
                self.up_bw.add(len(wire))
                self._dup_accum -= 1.0
        if self._rtx_history is not None:
            self._rtx_history[self.seq] = wire
            if len(self._rtx_history) > self._rtx_depth:
                for s in sorted(self._rtx_history)[: -self._rtx_depth]:
                    del self._rtx_history[s]
        self.seq = (self.seq + 1) & 0xFFFF
        self.ts = (self.ts + ts_increment) & 0xFFFFFFFF
        self.stats.sent_packets += 1
        self.stats.sent_bytes += len(payload)
        self.up_bw.add(len(wire))

    def retransmit(self, seq: int) -> bool:
        """Resend a NACKed packet from history."""
        if self._rtx_history is None:
            return False
        wire = self._rtx_history.get(seq)
        if wire is None or self._cleartext_blocked():
            return False
        self.transport.send(wire)
        return True

    def skip_payload(self, ts_increment: int):
        """DTX: advance the RTP clock without sending (cf. CN/DTX)."""
        self.ts = (self.ts + ts_increment) & 0xFFFFFFFF

    # -- RFC 4733 telephone-event send ------------------------------------
    def send_dtmf(self, digit: str, duration_ms: int = 100, volume: int = 10):
        """Queue a DTMF digit for transmission as telephone-event packets
        (reference: MS_RTP_SEND_SEND_DTMF path in msrtp.c). Packets go out
        on subsequent ticks via dtmf_tick(); audio should be suppressed
        while active (the stream layer calls dtmf_active())."""
        event = DTMF_DIGITS.index(digit.upper())
        units = duration_ms * self.clock_rate // 1000
        self._dtmf_queue.append(_DtmfTx(event=event, volume=volume,
                                        total_units=units))

    def dtmf_active(self) -> bool:
        return self._dtmf_cur is not None or bool(self._dtmf_queue)

    def dtmf_tick(self, ts_increment: int) -> bool:
        """Advance the telephone-event sender by one tick. Returns True if
        an event packet was emitted (caller skips audio but still advances
        the clock with skip_payload). The event packets keep the event's
        start timestamp with growing duration; the final packet has the E
        bit and is sent DTMF_END_REDUNDANCY times (RFC 4733 §5)."""
        if self._dtmf_cur is None:
            if not self._dtmf_queue:
                return False
            self._dtmf_cur = self._dtmf_queue.pop(0)
            self._dtmf_cur.start_ts = self.ts
        ev = self._dtmf_cur
        ev.sent_units = min(ev.sent_units + ts_increment, ev.total_units)
        end = ev.sent_units >= ev.total_units
        payload = struct.pack(
            "!BBH", ev.event,
            ((0x80 if end else 0) | (ev.volume & 0x3F)), ev.sent_units)
        pkt = RtpPacket(self.telephone_event_pt, self.seq, ev.start_ts,
                        self.ssrc, payload, marker=ev.first)
        ev.first = False
        if self._cleartext_blocked():
            self.mandatory_dropped += 1
        else:
            self.transport.send(pkt.pack())
        self.seq = (self.seq + 1) & 0xFFFF
        self.stats.sent_packets += 1
        if end:
            ev.end_sent += 1
            if ev.end_sent >= DTMF_END_REDUNDANCY:
                self._dtmf_cur = None
        return True

    def _handle_telephone_event(self, pkt: RtpPacket):
        """RFC 4733 receive: fire on_dtmf once per event.

        Events are identified by their (constant) RTP timestamp, so the
        digit fires on the *first packet seen* for a new event — robust to
        loss of the marker packet, the end packets, or any subset: any
        surviving packet of the event delivers the digit exactly once."""
        if len(pkt.payload) < 4:
            return
        event, flags, _dur = struct.unpack("!BBH", pkt.payload[:4])
        if event >= len(DTMF_DIGITS):
            return
        if pkt.timestamp != self._dtmf_rx_ts:
            self._dtmf_rx_ts = pkt.timestamp
            if self.on_dtmf:
                self.on_dtmf(DTMF_DIGITS[event], flags & 0x3F)

    # -- recv path ------------------------------------------------------
    def _deliver(self, pkt: RtpPacket):
        if pkt.payload_type == self.telephone_event_pt:
            self._handle_telephone_event(pkt)
            return
        accepted = self.accepted_payload_types or {self.payload_type}
        if pkt.payload_type not in accepted:
            self.stats.discarded += 1
            return
        self.recv_ssrc = pkt.ssrc
        now = time.monotonic()
        self.last_recv_time = now
        # RFC 3550 §6.4.1 interarrival jitter (RTP timestamp units), in
        # 32-bit modular arithmetic so the ts rollover at 2^32 doesn't
        # spike the estimate (the jitterbuffer tester's
        # ideal_network_with_ts_rollover cases)
        transit = (int(now * self.clock_rate) - pkt.timestamp) & 0xFFFFFFFF
        if self._last_transit is not None:
            d = ((transit - self._last_transit + (1 << 31)) & 0xFFFFFFFF) \
                - (1 << 31)
            self.jitter_units += (abs(d) - self.jitter_units) / 16.0
        self._last_transit = transit
        self.stats.recv_packets += 1
        self.stats.recv_bytes += len(pkt.payload)
        self.down_bw.add(len(pkt.payload) + 12)
        # duplicate detection (oRTP rtp_stats_t.packet_dup_recv): a seq in
        # the recent window counts as dup and is not delivered twice
        recent = getattr(self, "_recent_seqs", None)
        if recent is None:
            recent = self._recent_seqs = {}
        if pkt.seq in recent:
            self.stats.packet_dup_recv += 1
            return
        recent[pkt.seq] = None
        if len(recent) > 128:
            del recent[next(iter(recent))]
        if self.on_packet:
            self.on_packet(pkt)
        if self.jitter_buffer is not None:
            self.jitter_buffer.put(pkt)

    def alive(self, timeout_s: float = 5.0) -> bool:
        """cf. media_stream_alive (mediastream.c:575): no inbound RTP for
        timeout_s => presumed dead."""
        ref = self.last_recv_time or self.created_time
        return (time.monotonic() - ref) < timeout_s

    @staticmethod
    def _is_rtcp(data: bytes) -> bool:
        """RFC 5761 rtcp-mux demultiplexing: PT 200..207."""
        return len(data) >= 2 and 200 <= data[1] <= 207

    def poll(self):
        """Drain transport into the jitter buffer; call once per tick."""
        if self._cleartext_blocked():
            # mandatory encryption, no SRTP yet: inbound plaintext is
            # discarded (ms_srtp.cpp:755 'cannot decrypt but encryption
            # is mandatory')
            self.mandatory_dropped += len(self.transport.recv_all())
            return
        recv_ts = getattr(self.transport, "recv_all_ts", None)
        if recv_ts is not None:
            arrivals = recv_ts()
        else:                       # duck-typed transports (test doubles)
            now = time.monotonic()
            arrivals = [(now, d) for d in self.transport.recv_all()]
        for when, data in arrivals:
            if self._is_rtcp(data):
                if self.rtcp is not None:
                    self.rtcp.process(data)
                continue
            try:
                pkt = RtpPacket.unpack(data)
            except ValueError:
                continue
            if self.vbe is not None:
                self.vbe.on_packet(when, len(data), pkt.timestamp,
                                   pkt.marker)
            if self.abe is not None and \
                    self.abe.on_packet(when, len(data), pkt.seq):
                continue                    # measurement duplicate: drop
            self._deliver(pkt)

    def attach_rtcp(self, interval_s: float = 5.0):
        """Enable rtcp-mux SR/RR on this session's transport."""
        from mediastreamer2_tpu.net.rtcp import RtcpSession
        self.rtcp = RtcpSession(self, interval_s=interval_s)
        return self.rtcp
