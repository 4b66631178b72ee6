"""Native runtime components (C++), loaded via ctypes.

Built on first use with g++ from the committed sources (cached as
_ms2io.so / _ms2rtp.so next to them).  Everything degrades to pure-Python
paths when g++ is absent; a compiler error is raised with its message.
"""
from __future__ import annotations

import ctypes
import os
import socket
import struct
import subprocess
import threading
from typing import List, Optional, Tuple

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "_ms2io.so")
_SRC = os.path.join(_DIR, "io_pump.cpp")

_lib = None
_build_lock = threading.Lock()


class NativeBuildError(RuntimeError):
    """g++ rejected a native source; carries the compiler's message."""


def _build_so(src: str, so: str) -> Optional[ctypes.CDLL]:
    """Compile src -> so if stale, then load (None when g++ is absent).

    Built on (and for) the machine it runs on, so -march=native is safe
    and lets the packet loops vectorize + the SRTP intrinsics path
    (aesni_crypto.h: AES-NI/SHA-NI/PCLMUL) compile.  A compiler error is
    raised with its message, never retried with other flags (a portable
    retry silently dropped the intrinsics path).  Builds are serialized
    across processes by a lock file and written under a per-process
    temporary name, so parallel test workers never install each other's
    half-written output."""
    import fcntl
    src_dir = os.path.dirname(src)

    def stale() -> bool:
        newest = max([os.path.getmtime(src)]
                     + [os.path.getmtime(os.path.join(src_dir, f))
                        for f in os.listdir(src_dir) if f.endswith(".h")])
        return not os.path.exists(so) or newest > os.path.getmtime(so)

    if stale():
        with open(so + ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if stale():                  # another process may have built it
                tmp = f"{so}.{os.getpid()}.tmp"
                try:
                    r = subprocess.run(
                        ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                         "-pthread", src, "-o", tmp, "-ldl"],
                        capture_output=True, text=True, timeout=600)
                except FileNotFoundError:
                    return None          # no toolchain: pure-Python paths
                if r.returncode != 0:
                    raise NativeBuildError(
                        f"g++ failed building {os.path.basename(src)}:\n"
                        f"{r.stderr[-4000:]}")
                os.replace(tmp, so)
    try:
        return ctypes.CDLL(so)
    except OSError:
        return None


def _ensure_built() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    with _build_lock:
        if _lib is not None:
            return _lib
        lib = _build_so(_SRC, _SO)
        if lib is None:
            return None
        lib.ms2_pump_create.restype = ctypes.c_void_p
        lib.ms2_pump_destroy.argtypes = [ctypes.c_void_p]
        lib.ms2_pump_add_socket.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ms2_pump_remove_socket.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ms2_pump_read.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_char_p, ctypes.c_int]
        lib.ms2_pump_dropped.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ms2_pump_dropped.restype = ctypes.c_uint64
        _lib = lib
        return _lib


def native_available() -> bool:
    return _ensure_built() is not None


class NativeIoPump:
    """Epoll-based datagram pump on a native thread (see io_pump.cpp).

    read(fd) returns [(t_ns, bytes), ...] drained since last call.
    """

    def __init__(self, read_buf_size: int = 1 << 20):
        lib = _ensure_built()
        if lib is None:
            raise RuntimeError("native io pump unavailable (g++ build failed)")
        self._lib = lib
        self._pump = lib.ms2_pump_create()
        self._buf = ctypes.create_string_buffer(read_buf_size)

    def add_socket(self, sock) -> None:
        self._lib.ms2_pump_add_socket(self._pump, sock.fileno())

    def remove_socket(self, sock) -> None:
        self._lib.ms2_pump_remove_socket(self._pump, sock.fileno())

    def read(self, sock) -> List[Tuple[int, bytes]]:
        n = self._lib.ms2_pump_read(self._pump, sock.fileno(),
                                    self._buf, len(self._buf))
        out = []
        off = 0
        raw = self._buf.raw
        while off < n:
            t_ns, = struct.unpack_from("<Q", raw, off)
            off += 8
            ln, = struct.unpack_from("<I", raw, off)
            off += 4
            out.append((t_ns, raw[off:off + ln]))
            off += ln
        return out

    def dropped(self, sock) -> int:
        return self._lib.ms2_pump_dropped(self._pump, sock.fileno())

    def close(self):
        if self._pump:
            self._lib.ms2_pump_destroy(self._pump)
            self._pump = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# Batched RTP edge (rtp_edge.cpp): header pack + sendmmsg / recvmmsg drain +
# jitter-ring insert + per-tick playout, three C calls per tick for N legs.
# ---------------------------------------------------------------------------
_RTP_SO = os.path.join(_DIR, "_ms2rtp.so")
_RTP_SRC = os.path.join(_DIR, "rtp_edge.cpp")
_rtp_lib = None


def _ensure_rtp_built() -> Optional[ctypes.CDLL]:
    global _rtp_lib
    if _rtp_lib is not None:
        return _rtp_lib
    with _build_lock:
        if _rtp_lib is not None:
            return _rtp_lib
        lib = _build_so(_RTP_SRC, _RTP_SO)
        if lib is None:
            return None
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.ms2_rtptx_create.restype = ctypes.c_void_p
        lib.ms2_rtptx_create.argtypes = [ctypes.c_int] * 3
        lib.ms2_rtptx_destroy.argtypes = [ctypes.c_void_p]
        lib.ms2_rtptx_config.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_uint32, ctypes.c_uint16, ctypes.c_uint32, ctypes.c_uint8]
        lib.ms2_rtptx_send.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_void_p, ctypes.c_uint32]
        lib.ms2_rtptx_set_gso.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ms2_rtptx_set_threads.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ms2_rtprx_set_threads.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ms2_rtprx_create.restype = ctypes.c_void_p
        lib.ms2_rtprx_create.argtypes = [ctypes.c_int] * 3
        lib.ms2_rtprx_destroy.argtypes = [ctypes.c_void_p]
        lib.ms2_rtprx_add_fd.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ms2_rtprx_map_ssrc.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                           ctypes.c_int]
        lib.ms2_rtprx_set_prefill.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                              ctypes.c_int]
        lib.ms2_rtprx_poll.argtypes = [ctypes.c_void_p]
        lib.ms2_rtprx_read_tick.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                            ctypes.c_void_p]
        lib.ms2_rtprx_stats.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        u64p, u64p, u64p, u64p]
        srtp_args = [ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p,
                     ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p,
                     ctypes.c_int, ctypes.c_int]
        lib.ms2_rtptx_set_srtp.argtypes = srtp_args
        lib.ms2_rtprx_set_srtp.argtypes = srtp_args
        lib.ms2_rtprx_auth_failures.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ms2_rtprx_auth_failures.restype = ctypes.c_uint64
        lib.ms2_rtprx_replay_drops.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ms2_rtprx_replay_drops.restype = ctypes.c_uint64
        _rtp_lib = lib
        return _rtp_lib


def _srtp_session_keys(master_key: bytes, master_salt: bytes, suite: str):
    """Derive (k_e, k_s, k_a, tag_len, gcm) with the KAT-validated RFC 3711
    KDF (tests/test_srtp_kat.py pins derive_key byte-exactly; RFC 7714 §11
    right-pads 96-bit GCM master salts inside derive_key)."""
    from mediastreamer2_tpu.net.srtp import (SUITES, derive_key,
                                             LABEL_RTP_ENCRYPTION,
                                             LABEL_RTP_AUTH, LABEL_RTP_SALT)
    kind, klen, slen, tag = SUITES[suite]
    k_e = derive_key(master_key, master_salt, LABEL_RTP_ENCRYPTION, klen)
    if kind == "gcm":
        k_s = derive_key(master_key, master_salt, LABEL_RTP_SALT, 12)
        return k_e, k_s, b"\x00" * 20, tag, 1
    k_a = derive_key(master_key, master_salt, LABEL_RTP_AUTH, 20)
    k_s = derive_key(master_key, master_salt, LABEL_RTP_SALT, 14)
    return k_e, k_s, k_a, tag, 0


def rtp_edge_available() -> bool:
    return _ensure_rtp_built() is not None


def rtp_edge_hw_crypto() -> bool:
    """True when the edge binary carries the AES-NI/SHA-NI/PCLMUL
    per-packet SRTP path (aesni_crypto.h) instead of libcrypto EVP."""
    lib = _ensure_rtp_built()
    return bool(lib is not None and lib.ms2_rtp_hw_crypto())


_UDP_SEGMENT = 103                       # linux/udp.h
_gso_ok: Optional[bool] = None


def gso_supported() -> bool:
    """Whether this kernel splits a UDP_SEGMENT send into datagrams: one
    two-segment probe over loopback, cached.  Some kernels and user-space
    network stacks refuse the control message, or ignore it and send one
    merged datagram."""
    global _gso_ok
    if _gso_ok is None:
        rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            rx.bind(("127.0.0.1", 0))
            rx.settimeout(0.5)
            tx.connect(rx.getsockname())
            tx.sendmsg([b"a" * 8 + b"b" * 8],
                       [(socket.IPPROTO_UDP, _UDP_SEGMENT,
                         struct.pack("H", 8))])
            _gso_ok = [rx.recv(64), rx.recv(64)] == [b"a" * 8, b"b" * 8]
        except OSError:
            _gso_ok = False
        finally:
            rx.close()
            tx.close()
    return _gso_ok


class BatchRtpTx:
    """Batched RTP sender: one sendmmsg-backed socket carries N legs
    (per-message destination addresses). payloads is a [N, psz] uint8
    array; one call per tick."""

    def __init__(self, sock, n_legs: int, payload_size: int):
        lib = _ensure_rtp_built()
        if lib is None:
            raise RuntimeError("rtp_edge unavailable (g++ build failed)")
        self._lib = lib
        self._sock = sock
        self.n_legs = n_legs
        self.payload_size = payload_size
        self._h = lib.ms2_rtptx_create(sock.fileno(), n_legs, payload_size)

    def config(self, leg: int, ip: str, port: int, ssrc: int,
               seq0: int = 0, ts0: int = 0, pt: int = 0):
        self._lib.ms2_rtptx_config(self._h, leg, ip.encode(), port,
                                   ssrc, seq0, ts0, pt)

    def set_srtp(self, leg: int, master_key: bytes, master_salt: bytes,
                 suite: str = "AES_CM_128_HMAC_SHA1_80"):
        """Enable inline SRTP protection for one leg (AES-CM and
        AEAD-GCM suites). Parity: ms_srtp.cpp:475
        media_stream_set_srtp_send_key — per-packet protect inline on the
        send edge, here batched across legs."""
        k_e, k_s, k_a, tag, gcm = _srtp_session_keys(master_key,
                                                     master_salt, suite)
        if not self._lib.ms2_rtptx_set_srtp(self._h, leg, k_e, len(k_e),
                                            k_s, k_a, tag, gcm):
            raise RuntimeError("native SRTP init failed (libcrypto missing?)")

    def set_threads(self, t: int):
        """Shard pack+protect+send over `t` native worker threads (legs
        partitioned into contiguous ranges, per-leg state touched by one
        worker only). Parity: the reference's per-stream ticker threads
        each run their own libsrtp protect + sendto (msticker.c:448,
        ms_srtp.cpp:475) so its crypto scales with cores by construction;
        here the batched call is sharded to reach the same scaling."""
        self._lib.ms2_rtptx_set_threads(self._h, t)

    def enable_gso(self, remote) -> bool:
        """Single-destination fast path: connect() the socket and let the
        kernel split one 64-segment send into datagrams (UDP_SEGMENT).
        Only valid when every leg targets `remote`.  Returns False, and
        leaves the per-datagram path on, when this kernel does not split
        a segmented send (gso_supported())."""
        if not gso_supported():
            return False
        self._sock.connect(remote)
        self._lib.ms2_rtptx_set_gso(self._h, 1)
        return True

    def send(self, payloads, ts_inc: int, mask=None) -> int:
        import numpy as _np
        payloads = _np.ascontiguousarray(payloads, dtype=_np.uint8)
        assert payloads.shape == (self.n_legs, self.payload_size)
        mptr = None
        if mask is not None:
            mask = _np.ascontiguousarray(mask, dtype=_np.uint8)
            mptr = mask.ctypes.data_as(ctypes.c_void_p)
        return self._lib.ms2_rtptx_send(
            self._h, payloads.ctypes.data_as(ctypes.c_void_p), mptr, ts_inc)

    def close(self):
        if self._h:
            self._lib.ms2_rtptx_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class BatchRtpRx:
    """Batched RTP receiver + fixed-ring jitter buffer for N legs.

    poll() drains all registered sockets with recvmmsg and inserts into
    per-leg seq rings; read_tick() pops one tick of payloads into a
    [N, psz] uint8 matrix plus a present/missing flag vector."""

    def __init__(self, n_legs: int, payload_size: int, ring_depth: int = 64):
        import numpy as _np
        lib = _ensure_rtp_built()
        if lib is None:
            raise RuntimeError("rtp_edge unavailable (g++ build failed)")
        assert ring_depth & (ring_depth - 1) == 0, "depth must be pow2"
        self._lib = lib
        self.n_legs = n_legs
        self.payload_size = payload_size
        self._h = lib.ms2_rtprx_create(n_legs, payload_size, ring_depth)
        self._out = _np.zeros((n_legs, payload_size), _np.uint8)
        self._flags = _np.zeros((n_legs,), _np.uint8)
        self._socks = []

    def add_socket(self, sock, gro: bool = False):
        self._socks.append(sock)               # keep fd alive
        if gro:
            try:                               # UDP_GRO: kernel coalesces
                sock.setsockopt(socket.IPPROTO_UDP, 104, 1)
            except OSError:
                pass
        self._lib.ms2_rtprx_add_fd(self._h, sock.fileno())

    def map_ssrc(self, ssrc: int, leg: int):
        self._lib.ms2_rtprx_map_ssrc(self._h, ssrc, leg)

    def set_prefill(self, leg: int, packets: int):
        self._lib.ms2_rtprx_set_prefill(self._h, leg, packets)

    def set_srtp(self, leg: int, master_key: bytes, master_salt: bytes,
                 suite: str = "AES_CM_128_HMAC_SHA1_80"):
        """Enable inline SRTP unprotection (auth + decrypt before the
        jitter-ring insert) for one leg, AES-CM or AEAD-GCM. Parity:
        ms_srtp.cpp:672 media_stream_set_srtp_recv_key."""
        k_e, k_s, k_a, tag, gcm = _srtp_session_keys(master_key,
                                                     master_salt, suite)
        if not self._lib.ms2_rtprx_set_srtp(self._h, leg, k_e, len(k_e),
                                            k_s, k_a, tag, gcm):
            raise RuntimeError("native SRTP init failed (libcrypto missing?)")

    def auth_failures(self, leg: int) -> int:
        return self._lib.ms2_rtprx_auth_failures(self._h, leg)

    def replay_drops(self, leg: int) -> int:
        """Authenticated-but-replayed packets rejected by the RFC 3711
        §3.3.2 sliding window (cf. libsrtp2's srtp_unprotect replay list,
        which the reference inherits via ms_srtp.cpp)."""
        return self._lib.ms2_rtprx_replay_drops(self._h, leg)

    def set_threads(self, t: int):
        """Shard verify+decrypt+insert and playout over `t` native worker
        threads (packets partitioned by leg)."""
        self._lib.ms2_rtprx_set_threads(self._h, t)

    def poll(self) -> int:
        return self._lib.ms2_rtprx_poll(self._h)

    def read_tick(self):
        self._lib.ms2_rtprx_read_tick(
            self._h, self._out.ctypes.data_as(ctypes.c_void_p),
            self._flags.ctypes.data_as(ctypes.c_void_p))
        return self._out, self._flags

    def stats(self, leg: int):
        got = ctypes.c_uint64(); lost = ctypes.c_uint64()
        late = ctypes.c_uint64(); recv = ctypes.c_uint64()
        self._lib.ms2_rtprx_stats(self._h, leg, ctypes.byref(got),
                                  ctypes.byref(lost), ctypes.byref(late),
                                  ctypes.byref(recv))
        return {"got": got.value, "lost": lost.value,
                "late": late.value, "recv": recv.value}

    def close(self):
        if self._h:
            self._lib.ms2_rtprx_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
