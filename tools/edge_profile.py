"""Host-edge cost profile: where the per-packet nanoseconds go.

The e2e/SRTP capacity rows can be host-bound: every leg costs the host
a pack+protect+send on tx and a recv+verify+decrypt+insert on rx, once
per 10 ms tick.  This tool measures those two halves in isolation over
loopback UDP — no device, no pacing — so a crypto/header/syscall
optimization can be judged in ns/packet before a GPU bench run.

Usage:  python tools/edge_profile.py [n_legs] [payload]
Output: one JSON line {config: ns_per_packet, ...}.

Parity context: the reference's equivalent costs live in oRTP's
rtp_session_rtp_send + libsrtp2 srtp_protect (ms_srtp.cpp:475) per
stream; here they are batched per tick across N legs (rtp_edge.cpp).
"""
import json
import os
import socket
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mediastreamer2_tpu.native import BatchRtpRx, BatchRtpTx  # noqa: E402

KEY = bytes(range(16))
SALT = bytes(range(14))


def make_pair(n, psz, suite=None, threads=1):
    tx_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    tx_sock.bind(("127.0.0.1", 0))
    rx_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx_sock.bind(("127.0.0.1", 0))
    rx_sock.setblocking(False)
    rx_sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 24)
    port = rx_sock.getsockname()[1]
    tx = BatchRtpTx(tx_sock, n, psz)
    rx = BatchRtpRx(n, psz, ring_depth=64)
    rx.add_socket(rx_sock, gro=True)
    for i in range(n):
        tx.config(i, "127.0.0.1", port, ssrc=0x1000 + i, seq0=1)
        rx.map_ssrc(0x1000 + i, i)
        rx.set_prefill(i, 0)
        if suite:
            tx.set_srtp(i, KEY, SALT, suite=suite)
            rx.set_srtp(i, KEY, SALT, suite=suite)
    tx.enable_gso(("127.0.0.1", port))
    if threads > 1:
        tx.set_threads(threads)
        rx.set_threads(threads)
    return tx, rx, (tx_sock, rx_sock)


def profile(n=2048, psz=80, ticks=200, suite=None, threads=1):
    import numpy as np
    tx, rx, socks = make_pair(n, psz, suite, threads)
    payloads = np.random.randint(0, 256, (n, psz), dtype=np.uint8)
    # warmup
    for _ in range(5):
        tx.send(payloads, ts_inc=80)
        rx.poll()
        rx.read_tick()
    tx_ns = rx_ns = 0.0
    sent = got = 0
    for _ in range(ticks):
        t0 = time.perf_counter_ns()
        sent += tx.send(payloads, ts_inc=80)
        t1 = time.perf_counter_ns()
        got += rx.poll()
        rx.read_tick()
        t2 = time.perf_counter_ns()
        tx_ns += t1 - t0
        rx_ns += t2 - t1
    auth = sum(rx.auth_failures(i) for i in range(min(n, 8)))
    for s in socks:
        s.close()
    tx.close()
    rx.close()
    per = {"tx_ns_per_pkt": round(tx_ns / max(sent, 1), 1),
           "rx_ns_per_pkt": round(rx_ns / max(got, 1), 1),
           "sent": sent, "received": got, "auth_failures_sample": auth}
    return per


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2048
    psz = int(sys.argv[2]) if len(sys.argv) > 2 else 80
    out = {"n_legs": n, "payload": psz}
    for name, suite in (("clear", None),
                        ("cm", "AES_CM_128_HMAC_SHA1_80"),
                        ("gcm", "AEAD_AES_128_GCM")):
        out[name] = profile(n, psz, suite=suite)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
