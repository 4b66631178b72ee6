#!/usr/bin/env python
"""CLI softphone/leg-runner — parity with the reference's
tools/mediastream.c (the everything-switch test client) and tools/bench.c.

Examples:
  # duplex G.711 call leg to a remote endpoint
  python tools/mediastream.py call --local-port 7078 --remote 1.2.3.4:7078 \
      --codec ulaw --rate 8000 --ec --agc

  # N batched loopback legs for load testing (bench.c pattern)
  python tools/mediastream.py bench --legs 50 --seconds 5

  # play a wav
  python tools/mediastream.py play file.wav
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def cmd_call(args):
    from mediastreamer2_tpu.core.factory import Factory
    from mediastreamer2_tpu.models.audio_stream import (AudioStreamBatch,
                                                        AudioStreamFeatures)
    from mediastreamer2_tpu.net.rtp import UdpTransport
    from mediastreamer2_tpu.io.wav import read_wav

    factory = Factory()
    feats = AudioStreamFeatures(echo_canceller=args.ec, agc=args.agc,
                                noise_gate=args.ng, plc=True,
                                vad_dtx=args.vad)
    sig = None
    if args.infile:
        sig, rate = read_wav(args.infile)
        if rate != args.rate:
            print(f"warning: file rate {rate} != {args.rate}")
    card = None
    if args.card:
        from mediastreamer2_tpu.core.devices import SndCardManager
        mgr = SndCardManager()
        card = mgr.get_card(args.card) or (mgr.cards[0] if mgr.cards else None)
        print(f"sound card: {card}")
    stream = AudioStreamBatch(factory, 1, codec=args.codec, rate=args.rate,
                              features=feats, mic_signal=sig,
                              record_ticks=args.seconds * 100,
                              snd_card=card)
    mcast = args.multicast
    t = UdpTransport(local_port=args.local_port,
                     bind_host="0.0.0.0" if mcast else "127.0.0.1",
                     reuse_addr=bool(mcast))
    if mcast:
        t.join_multicast_group(mcast)
        t.set_remote(mcast, args.local_port)
    if args.remote:
        host, port = args.remote.rsplit(":", 1)
        t.set_remote(host, int(port))
    if args.symmetric:
        t.set_symmetric(True)
    if args.dscp:
        t.set_dscp(args.dscp)
    if args.use_native_pump:
        from mediastreamer2_tpu.native import NativeIoPump
        t.attach_pump(NativeIoPump())
    stream.set_transport(0, t)
    if args.srtp_key:
        import binascii
        from mediastreamer2_tpu.net.srtp import SUITES
        km = binascii.unhexlify(args.srtp_key)
        _k, klen, slen, _t = SUITES[args.srtp_suite]
        stream.enable_srtp(0, km[:klen], km[klen:klen + slen],
                           km[:klen], km[klen:klen + slen],
                           suite=args.srtp_suite)
    print(f"call leg up: 127.0.0.1:{t.local_port} -> {args.remote} "
          f"codec={args.codec}@{args.rate} features={feats}")
    stream.run(args.seconds * 100)
    st = stream.get_stats(0)
    print(f"sent={st.sent_packets} recv={st.recv_packets} "
          f"jb_lost={stream.sessions[0].jitter_buffer.lost} "
          f"load={stream.ticker.get_average_load():.3f} "
          f"late={stream.ticker.stats.late_ticks}")
    if args.outfile and stream.get_recording() is not None:
        from mediastreamer2_tpu.io.wav import write_wav
        write_wav(args.outfile, stream.get_recording()[0], args.rate)
        print(f"recorded -> {args.outfile}")


def cmd_bench(args):
    """Loopback leg scaling (tools/bench.c: 50 legs per block)."""
    from mediastreamer2_tpu.core.factory import Factory
    from mediastreamer2_tpu.models.audio_stream import AudioStreamBatch
    from mediastreamer2_tpu.net.rtp import LoopbackPair
    from mediastreamer2_tpu.utils.signals import make_speechlike

    factory = Factory()
    B = args.legs
    ticks = args.seconds * 100
    sig = make_speechlike(80 * ticks, 8000)
    tx = AudioStreamBatch(factory, B, mic_signal=sig)
    rx = AudioStreamBatch(factory, B)
    for leg in range(B):
        pair = LoopbackPair()
        tx.set_transport(leg, pair.endpoint(0))
        rx.set_transport(leg, pair.endpoint(1))
    tx.ticker.warm_up()
    rx.ticker.warm_up()
    rx.start(ticks + 20)
    t0 = time.perf_counter()
    tx.run(ticks)
    dt = time.perf_counter() - t0
    tx.stop(); rx.stop()
    print(f"{B} duplex legs x {ticks} ticks in {dt:.2f}s "
          f"(tx load {tx.ticker.get_average_load():.3f}, "
          f"late {tx.ticker.stats.late_ticks})")


def cmd_ring(args):
    """Ring-tone playback (reference tools/ring.c)."""
    from mediastreamer2_tpu.core.factory import Factory
    from mediastreamer2_tpu.models.ring_stream import RingStreamBatch
    from mediastreamer2_tpu.io.wav import read_wav
    import numpy as np
    if args.file:
        sig, rate = read_wav(args.file)
    else:
        rate = 8000
        t = np.arange(rate) / rate
        sig = (0.4 * np.sin(2 * np.pi * 440 * t)
               * (np.sin(2 * np.pi * 2 * t) > 0)).astype(np.float32)
    ring = RingStreamBatch(Factory(), batch=1, signal=sig, rate=rate,
                           loop=True)
    chunks = []
    ring.ticker.set_io(push=lambda t, o: chunks.append(o["spk"]))
    ring.start(args.seconds * 100)
    time.sleep(args.seconds)
    ring.stop()
    print(f"rang for {args.seconds}s ({len(chunks)} ticks)")


def cmd_echo(args):
    """Audio loopback echo test (reference tools/echo.c: mic->speaker)."""
    from mediastreamer2_tpu.core.factory import Factory
    from mediastreamer2_tpu.core.graph import GraphBuilder
    from mediastreamer2_tpu.core.block import Format, tick_samples
    from mediastreamer2_tpu.core.ticker import Ticker
    import numpy as np
    f = Factory()
    g = GraphBuilder(f, batch=1)
    src = g.add("ext_source", "mic", fmt=Format(rate=args.rate))
    vol = g.add("volume", "vol")
    g.link(src, 0, vol, 0)
    g.link(vol, 0, g.add("ext_sink", "spk"), 0)
    tk = Ticker(g.build())
    S = tick_samples(args.rate)
    out = []
    tk.set_io(pull=lambda t: {"mic": np.zeros((1, S), np.float32)},
              push=lambda t, o: out.append(o["spk"]))
    tk.warm_up()
    tk.run(args.seconds * 100)
    print(f"echo loop ran {tk.stats.ticks} ticks, load "
          f"{tk.get_average_load():.3f}, late {tk.stats.late_ticks}")


def cmd_play(args):
    from mediastreamer2_tpu.core.factory import Factory
    from mediastreamer2_tpu.models.media_player import MediaPlayer
    mp = MediaPlayer(Factory())
    mp.open(args.file)
    done = []
    mp.on_eof = lambda: done.append(1)
    mp.start()
    print(f"playing {args.file} ({mp.duration_ms} ms)")
    while not done and mp.get_position_ms() < mp.duration_ms + 200:
        time.sleep(0.1)
        mp.ticker.event_queue.pump()
    mp.close()
    print("done")


def cmd_tones(args):
    """DTMF tone generate + detect loop (reference tools/tones.c:
    dtmfgen -> tonedetector -> filerec graph)."""
    from mediastreamer2_tpu.core.factory import Factory
    from mediastreamer2_tpu.core.graph import GraphBuilder
    from mediastreamer2_tpu.core.block import Format, tick_samples
    from mediastreamer2_tpu.ops.tones import dtmf_freqs, classify_dtmf
    import jax.numpy as jnp

    f = Factory()
    rate = args.rate
    S = tick_samples(rate)
    g = GraphBuilder(f, batch=1)
    src = g.add("void_source", "vs", fmt=Format(rate=rate))
    gen = g.add("dtmf_gen", "gen")
    det = g.add("tone_detector", "det")
    sink = g.add("ext_sink", "out")
    g.chain(src, gen, det, sink)
    cg = g.build()
    params, st = cg.init_params(), cg.init_state()
    audio = []
    detected = []
    ticks_per_digit = max(args.duration_ms // 10, 2)
    for digit in args.digits:
        f1, f2 = dtmf_freqs(digit)
        params["gen"]["f1"] = jnp.array([f1], jnp.float32)
        params["gen"]["f2"] = jnp.array([f2], jnp.float32)
        params["gen"]["remaining"] = jnp.array(
            [S * (ticks_per_digit - 1)], jnp.int32)
        peak = np.zeros(8, np.float32)
        for _ in range(ticks_per_digit + 3):     # digit + inter-digit gap
            st, out, ev = cg.step(st, params, {})
            params["gen"]["remaining"] = jnp.maximum(
                params["gen"]["remaining"] - S, 0)
            audio.append(np.asarray(out["out"])[0])
            peak = np.maximum(peak, np.asarray(st["det"]["power"])[0])
        detected.append(classify_dtmf(peak))
    got = "".join(detected)
    print(f"generated '{args.digits}' -> detected '{got}'")
    if args.outfile:
        from mediastreamer2_tpu.io.wav import write_wav
        write_wav(args.outfile, np.concatenate(audio), rate)
        print(f"wrote {args.outfile}")
    sys.exit(0 if got == args.digits.upper() else 1)


def cmd_audiocmp(args):
    """Similarity of two audio files (reference tools/msaudiocmp.c:
    ms_audio_diff with overlap percentage)."""
    from mediastreamer2_tpu.io.wav import read_wav
    from mediastreamer2_tpu.utils.audiodiff import audio_diff
    a, ra = read_wav(args.file1)
    b, rb = read_wav(args.file2)
    if ra != rb:
        print(f"rate mismatch: {ra} vs {rb}")
        sys.exit(2)
    max_shift = max(len(a), len(b)) * args.max_shift_percent // 100
    sim, shift = audio_diff(a, b, max_shift=max_shift)
    print(f"{args.file1} and {args.file2} are similar with a degree of "
          f"{sim:g} (shift {shift} samples).")
    sys.exit(0 if sim >= args.threshold else 1)


def cmd_mtu(args):
    """Path-MTU discovery (reference tools/mtudiscover.c ->
    ms_discover_mtu)."""
    from mediastreamer2_tpu.core.worker import discover_mtu
    mtu = discover_mtu(args.host, args.port)
    print(f"mtu to {args.host}: {mtu}")


def cmd_pcap_play(args):
    """Replay a pcap's RTP stream through the jitter buffer + decoder to a
    wav (reference tools/pcap_playback.c with MSPCAPFilePlayer)."""
    import jax
    import jax.numpy as jnp
    from mediastreamer2_tpu.io.pcap import PcapRtpPlayer
    from mediastreamer2_tpu.net.jitter import JitterBuffer, JBParams
    from mediastreamer2_tpu.ops.g711 import ulaw_decode, alaw_decode
    from mediastreamer2_tpu.io.wav import write_wav

    player = PcapRtpPlayer(args.file, payload_type=args.pt or None)
    print(f"{len(player.packets)} RTP packets in {args.file}")
    jb = JitterBuffer(JBParams())
    rate = args.rate
    dec_fn = {0: ulaw_decode, 8: alaw_decode}.get(args.pt)

    def decode(payload: bytes) -> np.ndarray:
        codes = jnp.asarray(np.frombuffer(payload, np.uint8)
                            .astype(np.int32))
        return np.asarray(dec_fn(codes)).astype(np.float32) / 32768.0

    out = []
    tick = 0
    while not player.finished or jb.buf:
        for pkt in player.due(tick * 0.01):
            jb.put(pkt, now=tick * 0.01)
        payload = jb.get_tick()
        if payload is not None and dec_fn is not None:
            out.append(decode(payload))
        tick += 1
        if tick > 100 * 3600:
            break
    if out and args.outfile:
        write_wav(args.outfile, np.concatenate(out), rate)
        print(f"decoded {tick} ticks -> {args.outfile} "
              f"(lost {jb.lost}, late {jb.late})")
    else:
        print(f"replayed {tick} ticks (lost {jb.lost}, late {jb.late})")


def cmd_record(args):
    """Record capture (sound card or tone) to wav/mkv/smff (reference
    tools/recorder.c with MSMediaRecorder)."""
    from mediastreamer2_tpu.core.factory import Factory
    from mediastreamer2_tpu.core.block import tick_samples
    from mediastreamer2_tpu.models.media_player import MediaRecorder

    rate = args.rate
    S = tick_samples(rate)
    rec = MediaRecorder(Factory(), rate=rate, max_seconds=args.seconds + 1)
    card = None
    if args.card:
        from mediastreamer2_tpu.core.devices import SndCardManager
        mgr = SndCardManager()
        card = mgr.get_card(args.card)
        print(f"capturing from {card}")
    if card is not None:
        rec.set_input(lambda t: np.asarray(card.pull(t, 1))[0])
    else:
        # no capture hardware: record a test tone (like recorder.c run
        # against the null card)
        tt = np.arange(S) / rate

        def tone(t):
            return (0.3 * np.sin(2 * np.pi * 440 * (tt + t * S / rate))
                    ).astype(np.float32)
        rec.set_input(tone)
    rec.run(args.seconds * 100)
    rec.stop_and_save(args.outfile)
    print(f"recorded {args.seconds}s -> {args.outfile}")


def cmd_mkvstream(args):
    """Stream an MKV video track out over RTP (reference
    tools/mkvstream.c: H264 track -> RTP to destination)."""
    from mediastreamer2_tpu.io.mkv import MkvReader, TRACK_TYPE_VIDEO
    from mediastreamer2_tpu.net.rtp import UdpTransport, RtpSession
    from mediastreamer2_tpu.models.media_player import _parse_avcc

    r = MkvReader(args.file)
    video = [t for t in r.tracks.values() if t.type == TRACK_TYPE_VIDEO]
    if not video:
        print("no video track")
        sys.exit(1)
    track = video[0]
    host, port = args.dest.rsplit(":", 1)
    t = UdpTransport(local_port=args.local_port)
    t.set_remote(host, int(port))
    sess = RtpSession(t, payload_type=args.pt, clock_rate=90000)
    sent = 0
    t0 = time.perf_counter()
    if track.codec_id == "V_VP8":
        from mediastreamer2_tpu.ops.vp8 import vp8_payload_pack
        for fr in r.frames():
            if fr.track != track.number:
                continue
            while time.perf_counter() - t0 < fr.ts_ms / 1000:
                time.sleep(0.001)
            payloads = vp8_payload_pack(
                [fr.data[i:i + args.mtu]
                 for i in range(0, len(fr.data), args.mtu)],
                picture_id=sent & 0x7FFF)
            for k, p in enumerate(payloads):
                sess.send_payload(p, ts_increment=(
                    90 * 33 if k == len(payloads) - 1 else 0),
                    marker=(k == len(payloads) - 1))
            sent += 1
    elif track.codec_id.startswith("V_MPEG4/ISO/AVC"):
        from mediastreamer2_tpu.net.h26x import packetize
        avcc = _parse_avcc(track.codec_private)
        if avcc is None:
            print("bad avcC codec private")
            sys.exit(1)
        nal_len, param_sets = avcc
        first = True
        for fr in r.frames():
            if fr.track != track.number:
                continue
            while time.perf_counter() - t0 < fr.ts_ms / 1000:
                time.sleep(0.001)
            nals = list(param_sets) if (first or fr.keyframe) else []
            first = False
            pos = 0
            while pos + nal_len <= len(fr.data):
                ln = int.from_bytes(fr.data[pos:pos + nal_len], "big")
                pos += nal_len
                nals.append(fr.data[pos:pos + ln])
                pos += ln
            payloads = packetize(nals, mtu=args.mtu)
            for k, p in enumerate(payloads):
                sess.send_payload(p, ts_increment=(
                    90 * 33 if k == len(payloads) - 1 else 0),
                    marker=(k == len(payloads) - 1))
            sent += 1
    else:
        print(f"unsupported codec {track.codec_id}")
        sys.exit(1)
    print(f"streamed {sent} frames of {track.codec_id} to {args.dest}")


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--platform", default="cpu", choices=["cpu", "gpu"],
                    help="cpu (default): local realtime loop; gpu: device "
                         "graph on the NVIDIA GPU (fails without one)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("call")
    c.add_argument("--local-port", type=int, default=7078)
    c.add_argument("--remote", default="")
    c.add_argument("--codec", default="ulaw",
                   choices=["ulaw", "alaw", "l16", "opus", "gsm", "g722"])
    c.add_argument("--rate", type=int, default=8000)
    c.add_argument("--ec", action="store_true", help="echo canceller")
    c.add_argument("--agc", action="store_true")
    c.add_argument("--ng", action="store_true", help="noise gate")
    c.add_argument("--vad", action="store_true", help="VAD/DTX")
    c.add_argument("--srtp-key", default="", help="hex master key||salt")
    c.add_argument("--srtp-suite", default="AES_CM_128_HMAC_SHA1_80",
                   help="AES_CM_128_HMAC_SHA1_80 | AEAD_AES_128_GCM | ...")
    c.add_argument("--multicast", default="",
                   help="multicast group to join/send to (e.g. 224.1.2.3)")
    c.add_argument("--symmetric", action="store_true",
                   help="symmetric RTP: follow the peer's source address")
    c.add_argument("--dscp", type=int, default=0,
                   help="DSCP mark for media packets (e.g. 46 = EF)")
    c.add_argument("--infile", default="", help="wav to send instead of mic")
    c.add_argument("--card", default="",
                   help="sound card name (alsa:default, pulse:default, ...)")
    c.add_argument("--outfile", default="", help="record received audio")
    c.add_argument("--seconds", type=int, default=10)
    c.add_argument("--use-native-pump", action="store_true")
    c.set_defaults(fn=cmd_call)

    b = sub.add_parser("bench")
    b.add_argument("--legs", type=int, default=50)
    b.add_argument("--seconds", type=int, default=5)
    b.set_defaults(fn=cmd_bench)

    p = sub.add_parser("play")
    p.add_argument("file")
    p.set_defaults(fn=cmd_play)

    r = sub.add_parser("ring")
    r.add_argument("--file", default="")
    r.add_argument("--seconds", type=int, default=3)
    r.set_defaults(fn=cmd_ring)

    e = sub.add_parser("echo")
    e.add_argument("--rate", type=int, default=8000)
    e.add_argument("--seconds", type=int, default=3)
    e.set_defaults(fn=cmd_echo)

    t = sub.add_parser("tones", help="DTMF generate+detect (tools/tones.c)")
    t.add_argument("digits", help="e.g. 123A#")
    t.add_argument("--rate", type=int, default=8000)
    t.add_argument("--duration-ms", type=int, default=100)
    t.add_argument("--outfile", default="")
    t.set_defaults(fn=cmd_tones)

    a = sub.add_parser("audiocmp",
                       help="wav similarity (tools/msaudiocmp.c)")
    a.add_argument("file1")
    a.add_argument("file2")
    a.add_argument("--max-shift-percent", type=int, default=10)
    a.add_argument("--threshold", type=float, default=0.0)
    a.set_defaults(fn=cmd_audiocmp)

    m = sub.add_parser("mtu", help="path MTU (tools/mtudiscover.c)")
    m.add_argument("host")
    m.add_argument("--port", type=int, default=5060)
    m.set_defaults(fn=cmd_mtu)

    pc = sub.add_parser("pcap-play",
                        help="replay pcap RTP (tools/pcap_playback.c)")
    pc.add_argument("file")
    pc.add_argument("--pt", type=int, default=0)
    pc.add_argument("--rate", type=int, default=8000)
    pc.add_argument("--outfile", default="")
    pc.set_defaults(fn=cmd_pcap_play)

    rc = sub.add_parser("record", help="record to file (tools/recorder.c)")
    rc.add_argument("outfile", help=".wav / .mkv / .smff")
    rc.add_argument("--rate", type=int, default=8000)
    rc.add_argument("--seconds", type=int, default=5)
    rc.add_argument("--card", default="")
    rc.set_defaults(fn=cmd_record)

    mk = sub.add_parser("mkvstream",
                        help="stream MKV video over RTP (tools/mkvstream.c)")
    mk.add_argument("file")
    mk.add_argument("dest", help="host:port")
    mk.add_argument("--local-port", type=int, default=9078)
    mk.add_argument("--pt", type=int, default=102)
    mk.add_argument("--mtu", type=int, default=1400)
    mk.set_defaults(fn=cmd_mkvstream)

    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms",
                      "cuda" if args.platform == "gpu" else "cpu")
    args.fn(args)


if __name__ == "__main__":
    main()
