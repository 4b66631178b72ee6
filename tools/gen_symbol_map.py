"""Generate docs/SYMBOLS.md: every MS2_PUBLIC symbol of the reference's
public API, bucketed per header with its mapping into mediastreamer2_tpu.

MIGRATION.md covers the major objects; this script gives the full
symbol-by-symbol map: it
greps `include/mediastreamer2/*.h` for MS2_PUBLIC declarations (1,090
functions), assigns each header a target module + default status, and
applies per-symbol overrides where the mapping is not the header default.

Statuses:
  yes      — capability exists (API shape may differ; see module/note)
  n/a      — platform/JNI/GL/helper surface that has no meaning here
             (headless server target, or Python replaces the C mechanics)
  partial  — capability exists with documented limits
Run:  python tools/gen_symbol_map.py  (rewrites docs/SYMBOLS.md)
"""
from __future__ import annotations

import os
import re
import sys
from collections import OrderedDict

REF = "/root/reference/include/mediastreamer2"
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "docs", "SYMBOLS.md")

# header -> (module(s) here, default status, header note)
HEADERS = OrderedDict([
    ("msfactory.h", ("core/factory.py", "yes",
                     "registry/plugins/codec lookup; statistics via "
                     "CompiledGraph.profile_nodes")),
    ("msfilter.h", ("core/filter.py + core/graph.py", "yes",
                    "FilterDef + params-as-methods; graphs are built then "
                    "compiled (SSA), links are GraphBuilder.link")),
    ("msticker.h", ("core/ticker.py", "yes",
                    "host tick loop, EWMA load, late ticks, SCHED_RR prio, "
                    "TickerSynchronizer skew")),
    ("msqueue.h", ("core/graph.py (SSA edges)", "yes",
                   "queues/bufferizers are compiled dataflow edges; host "
                   "byte FIFOs live in net/jitter.py")),
    ("mseventqueue.h", ("core/events.py", "yes",
                        "device flag tensors -> host queue, 1024 cap")),
    ("msasync.h", ("core/worker.py", "yes", "MSWorkerThread/MSTask")),
    ("mscommon.h", ("package __init__ + core/*", "yes",
                    "init/version/logging/payload-type tables")),
    ("mscodecutils.h", ("models/qos.py + ops/host_codecs.py", "yes",
                        "concealment context, bitrate driver helpers")),
    ("msrtp.h", ("net/rtp.py + native/rtp_edge.cpp", "yes",
                 "batched native edge: sendmmsg/GSO tx, recvmmsg/GRO rx")),
    ("mediastream.h", ("models/audio_stream.py, models/video_stream.py, "
                       "models/call_setup.py, net/rtt.py", "yes",
                       "AudioStreamBatch/VideoStreamBatch host N legs; "
                       "per-call ops take a leg index")),
    ("msconference.h", ("models/conference.py + net/router.py", "yes",
                        "segment-sum mix-minus; SFU router")),
    ("bitratecontrol.h", ("models/qos.py", "yes",
                          "analyzers, drivers, bandwidth controller")),
    ("msvideoqualitycontroller.h", ("models/video_presets.py", "yes", "")),
    ("qualityindicator.h", ("models/qos.py MSQualityIndicator", "yes", "")),
    ("msvideopresets.h", ("models/video_presets.py", "yes", "")),
    ("msvideo.h", ("ops/video.py", "yes",
                   "YUV/RGB conversion, scaler, rotation as batched XLA")),
    ("msvideoout.h", ("models/video_stream.py displays", "partial",
                      "headless analyse/callback/JPEG sinks; windowed GL "
                      "display out of scope (server target)")),
    ("mswebcam.h", ("core/devices.py + core/v4l2.py", "yes",
                    "mire/static/ext-push + v4l2 ioctl capture")),
    ("mssndcard.h", ("core/devices.py + core/alsa.py + core/pulse.py", "yes",
                     "dlopen-gated ALSA/Pulse duplex cards, hot swap")),
    ("msinterfaces.h", ("core/filter.py interfaces=", "yes",
                        "trait strings on FilterDef")),
    ("ms_srtp.h", ("net/srtp.py + native/rtp_edge.cpp SRTP", "yes",
                   "RFC-KAT-pinned SRTP/SRTCP, EKT, batched native edge")),
    ("zrtp.h", ("net/zrtp.py", "yes",
                "RFC 6189 wire format, X25519, GoClear")),
    ("dtls_srtp.h", ("net/dtls.py", "yes",
                     "OpenSSL ctypes, fingerprint verification")),
    ("stun.h", ("net/stun.py + net/turn.py + net/turn_tcp.py", "yes",
                "RFC 5389/5766/6062; checked against a foreign agent")),
    ("ice.h", ("net/ice.py", "yes",
               "Ta pacing, roles, restart, relay; breadth below ice.c "
               "noted in PARITY.md")),
    ("upnp_igd.h", ("net/upnp.py", "yes", "SSDP + SOAP port mapping")),
    ("msmediaplayer.h", ("models/media_player.py", "yes",
                         "wav/mkv/mka/smff A/V, StreamRegulator paced")),
    ("msmediarecorder.h", ("models/media_player.py recorder half", "yes",
                           "wav + A/V mkv")),
    ("msfileplayer.h", ("ops/fileio.py file_player", "yes", "")),
    ("msfilerec.h", ("ops/fileio.py file_recorder", "yes", "")),
    ("msvolume.h", ("ops/volume.py", "yes", "AGC/gain/DC/noise-gate")),
    ("msequalizer.h", ("ops/equalizer.py", "yes", "")),
    ("flowcontrol.h", ("ops/flowcontrol.py", "yes", "")),
    ("msvaddtx.h", ("ops/vad.py", "yes", "")),
    ("msgenericplc.h", ("ops/plc.py", "yes", "")),
    ("msitc.h", ("models (graph splice)", "yes",
                 "inter-ticker pipes are graph edges / host queues")),
    ("msudp.h", ("net/rtp.py UdpTransport", "yes", "")),
    ("mstee.h", ("core/graph.py fan-out edges", "yes", "")),
    ("msextdisplay.h", ("models/video_stream.py callback sink", "yes", "")),
    ("rfc3984.h", ("ops/h264.py + net/h26x.py", "yes",
                   "RFC 6184 pack/unpack")),
    ("msjpegwriter.h", ("ops/video.py jpeg snapshot", "yes", "")),
    ("msqrcodereader.h", ("models/video_stream.py QR (cv2)", "yes", "")),
    ("msrtt4103.h", ("net/rtt.py", "yes", "RFC 4103 + RED")),
    ("baudot.h", ("ops/baudot.py", "yes", "45.45/50 baud, EUROPE mode")),
    ("mspcapfileplayer.h", ("io/pcap.py", "yes", "replays pcap/pcapng")),
    ("msutils.h", ("utils/audiodiff.py", "yes", "the test oracle")),
    ("devices.h", ("core/quirks.py", "yes", "device quirk DB + EQ rows")),
    ("mstonedetector.h", ("ops/dtmf.py tone detector", "yes", "")),
    ("dtmfgen.h", ("ops/dtmf.py", "yes", "+ RFC 4733 at the edge")),
    ("msdsptools.h", ("ops/rfft.py + ops/*", "yes",
                      "spectra as (re,im) matmul pairs — no complex dtype")),
    ("formats.h", ("core/block.py Format", "yes", "")),
    ("allfilters.h", ("core/factory.py registry", "yes", "")),
    ("msvideo4linux2.h" if os.path.exists(
        os.path.join(REF, "msvideo4linux2.h")) else "msv4l.h",
     ("core/v4l2.py", "yes", "pure-ioctl, gated on /dev/video*")),
    ("msscreensharing.h", ("video/x11grab.py", "yes", "X11 grab, gated")),
    ("video-aggregator.h", ("models/video_stream.py aggregator", "yes", "")),
    # --- no-meaning-here surfaces ---------------------------------------
    ("android_utils.h", ("—", "n/a", "Android JNI helper surface")),
    ("msjava.h", ("—", "n/a", "JNI bridge")),
    ("x11_helper.h", ("—", "n/a",
                      "X11 window helper for GL display (headless target); "
                      "screen *capture* is video/x11grab.py")),
    ("mschanadapter.h", ("ops/channel_adapter.py", "yes", "")),
    ("msmire.h", ("ops/video.py mire", "yes", "")),
    ("msnowebcam.h", ("core/devices.py nowebcam fallback", "yes", "")),
    ("waveheader.h", ("ops/fileio.py wav header", "yes", "")),
])

# name patterns that are platform/windowed surface wherever they appear
N_A_PATTERNS = [
    (re.compile(r"^ms_android_|_android_sound_utils|^ms_get_jni_env"),
     "Android JNI surface"),
    (re.compile(r"window_id|_video_window"), "windowed display (headless "
     "target; analyse/callback/JPEG sinks instead)"),
]

# per-symbol overrides: symbol -> (status, note)
OVERRIDES = {
    "ms_display_desc_get_default": ("n/a", "windowed display"),
    # mediastream.h — echo limiter maps to the AEC output limiter blend
    "audio_stream_enable_echo_limiter": (
        "yes", "continuous output limiter inside ops/aec.py"),
    # srtp AES-192 (reference gates it on libsrtp build too) — the suite
    # table genuinely lacks AES-192, so this is partial, not yes
    "ms_crypto_suite_build_from_name_params": (
        "partial", "net/srtp.py sdes_parse; AES-192 suites not implemented"),
}


DECL = re.compile(r"MS2_PUBLIC[^;{(]*?([a-zA-Z_][a-zA-Z0-9_]*)\s*\(")
VAR = re.compile(r"MS2_PUBLIC\s+(?:extern\s+)?[a-zA-Z_][\w\s\*]*?"
                 r"([a-zA-Z_][a-zA-Z0-9_]*)\s*;")


def symbols_of(path: str):
    try:
        text = open(path, errors="replace").read()
    except OSError:
        return []
    # strip comments so commented-out decls don't count
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    text = re.sub(r"//[^\n]*", "", text)
    out = []
    for m in DECL.finditer(text):
        name = m.group(1)
        if name not in out:
            out.append(name)
    return out


def main():
    lines = ["# Public-symbol map — mediastreamer2 -> mediastreamer2_tpu",
             "",
             "Generated by `tools/gen_symbol_map.py` from "
             "`include/mediastreamer2/*.h` (MS2_PUBLIC declarations). "
             "Statuses: **yes** = capability exists here (API is batched/"
             "leg-indexed — see docs/MIGRATION.md for the shape), "
             "**n/a** = platform/JNI/windowed-GL surface with no meaning "
             "for the headless GPU server target, **partial** = exists "
             "with documented limits.", "",
             "Known-partial capabilities NOT visible at symbol "
             "granularity (filter IDs, not MS2_PUBLIC functions): "
             "**AAC-ELD profile** is permanently gated (libfdk-aac absent "
             "on this image — same as a reference build without "
             "AudioToolbox); windowed GL displays are n/a (headless "
             "target; analyse/callback/JPEG sinks instead). Snow "
             "(MS_SNOW_ENC/DEC_ID) is implemented via the probed avcodec "
             "layer as of round 4.", ""]
    total = dict(yes=0, partial=0)
    total["n/a"] = 0
    headers = sorted(os.listdir(REF)) if os.path.isdir(REF) else []
    body = []
    for h in headers:
        if not h.endswith(".h"):
            continue
        syms = symbols_of(os.path.join(REF, h))
        if not syms:
            continue
        module, default, note = HEADERS.get(
            h, ("—", "n/a", "uncategorized header"))
        body.append(f"## {h} — `{module}`" + (f" ({note})" if note else ""))
        body.append("")
        body.append("| symbol | status | note |")
        body.append("|---|---|---|")
        for s in syms:
            st, nt = OVERRIDES.get(s, (default, ""))
            if s not in OVERRIDES:
                for pat, pnote in N_A_PATTERNS:
                    if pat.search(s):
                        st, nt = "n/a", pnote
                        break
            total[st] = total.get(st, 0) + 1
            body.append(f"| `{s}` | {st} | {nt} |")
        body.append("")
    n_all = sum(total.values())
    lines.append(f"**Totals: {n_all} symbols — {total['yes']} yes, "
                 f"{total['partial']} partial, {total['n/a']} n/a.**")
    lines.append("")
    lines += body
    with open(OUT, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {OUT}: {n_all} symbols "
          f"({total['yes']} yes / {total['partial']} partial / "
          f"{total['n/a']} n/a)")


if __name__ == "__main__":
    main()
