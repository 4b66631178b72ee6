"""AudioStreamBatch — the session-level duplex audio call builder.

Reference: ``audio_stream_start_full`` (src/voip/audiostream.c:1884 →
:1267) builds one send chain soundread→…→encoder→rtpsend and one recv chain
rtprecv→decoder→…→soundwrite per call (graph shapes at :1796-1832), spawns
a ticker thread per stream, and the app pumps ``media_stream_iterate``.

Batched re-design: **one AudioStreamBatch hosts N call legs** sharing a
single compiled graph — the batch dimension replaces per-stream tickers.
Feature flags (echo cancellation, AGC, noise gate, PLC, VAD/DTX, DTMF —
cf. AUDIO_STREAM_FEATURE_* bits) select which nodes are built; per-leg
enable masks in params switch them at run time without recompiling.

Graph (builds the reference's chains in SSA form; EC far-end reference is
the recv-side speaker signal, same coupling as audiostream.c's EC wiring):

    recv:  rtp_rx -> decoder -> plc -> dtmf_gen -> vol_recv ==> spk
    send:  mic -> ec(near=mic, far=spk) -> vol_send -> vad -> enc -> rtp_tx

Host side, per tick: drain transports -> jitter buffers -> rx payload block
(+ lost mask for PLC); tx payload block -> RTP packetize/send.  DTX: VAD
silence gates packet emission (clock still advances).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import jax.numpy as jnp

from mediastreamer2_tpu.core.block import Format, tick_samples
from mediastreamer2_tpu.core.graph import GraphBuilder
from mediastreamer2_tpu.core.ticker import Ticker
from mediastreamer2_tpu.net.jitter import JitterBuffer, JBParams
from mediastreamer2_tpu.net.rtp import RtpSession, Transport

# payload-type profile (RFC 3551 static types + our dynamic ones)
PAYLOAD_TYPES = {"ulaw": 0, "alaw": 8, "l16": 11, "gsm": 3, "opus": 96,
                 "g722": 9, "g726_32": 97, "g729": 18, "aac": 98,
                 "bv16": 107, "speex": 110}
CN_PT = 13   # RFC 3389 comfort noise
CODEC_BYTES_PER_SAMPLE = {"ulaw": 1, "alaw": 1, "l16": 2, "g722": 1}
# RFC 3551 quirk: G.722 runs 16 kHz audio on an 8 kHz RTP clock (4.5.2);
# its payload and timestamps advance at half the sample rate (msg722.c:169)
RTP_CLOCK = {"g722": 8000}
# host codecs run at the RTP boundary (cf. SURVEY.md §7: library codecs are
# host filters, like the reference's hw codec backends); value = frame ms
HOST_CODECS = {"opus": 10, "gsm": 20, "g729": 20, "bv16": 10,
               "speex": 20,
               # AAC-LC over RFC 3640 (cf. aac-eld.c); its 1024-sample AU is
               # not a tick multiple, so it runs on sample-granular FIFOs
               "aac": 10}
# codec byte value that decodes to digital silence (for muted-direction
# legs): mu-law 0xFF, A-law 0xD5 (RFC 3551 silence codes)
SILENCE_CODE = {"ulaw": 0xFF, "alaw": 0xD5}


@dataclasses.dataclass
class AudioStreamFeatures:
    """cf. AUDIO_STREAM_FEATURE_* bitmask (audiostream.c)."""
    echo_canceller: bool = False
    agc: bool = False
    noise_gate: bool = False
    plc: bool = True
    vad_dtx: bool = False
    dtmf: bool = False
    volume: bool = True
    baudot: bool = False       # TTY tones: baudot_gen (send) + _det (recv)
    local_play: bool = False   # announcement mixer into the send path
                               # (cf. audiostream.c local player branch)
    # device-quirk-driven knobs (core/quirks.py -> audiostream.c:1642-1680)
    mic_eq_gains: Optional[list] = None     # [(hz, gain, width_hz), ...]
    spk_eq_gains: Optional[list] = None
    ec_delay_ms: int = 0


class AudioStreamBatch:
    """N duplex audio legs, one device program."""

    def __init__(self, factory, batch: int, codec: str = "ulaw",
                 rate: int = 8000, channels: int = 1,
                 features: Optional[AudioStreamFeatures] = None,
                 mic_signal: Optional[np.ndarray] = None,
                 record_ticks: int = 0,
                 record_mixed: bool = False,
                 jb_params: Optional[JBParams] = None,
                 conference: bool = False,
                 snd_card=None):
        """record_mixed=True records mic+received mixed (the reference's
        mixed-call recording branch, src/voip/audiostream.c:1068-1088,
        1834-1840: av_recorder fed from both directions) instead of the
        receive side only.

        conference=True builds the *server* shape: each leg's decoded
        audio feeds a deployment-wide conf_mixer whose mix-minus output is
        re-encoded back to that leg — the reference's audioconference
        endpoint splice (src/voip/audioconference.c:119-178) as a graph
        flag instead of graph surgery."""
        self.factory = factory
        self.batch = batch
        self.codec = codec
        self.rate = rate
        self.channels = channels
        if channels != 1 and codec not in ("opus", "aac"):
            raise ValueError("multichannel audio requires opus or aac")
        self.S = tick_samples(rate) * channels
        self.rtp_clock = RTP_CLOCK.get(codec, rate)
        # samples-worth of RTP clock per tick = timestamp increment and,
        # for byte codecs, payload unit count
        self.S_rtp = tick_samples(self.rtp_clock)
        self.features = features or AudioStreamFeatures()
        self.record_ticks = record_ticks
        # capture/playback device (audio_stream_start_full's card args;
        # hot-swappable via set_sound_card, audiostream.c:2046-style)
        self.snd_card = snd_card
        fmt = Format(kind="pcm", rate=rate, channels=channels)
        ft = self.features

        self.host_codec = codec in HOST_CODECS
        g = GraphBuilder(factory, batch=batch)
        # ---- recv chain (built first: its output feeds the EC far pin) ----
        if self.host_codec:
            # host codec decodes at the RTP boundary; device sees PCM
            rx = g.add("ext_source", "rtp_rx", fmt=fmt)
            last = rx
        else:
            rx = g.add("ext_source", "rtp_rx",
                       fmt=fmt.with_(kind=codec, rate=self.rtp_clock))
            dec = g.add(f"{codec}_dec", "dec")
            g.link(rx, 0, dec, 0)
            last = dec
        if ft.baudot:
            # recv chain: detector before PLC (audiostream.c:1812-1832
            # places baudot_det between local_mixer and plc)
            bd = g.add("baudot_det", "baudot_det")
            g.link(last, 0, bd, 0)
            last = bd
        if ft.plc:
            plc = g.add("generic_plc", "plc")
            g.link(last, 0, plc, 0)
            last = plc
        if ft.dtmf:
            dg = g.add("dtmf_gen", "dtmf")
            g.link(last, 0, dg, 0)
            last = dg
        if ft.volume:
            vr = g.add("volume", "vol_recv")
            g.link(last, 0, vr, 0)
            last = vr
        if ft.spk_eq_gains:
            # device-specific speaker EQ from the quirk DB
            se = g.add("equalizer", "spk_eq", gains=ft.spk_eq_gains)
            g.link(last, 0, se, 0)
            last = se
        self.conference = conference
        if conference:
            lv = g.add("audio_levels", "levels")    # RFC6464-style ranks
            mx = g.add("conf_mixer", "conf")
            g.link(last, 0, lv, 0)
            g.link(lv, 0, mx, 0)
            last = mx
        spk_tee = g.add("tee", "spk_tee")
        g.link(last, 0, spk_tee, 0)
        g.link(spk_tee, 0, g.add("ext_sink", "spk"), 0)
        self.record_mixed = record_mixed and not conference
        rec_mix = None
        if record_ticks and self.record_mixed:
            # both call directions into one recording (audiostream.c:1068)
            rec_mix = g.add("mix2", "rec_mix")
            g.link(spk_tee, 1, rec_mix, 0)
            g.link(rec_mix, 0, g.add("file_recorder", "rec",
                                     max_ticks=record_ticks), 0)
        elif record_ticks:
            g.link(spk_tee, 1, g.add("file_recorder", "rec",
                                     max_ticks=record_ticks), 0)

        # ---- send chain ----------------------------------------------------
        if conference:
            # server: re-encode each member's mix-minus output; no mic/EC
            if self.host_codec:
                g.link(spk_tee, 3, g.add("ext_sink", "rtp_tx"), 0)
            else:
                enc = g.add(f"{codec}_enc", "enc")
                g.link(spk_tee, 3, enc, 0)
                g.link(enc, 0, g.add("ext_sink", "rtp_tx"), 0)
            self._finish_init(factory, batch, jb_params, g)
            return
        if mic_signal is not None:
            mic = g.add("file_player", "mic", fmt=fmt, signal=mic_signal)
        else:
            mic = g.add("ext_source", "mic", fmt=fmt)
        last = mic
        if ft.mic_eq_gains:
            # device-specific microphone EQ (audiostream.c:1642-1680)
            me = g.add("equalizer", "mic_eq", gains=ft.mic_eq_gains)
            g.link(last, 0, me, 0)
            last = me
        if ft.echo_canceller:
            ec = g.add("echo_canceller", "ec")
            g.link(last, 0, ec, 0)
            if ft.ec_delay_ms:
                # align the far reference with the echo path (the quirk
                # DB's delay hint, audiostream.c:1642-1680 -> EC delay)
                dl = g.add("delay_line", "ec_delay",
                           max_delay_ms=max(200, ft.ec_delay_ms))
                g.link(spk_tee, 2, dl, 0)
                g.link(dl, 0, ec, 1)
            else:
                g.link(spk_tee, 2, ec, 1)      # far-end reference = speaker
            last = ec
        if ft.volume or ft.agc or ft.noise_gate:
            vs = g.add("volume", "vol_send")
            g.link(last, 0, vs, 0)
            last = vs
        if ft.vad_dtx:
            vad = g.add("vad_dtx", "vad")
            g.link(last, 0, vad, 0)
            last = vad
        if ft.baudot:
            # send chain: tone generator after vad (audiostream.c:1796-1810
            # [dtmfgen_rtp]->[baudot_gen] position)
            bgen = g.add("baudot_gen", "baudot_gen")
            g.link(last, 0, bgen, 0)
            last = bgen
        if ft.local_play:
            # announcement player mixed into the outgoing audio
            player = g.add("file_player", "announce", fmt=fmt,
                           signal=np.zeros(self.S, np.float32))
            mx = g.add("mix2", "announce_mix")
            g.link(last, 0, mx, 0)
            g.link(player, 0, mx, 1)
            last = mx
        if rec_mix is not None:
            send_tee = g.add("tee", "send_tee")
            g.link(last, 0, send_tee, 0)
            g.link(send_tee, 1, rec_mix, 1)
            last = send_tee
        if self.host_codec:
            g.link(last, 0, g.add("ext_sink", "rtp_tx"), 0)   # PCM out
        else:
            enc = g.add(f"{codec}_enc", "enc")
            g.link(last, 0, enc, 0)
            g.link(enc, 0, g.add("ext_sink", "rtp_tx"), 0)
        self._finish_init(factory, batch, jb_params, g)

    def _finish_init(self, factory, batch, jb_params, g):
        ft = self.features
        codec, rate = self.codec, self.rate
        self.graph = g.build()
        self.ticker = Ticker(self.graph, name=f"audio[{batch}]", realtime=True)
        self.ticker.set_io(pull=self._pull, push=self._push)
        if ft.baudot:
            self._init_baudot()
        if "vol_send" in self.ticker.params:
            if ft.agc:
                self.ticker.params["vol_send"]["agc_enabled"] = jnp.ones((batch,), bool)
            if ft.noise_gate:
                self.ticker.params["vol_send"]["ng_enabled"] = jnp.ones((batch,), bool)

        # host-side per-leg sessions (bound later via set_transport)
        self.sessions: List[Optional[RtpSession]] = [None] * batch
        self.jb_params = jb_params or JBParams()
        self._dtx_silent = np.zeros(batch, bool)
        self._was_voice = np.ones(batch, bool)
        self._rtp_muted = np.zeros(batch, bool)   # audio_stream_mute_rtp
        self._rx_muted = np.zeros(batch, bool)    # recv leg of set_direction
        self._direction = ["sendrecv"] * batch
        self._srtp_info: Dict[int, tuple] = {}    # leg -> (suite, source)
        self.bitrate_caps: Dict[int, int] = {}    # leg -> TMMBR/REMB cap bps
        self.on_tmmbr = None                      # cb(leg, bps)
        # runtime ptime for byte codecs (MS_AUDIO_ENCODER_SET_PTIME; the
        # QoS AudioBitrateDriver climbs the ptime ladder under loss)
        self._ptime_ticks = [1] * batch
        self._max_ptime_ms = [100] * batch    # fmtp maxptime (default 100)
        self._tx_tick_accum: List[list] = [[] for _ in range(batch)]
        self._rx_tick_fifo: List[list] = [[] for _ in range(batch)]
        self._lost_mask = np.zeros(batch, bool)
        self._host_enc = [None] * batch
        self._host_dec = [None] * batch
        self._brc: Dict[int, object] = {}
        self._qi: Dict[int, object] = {}
        if self.host_codec:
            self.frame_ticks = HOST_CODECS[codec] // 10
            # per-leg packet framing (msopus.c/gsm.c ptime aggregation:
            # frames are appended until ptime is reached)
            self._host_frame_ticks = [self.frame_ticks] * batch
            self._tx_accum: List[list] = [[] for _ in range(batch)]
            self._rx_fifo: List[list] = [[] for _ in range(batch)]
            # opus FEC lookahead: hold one packet so a loss can be
            # recovered from the NEXT packet's in-band FEC (the reference's
            # payload-picker behavior; adds one frame of latency)
            self._opus_pending: List = [None] * batch
            self._opus_primed = [False] * batch
            # last successfully decoded duration (per-channel samples):
            # FEC/PLC reconstruction must request EXACTLY the lost frame's
            # duration, which follows the peer's ptime, not ours
            self._rx_dur = [0] * batch
            from mediastreamer2_tpu.ops import host_codecs as hc
            for i in range(batch):
                if codec == "opus":
                    self._host_enc[i] = hc.OpusEncoder(rate=rate,
                                                       channels=self.channels)
                    self._host_dec[i] = hc.OpusDecoder(rate=rate,
                                                       channels=self.channels)
                elif codec == "gsm":
                    if rate != 8000:
                        raise ValueError("gsm requires 8 kHz")
                    c = hc.GsmCodec()
                    self._host_enc[i] = c
                    self._host_dec[i] = c
                elif codec == "g729":
                    if rate != 8000:
                        raise ValueError("g729 requires 8 kHz")
                    # like a reference build without ENABLE_G729 the codec
                    # is absent when libbcg729 is not on the system
                    c = hc.G729Codec(enable_vad=self.features.vad_dtx)
                    self._host_enc[i] = c
                    self._host_dec[i] = c
                elif codec == "aac":
                    from mediastreamer2_tpu.ops import aac as aac_mod
                    c = aac_mod.AacStreamCodec(rate=rate,
                                               channels=self.channels)
                    self._host_enc[i] = c
                    self._host_dec[i] = c
                elif codec == "speex":
                    if rate not in (8000, 16000, 32000):
                        raise ValueError("speex requires 8/16/32 kHz")
                    c = hc.SpeexCodec(rate=rate)
                    self._host_enc[i] = c
                    self._host_dec[i] = c
                elif codec == "bv16":
                    if rate != 8000:
                        raise ValueError("bv16 requires 8 kHz")
                    # gated absent like a reference build without ENABLE_BV16
                    c = hc.Bv16Codec()
                    self._host_enc[i] = c
                    self._host_dec[i] = c

    # ------------------------------------------------------------------
    def set_transport(self, leg: int, transport: Transport):
        jb = JitterBuffer(self.jb_params)
        self.sessions[leg] = RtpSession(
            transport, payload_type=PAYLOAD_TYPES[self.codec],
            clock_rate=self.rtp_clock, jitter_buffer=jb)
        # CN packets are accepted; their 1-byte payload routes to PLC/CN fill
        self.sessions[leg].accepted_payload_types = {
            PAYLOAD_TYPES[self.codec], CN_PT}

    # -- direction (media_stream_set_direction / one-way streams) ---------
    def set_direction(self, leg: int, direction: str):
        """'sendrecv' | 'sendonly' | 'recvonly' | 'inactive' — the
        media_stream_set_direction surface; recv-muting zeroes the leg's
        playout, send-muting stops RTP emission (clock keeps running)."""
        if direction not in ("sendrecv", "sendonly", "recvonly", "inactive"):
            raise ValueError(direction)
        self._rtp_muted[leg] = direction in ("recvonly", "inactive")
        self._rx_muted[leg] = direction in ("sendonly", "inactive")
        self._direction[leg] = direction

    def get_direction(self, leg: int) -> str:
        return self._direction[leg]

    # -- Baudot TTY (audio_stream_send_baudot_* / enable_baudot_decoding) --
    def _init_baudot(self):
        from mediastreamer2_tpu.ops.baudot import BaudotFramer
        self._baudot_framers = [BaudotFramer() for _ in range(self.batch)]
        self._baudot_mark: Dict[tuple, np.ndarray] = {}

        def on_mark(ev):
            self._baudot_mark[(ev.tick, ev.leg)] = np.asarray(ev.value)

        def on_space(ev):
            mark = self._baudot_mark.pop((ev.tick, ev.leg), None)
            if mark is not None:
                self._baudot_framers[ev.leg].push_envelopes(
                    mark, np.asarray(ev.value))

        self.ticker.event_queue.set_handler("baudot_det.mark_env", on_mark)
        self.ticker.event_queue.set_handler("baudot_det.space_env", on_space)

    def set_baudot_mode(self, leg: int, mode: str):
        """audio_stream_set_baudot_sending_mode: 'us' (45.45 baud) or
        'europe' (50 baud) — per-leg runtime param, both chain positions."""
        baud = {"us": 45.45, "europe": 50.0}[mode]

        def fn(tk, leg=leg, baud=baud):
            p = tk.params["baudot_gen"]
            p["baud"] = p["baud"].at[leg].set(baud)
        self.ticker.mutate(fn)
        if hasattr(self, "_baudot_framers"):
            from mediastreamer2_tpu.ops.baudot import BaudotFramer
            self._baudot_framers[leg] = BaudotFramer(baud=baud)

    def send_baudot_string(self, leg: int, text: str):
        """audio_stream_send_baudot_string: queue TTY FSK for this leg's
        send path (baudot_generator_filter.cpp role)."""
        if not self.features.baudot:
            raise RuntimeError("stream built without baudot feature")
        from mediastreamer2_tpu.ops.baudot import load_text

        def fn(tk, leg=leg, text=text):
            tk.state["baudot_gen"] = load_text(tk.state["baudot_gen"],
                                               {leg: text}, self.batch)
        self.ticker.mutate(fn)

    def get_baudot_text(self, leg: int) -> str:
        """Decoded TTY characters received so far on this leg."""
        return self._baudot_framers[leg].text()

    # -- per-leg control surface (audio_stream_* setters) -----------------
    def _set_vol_param(self, node: str, key: str, leg: int, value):
        if node not in self.ticker.params:
            raise RuntimeError(f"stream built without {node} (volume off)")

        def fn(tk, node=node, key=key, leg=leg, value=value):
            arr = np.asarray(tk.params[node][key]).copy()
            arr[leg] = value
            tk.params[node][key] = jnp.asarray(arr)
        self.ticker.mutate(fn)

    def enable_mic(self, leg: int, enabled: bool):
        """audio_stream_enable_mic: mute/unmute this leg's capture (the
        send-side volume filter's mute switch, msvolume.c)."""
        self._set_vol_param("vol_send", "mute", leg, not enabled)

    def set_mic_gain_db(self, leg: int, db: float):
        """audio_stream_set_mic_gain_db -> MS_VOLUME_SET_DB_GAIN."""
        self._set_vol_param("vol_send", "static_gain", leg,
                            10.0 ** (db / 20.0))

    def set_spk_gain_db(self, leg: int, db: float):
        """audio_stream_set_spk_gain_db on the receive volume."""
        self._set_vol_param("vol_recv", "static_gain", leg,
                            10.0 ** (db / 20.0))

    def mute_rtp(self, leg: int, muted: bool = True):
        """audio_stream_mute_rtp: stop emitting RTP for the leg (clock
        keeps running — same DTX-style skip as the reference's mute)."""
        self._rtp_muted[leg] = muted

    def _mic_block(self, tick: int, B: int, S: int) -> np.ndarray:
        """Capture block: the sound card's samples when a card is set
        (ms_snd_card_create_reader role), silence otherwise."""
        if self.snd_card is not None:
            blk = self.snd_card.pull(tick, B)
            if blk.shape[1] != S:                 # rate-mismatched card
                out = np.zeros((B, S), np.float32)
                n = min(S, blk.shape[1])
                out[:, :n] = blk[:, :n]
                return out
            return blk
        return np.zeros((B, S), np.float32)

    def set_sound_card(self, card) -> None:
        """Hot-swap the capture/playback device mid-call
        (audio_stream_set_sound_card role; takes effect next tick)."""
        self.snd_card = card

    def link_video(self, video_stream, leg: int = 0, video_leg: int = 0):
        """audio_stream_link_video (audiostream.c:2616): route the video
        stream's decoded frames into this call's A/V recording; save with
        save_av_recording(). Requires record_ticks on this stream."""
        self._av_frames: List[tuple] = []
        self._av_wh = None
        self._linked_video = (video_stream, video_leg)

        def on_frame(ts_ms, frame):
            f = np.asarray(frame)
            h = f.shape[0] * 2 // 3
            self._av_wh = (f.shape[1], h)
            # bound memory: keep at most ~30 min at full rate
            if len(self._av_frames) < 180_000:
                self._av_frames.append((ts_ms, f))
        video_stream.add_frame_listener(video_leg, on_frame)

    def unlink_video(self):
        """audio_stream_unlink_video."""
        if getattr(self, "_linked_video", None):
            vs, vleg = self._linked_video
            vs.remove_frame_listeners(vleg)
            self._linked_video = None

    def save_av_recording(self, path: str, leg: int = 0):
        """Write the linked A/V call recording (audio recording track +
        the linked video stream's received frames) as an MKV."""
        from mediastreamer2_tpu.models.media_player import write_av_mkv
        rec = self.get_recording()
        if rec is None:
            raise RuntimeError("stream built without record_ticks")
        write_av_mkv(path, rec[leg], self.rate,
                     getattr(self, "_av_frames", []),
                     getattr(self, "_av_wh", None))

    def set_sound_card_input_gain(self, gain: float):
        """audio_stream_set_sound_card_input_gain -> the card's
        MS_AUDIO_CAPTURE_SET_VOLUME_GAIN (msinterfaces.h:255)."""
        if self.snd_card is None:
            raise RuntimeError("no sound card attached")
        self.snd_card.set_input_gain(gain)

    def set_sound_card_output_gain(self, gain: float):
        if self.snd_card is None:
            raise RuntimeError("no sound card attached")
        self.snd_card.set_output_gain(gain)

    def get_sound_card_input_gain(self) -> float:
        return self.snd_card.input_gain if self.snd_card else -1.0

    def get_sound_card_output_gain(self) -> float:
        return self.snd_card.output_gain if self.snd_card else -1.0

    def enable_double_srtp(self, leg: int, inner: tuple, outer: tuple,
                           suite: str = None, ekt_key: bytes = None,
                           ekt_spi: int = 0):
        """Inner+outer SRTP on one leg (the reference's double encryption,
        ms_srtp.cpp inner/outer contexts; tester 'Double Encrypted audio
        stream').  `inner`/`outer` are (tx_key, tx_salt, rx_key, rx_salt).
        With `ekt_key`, RFC 8870 tags carry the inner key between the
        layers for relayed conferences."""
        from mediastreamer2_tpu.net.srtp import (SrtpContext, SrtcpContext,
                                                 SrtpTransport, EktTransport,
                                                 AES_CM_128_HMAC_SHA1_80)
        sess = self.sessions[leg]
        if sess is None:
            raise RuntimeError("set_transport first")
        suite = suite or AES_CM_128_HMAC_SHA1_80
        otk, ots, ork, ors = outer
        itk, its, irk, irs = inner
        t = SrtpTransport(sess.transport,
                          tx=SrtpContext(otk, ots, suite),
                          rx=SrtpContext(ork, ors, suite),
                          tx_rtcp=SrtcpContext(otk, ots, suite),
                          rx_rtcp=SrtcpContext(ork, ors, suite))
        if ekt_key is not None:
            t = EktTransport(t, ekt_key=ekt_key, spi=ekt_spi,
                             send_master_key=itk)
        sess.transport = SrtpTransport(t,
                                       tx=SrtpContext(itk, its, suite),
                                       rx=SrtpContext(irk, irs, suite))
        self._srtp_info[leg] = (suite, "sdes-double")

    def get_srtp_info(self, leg: int):
        """(crypto suite, key source) — media_stream_get_srtp_crypto_suite
        / get_srtp_key_source parity; None when the leg is unencrypted."""
        return self._srtp_info.get(leg)

    def secured(self, leg: int) -> bool:
        """media_stream_secured parity."""
        return leg in self._srtp_info

    def reclaim_sessions(self) -> List[Optional[RtpSession]]:
        """Detach the legs' RtpSessions for reuse by a replacement stream
        (media_stream_reclaim_sessions, mediastream.h:384): SSRC, sequence
        numbering and transport survive the stream teardown."""
        out = list(self.sessions)
        self.sessions = [None] * self.batch
        return out

    def adopt_session(self, leg: int, session: RtpSession):
        """Attach a reclaimed session, re-pointed at this stream's codec —
        the receive half of the reference's codec-change-over-reclaimed-
        sessions flow (codec_change_for_audio_stream tester case)."""
        session.reconfigure(PAYLOAD_TYPES[self.codec], self.rtp_clock,
                            JitterBuffer(self.jb_params))
        session.accepted_payload_types = {PAYLOAD_TYPES[self.codec], CN_PT}
        self.sessions[leg] = session

    def set_encryption_mandatory(self, leg: int, yesno: bool = True):
        """ms_media_stream_sessions_set_encryption_mandatory parity
        (ms_srtp.cpp:1576): while this leg's transport is not SRTP, media
        and RTCP are dropped instead of sent in clear, and inbound
        plaintext is discarded."""
        sess = self.sessions[leg]
        if sess is None:
            raise RuntimeError("set_transport first")
        sess.set_encryption_mandatory(yesno)

    def get_encryption_mandatory(self, leg: int) -> bool:
        sess = self.sessions[leg]
        return sess is not None and sess.encryption_mandatory

    def enable_srtp(self, leg: int, tx_key: bytes, tx_salt: bytes,
                    rx_key: bytes, rx_salt: bytes, suite: str = None,
                    key_source: str = "sdes"):
        """cf. media_stream_enable_srtp — wraps the leg's transport.

        RTCP is protected as SRTCP with the same keys (the reference's
        media_stream_enable_srtp covers both, ms_srtp.cpp:1004-1019); a leg
        that negotiated SRTP must never emit plaintext SR/RR.
        """
        from mediastreamer2_tpu.net.srtp import (SrtpContext, SrtcpContext,
                                                 SrtpTransport,
                                                 AES_CM_128_HMAC_SHA1_80)
        sess = self.sessions[leg]
        if sess is None:
            raise RuntimeError("set_transport first")
        suite = suite or AES_CM_128_HMAC_SHA1_80
        self._srtp_info[leg] = (suite, key_source)
        if isinstance(sess.transport, SrtpTransport):
            # key change on a running stream (tester case 'Encrypted audio
            # stream with key change'): swap contexts, don't stack another
            # encryption layer
            t = sess.transport
            t.tx = SrtpContext(tx_key, tx_salt, suite)
            t.rx = SrtpContext(rx_key, rx_salt, suite)
            t.tx_rtcp = SrtcpContext(tx_key, tx_salt, suite)
            t.rx_rtcp = SrtcpContext(rx_key, rx_salt, suite)
            return
        sess.transport = SrtpTransport(
            sess.transport,
            tx=SrtpContext(tx_key, tx_salt, suite),
            rx=SrtpContext(rx_key, rx_salt, suite),
            tx_rtcp=SrtcpContext(tx_key, tx_salt, suite),
            rx_rtcp=SrtcpContext(rx_key, rx_salt, suite))

    # ------------------------------------------------------------------
    def _decode_payload(self, payload: bytes) -> np.ndarray:
        if self.codec in ("ulaw", "alaw", "g722"):
            return np.frombuffer(payload, np.uint8).astype(np.int32)
        if self.codec == "l16":
            return np.frombuffer(payload, ">i2").astype(np.int32)
        raise ValueError(self.codec)

    def _encode_payload(self, row: np.ndarray) -> bytes:
        if self.codec in ("ulaw", "alaw", "g722"):
            return row.astype(np.uint8).tobytes()
        if self.codec == "l16":
            return row.astype(">i2").tobytes()
        raise ValueError(self.codec)

    def enable_batch_edge(self, rx_sock, tx_sock, remote, ssrc_base: int = 0x5000,
                          prefill: int = 4, srtp_keys=None,
                          srtp_suite: str = "AES_CM_128_HMAC_SHA1_80"):
        """Replace the per-leg Python RTP path with the native batched edge
        (native/rtp_edge.cpp): ONE sendmmsg/GSO call sends all legs, ONE
        recvmmsg/GRO drain + C++ jitter-ring playout feeds the tick — the
        production fast path for byte codecs at thousands of legs (the
        per-leg RtpSession path remains for feature-rich legs: RTCP, DTMF,
        GCM-suite SRTP wrapping).

        srtp_keys: optional per-leg [(master_key, master_salt), ...] —
        AES-CM SRTP protect/unprotect then runs INLINE in the native edge
        (ms_srtp.cpp's modifier role at batch scale; KDF is the
        KAT-pinned RFC 3711 derivation).

        Legs transmit SSRC ssrc_base+i and expect the same SSRCs inbound
        (BUNDLE-style multiplexing on one socket pair)."""
        from mediastreamer2_tpu.native import BatchRtpTx, BatchRtpRx
        if self.host_codec:
            raise ValueError("batch edge supports byte codecs only")
        psz = self.S_rtp * CODEC_BYTES_PER_SAMPLE[self.codec]
        self._edge_tx = BatchRtpTx(tx_sock, self.batch, psz)
        self._edge_rx = BatchRtpRx(self.batch, psz, ring_depth=64)
        self._edge_rx.add_socket(rx_sock, gro=True)
        for i in range(self.batch):
            self._edge_tx.config(i, remote[0], remote[1],
                                 ssrc=ssrc_base + i,
                                 pt=PAYLOAD_TYPES[self.codec])
            self._edge_rx.map_ssrc(ssrc_base + i, i)
            self._edge_rx.set_prefill(i, prefill)
            if srtp_keys is not None:
                mk, ms = srtp_keys[i]
                self._edge_tx.set_srtp(i, mk, ms, srtp_suite)
                self._edge_rx.set_srtp(i, mk, ms, srtp_suite)
        self._edge_tx.enable_gso(remote)
        from mediastreamer2_tpu.net.jitter import BatchEdgeJitterController
        self._edge_jitter_ctrl = BatchEdgeJitterController(
            self._edge_rx, self.batch, min_prefill=prefill)
        self.batch_edge = True

    def set_ptime(self, leg: int, ptime_ms: int):
        """cf. MS_AUDIO_ENCODER_SET_PTIME (audiostream.c:1608-1618): pack
        ptime_ms worth of audio per packet — fewer packets, more latency;
        the QoS ptime ladder calls this under loss. Byte codecs only
        (host codecs have their own frame aggregation).

        Clamped to max_ptime when one was negotiated (the basic_audio
        tester's 'Max ptime' contract: maxptime=60 then SET_PTIME 80 must
        read back 60)."""
        assert ptime_ms % 10 == 0 and ptime_ms >= 10
        ptime_ms = min(ptime_ms, self._max_ptime_ms[leg])
        if self.host_codec:
            # library codecs aggregate frames until ptime (msopus.c /
            # gsm.c / g729.c frame-append loops); each has valid sizes
            allowed = {"opus": (10, 20, 40, 60),     # libopus frame sizes
                       "gsm": (20, 40, 60, 80),      # 20 ms multiples
                       "speex": (20, 40, 60, 80, 100),
                       "g729": tuple(range(10, 101, 10)),
                       "bv16": tuple(range(10, 101, 10))}
            if self.codec == "aac":
                raise ValueError("aac framing is fixed at 1024 samples")
            ok = allowed.get(self.codec, ())
            while ptime_ms not in ok and ptime_ms > 10:
                ptime_ms -= 10                   # clamp to nearest valid
            self._host_frame_ticks[leg] = ptime_ms // 10
            self._tx_accum[leg] = []             # restart packet framing
            return
        self._ptime_ticks[leg] = ptime_ms // 10

    def set_max_ptime(self, leg: int, max_ptime_ms: int):
        """fmtp maxptime= (MS_FILTER_ADD_FMTP parity); an out-of-range
        value falls back to the reference's 100 ms default
        (bv16.c:91 / msopus.c maxptime handling)."""
        if not 10 <= max_ptime_ms <= 140:
            max_ptime_ms = 100
        self._max_ptime_ms[leg] = max_ptime_ms
        if self._ptime_ticks[leg] * 10 > max_ptime_ms:
            self._ptime_ticks[leg] = max_ptime_ms // 10

    def get_ptime(self, leg: int) -> int:
        """MS_AUDIO_ENCODER_GET_PTIME."""
        if self.host_codec:
            return self._host_frame_ticks[leg] * 10
        return self._ptime_ticks[leg] * 10

    batch_edge = False

    def _pull_batch_edge(self, tick: int) -> Dict[str, np.ndarray]:
        """Whole-batch pull: one poll + one playout pop, zero per-leg
        Python. Payload matrix decodes vectorized (u8/i16 view)."""
        B = self.batch
        self._edge_rx.poll()
        pay, flags = self._edge_rx.read_tick()
        if self.codec in ("ulaw", "alaw", "g722"):
            rx = pay.astype(np.int32)
        else:                                   # l16
            rx = pay.view(">i2").astype(np.int32).reshape(B, self.S_rtp)
        lost = flags == 0
        self._lost_mask = lost
        if self.features.plc:
            self.ticker.params["plc"]["lost"] = jnp.asarray(lost)
        self._feed_echo_limiter()
        ext = {"rtp_rx": rx}
        if "mic" in self.graph.ext_inputs:
            ext["mic"] = self._mic_block(tick, B, self.S)
        return ext

    def _push_batch_edge(self, tick: int, ext_out: Dict):
        tx = np.asarray(ext_out["rtp_tx"])
        if self.codec in ("ulaw", "alaw", "g722"):
            payloads = tx.astype(np.uint8)
        else:
            payloads = np.ascontiguousarray(
                tx.astype(">i2")).view(np.uint8).reshape(self.batch, -1)
        if self.features.vad_dtx:
            mask = np.asarray(self.ticker.state["vad"]["voice"]
                              ).astype(np.uint8)
        else:
            mask = None
        if self._rtp_muted.any():
            mask = (np.ones(self.batch, np.uint8) if mask is None else mask) \
                * (~self._rtp_muted).astype(np.uint8)
        self._edge_tx.send(payloads, ts_inc=self.S_rtp, mask=mask)

    def _pull(self, tick: int) -> Dict[str, np.ndarray]:
        if self.batch_edge:
            return self._pull_batch_edge(tick)
        if self.host_codec:
            return self._pull_host_codec(tick)
        B, S = self.batch, self.S
        rx = np.zeros((B, self.S_rtp), np.int32)
        lost = np.zeros(B, bool)
        tick_len = self.S_rtp * CODEC_BYTES_PER_SAMPLE[self.codec]
        for i, sess in enumerate(self.sessions):
            if sess is None:
                lost[i] = True
                continue
            sess.poll()
            if self._rx_muted[i]:
                # sendonly/inactive direction: discard inbound media
                sess.jitter_buffer.buf.clear()
                rx[i] = SILENCE_CODE.get(self.codec, 0)
                continue
            fifo = self._rx_tick_fifo[i]
            if not fifo:
                payload = sess.jitter_buffer.get_tick()
                if payload is not None and len(payload) >= tick_len \
                        and len(payload) % tick_len == 0:
                    # one packet may hold several ticks (sender ptime > 10)
                    fifo.extend(payload[k:k + tick_len]
                                for k in range(0, len(payload), tick_len))
            if fifo:
                rx[i] = self._decode_payload(fifo.pop(0))
            else:
                lost[i] = True
        self._lost_mask = lost
        if self.features.plc:
            self.ticker.params["plc"]["lost"] = jnp.asarray(lost)
        self._feed_echo_limiter()
        ext = {"rtp_rx": rx}
        if "mic" in self.graph.ext_inputs:
            ext["mic"] = self._mic_block(tick, B, S)
        return ext

    def _feed_echo_limiter(self):
        """Duplex gain coupling: vol_send ducks when vol_recv (speaker) is
        active — the reference's echo-limiter peer link (msvolume.c peer,
        wired in audiostream.c). One-tick-delayed energy copy via params."""
        st = self.ticker.state
        pr = self.ticker.params
        if "vol_send" in pr and "vol_recv" in st:
            pr["vol_send"]["peer_energy"] = st["vol_recv"]["energy"]

    def _pull_aac(self, tick: int) -> Dict[str, np.ndarray]:
        """AAC recv: drain RFC 3640 payloads into the per-leg decoder FIFO,
        then emit one tick's worth of samples (sample-granular, since the
        1024-sample AU spans 6.4 ticks at 16 kHz)."""
        B, S = self.batch, self.S
        rx = np.zeros((B, S), np.float32)
        lost = np.zeros(B, bool)
        for i, sess in enumerate(self.sessions):
            if sess is None:
                lost[i] = True
                continue
            sess.poll()
            dec = self._host_dec[i]
            n = tick_samples(self.rate)
            got = dec.pull_rx(n)
            if got is None:
                # FIFO dry: ask the jitter buffer for the next AU (at most
                # one per tick — its playout pacing is seq-driven)
                payload = sess.jitter_buffer.get_tick()
                if payload is not None:
                    dec.push_rx_payload(payload)
                got = dec.pull_rx(n)
            if got is None:
                lost[i] = True
            else:
                rx[i] = got.reshape(-1) if self.channels > 1 else got
        self._lost_mask = lost
        if self.features.plc:
            self.ticker.params["plc"]["lost"] = jnp.asarray(lost)
        ext = {"rtp_rx": rx}
        if "mic" in self.graph.ext_inputs:
            ext["mic"] = self._mic_block(tick, B, S)
        return ext

    def _pull_host_codec(self, tick: int) -> Dict[str, np.ndarray]:
        if self.codec == "aac":
            return self._pull_aac(tick)
        B, S = self.batch, self.S
        rx = np.zeros((B, S), np.float32)
        lost = np.zeros(B, bool)
        for i, sess in enumerate(self.sessions):
            fifo = self._rx_fifo[i]
            # this leg's configured framing (sender side); receive adapts
            # to whatever duration each packet actually decodes to
            frame_samples = tick_samples(self.rate) \
                * self._host_frame_ticks[i]
            if sess is not None and not fifo:
                sess.poll()
                payload = sess.jitter_buffer.get_tick()
                if self.codec == "opus":
                    # one-packet lookahead: play P_{t-1}; if it was lost,
                    # recover it from P_t's in-band FEC, else native PLC.
                    # Decode with the max opus frame budget and trust the
                    # RETURNED length (the packet's TOC carries its real
                    # duration, so a peer may change ptime freely)
                    max_samples = self.rate * 120 // 1000
                    lost_dur = self._rx_dur[i] or frame_samples
                    prev = self._opus_pending[i]
                    self._opus_pending[i] = payload
                    if not self._opus_primed[i]:
                        self._opus_primed[i] = True
                        pcm = np.zeros(0, np.float32)
                    elif prev is not None:
                        pcm = self._host_dec[i].decode(prev, max_samples)
                        if len(pcm):
                            self._rx_dur[i] = len(pcm) // self.channels
                    elif payload is not None:
                        # recover the LOST previous frame from this
                        # packet's in-band FEC: request its exact duration
                        pcm = self._host_dec[i].decode(payload, lost_dur,
                                                       fec=True)
                    else:
                        pcm = self._host_dec[i].decode(None, lost_dur)
                elif payload is not None and len(payload) > 0:
                    pcm = self._host_dec[i].decode(payload)
                else:
                    pcm = np.zeros(frame_samples, np.float32)
                    lost[i] = True
                for k in range(len(pcm) // S):
                    fifo.append(pcm[k * S:(k + 1) * S])
            if fifo:
                rx[i] = fifo.pop(0)
            elif sess is not None:
                lost[i] = True
        self._lost_mask = lost
        if self.features.plc:
            self.ticker.params["plc"]["lost"] = jnp.asarray(lost)
        ext = {"rtp_rx": rx}
        if "mic" in self.graph.ext_inputs:
            ext["mic"] = self._mic_block(tick, B, S)
        return ext

    def _push(self, tick: int, ext_out: Dict):
        if self.snd_card is not None and "spk" in ext_out:
            # playback device consumes the recv-side output
            # (ms_snd_card_create_writer / soundwrite role)
            self.snd_card.push(tick, np.asarray(ext_out["spk"]))
        if self.batch_edge:
            return self._push_batch_edge(tick, ext_out)
        tx = np.asarray(ext_out["rtp_tx"])
        # RFC 6464: refresh the audio-level extension from the send-side
        # volume meter for legs that negotiated it (msrtp.c level insert)
        if "vol_send" in self.ticker.state:
            energy = None
            for i, sess in enumerate(self.sessions):
                if sess is not None and getattr(sess, "_level_ext_id",
                                                None) is not None:
                    if energy is None:
                        energy = np.asarray(
                            self.ticker.state["vol_send"]["energy"])
                    dbov = int(np.clip(
                        -10.0 * np.log10(float(energy[i]) + 1e-12), 0, 127))
                    sess.set_audio_level(dbov, voice=energy[i] > 1e-4)
        if self.features.vad_dtx:
            voice = np.asarray(self.ticker.state["vad"]["voice"])
        else:
            voice = np.ones(self.batch, bool)
        voice = voice & ~self._rtp_muted          # audio_stream_mute_rtp
        if self.codec == "aac":
            # sample-granular: the encoder FIFO emits an RFC 3640 payload
            # whenever 1024 samples have accumulated (one AU per packet,
            # aac-eld.c:30); RTP timestamps advance by the AU size
            for i, sess in enumerate(self.sessions):
                if sess is None:
                    continue
                pcm = tx[i].reshape(-1, self.channels) \
                    if self.channels > 1 else tx[i]
                from mediastreamer2_tpu.ops.aac import AAC_FRAME_SAMPLES
                for payload in self._host_enc[i].push_tx(pcm):
                    sess.send_payload(payload,
                                      ts_increment=AAC_FRAME_SAMPLES)
            return
        if self.host_codec:
            for i, sess in enumerate(self.sessions):
                if sess is None:
                    continue
                ft = self._host_frame_ticks[i]
                frame_samples = self.S * ft
                self._tx_accum[i].append(tx[i])
                if len(self._tx_accum[i]) < ft:
                    continue
                pcm = np.concatenate(self._tx_accum[i])
                self._tx_accum[i] = []
                if voice[i]:
                    sess.send_payload(self._host_enc[i].encode(pcm),
                                      ts_increment=frame_samples)
                else:
                    sess.skip_payload(ts_increment=frame_samples)
            return
        for i, sess in enumerate(self.sessions):
            if sess is None:
                continue
            if sess.dtmf_active():
                # RFC 4733: telephone-event packets replace the audio for
                # the digit's duration (msrtp.c DTMF insertion mutes audio);
                # the RTP clock keeps running underneath
                sess.dtmf_tick(self.S_rtp)
                sess.skip_payload(ts_increment=self.S_rtp)
                continue
            if voice[i] and self._ptime_ticks[i] > 1:
                acc = self._tx_tick_accum[i]
                acc.append(self._encode_payload(tx[i]))
                if len(acc) >= self._ptime_ticks[i]:
                    sess.send_payload(b"".join(acc),
                                      ts_increment=self.S_rtp * len(acc))
                    acc.clear()
                continue
            if voice[i]:
                sess.send_payload(self._encode_payload(tx[i]),
                                  ts_increment=self.S_rtp)
            else:
                if self._was_voice[i] and self.features.vad_dtx:
                    # RFC 3389 CN packet at silence onset (cf. vaddtx CN event)
                    level = np.asarray(self.ticker.state["vad"]["floor"])[i]
                    db = int(np.clip(-10 * np.log10(level + 1e-12), 0, 127))
                    old_pt = sess.payload_type
                    sess.payload_type = CN_PT
                    sess.send_payload(bytes([db]), ts_increment=self.S_rtp)
                    sess.payload_type = old_pt
                else:
                    sess.skip_payload(ts_increment=self.S_rtp)  # DTX
        self._was_voice = voice.copy()

    # ------------------------------------------------------------------
    def start(self, n_ticks: int = 10 ** 9):
        self.ticker.warm_up()
        self.ticker.start(n_ticks)

    def run(self, n_ticks: int):
        self.ticker.warm_up()
        self.ticker.run(n_ticks)

    def stop(self):
        # RTCP BYE per leg on teardown (rtp_session uninit behavior)
        for sess in self.sessions:
            if sess is not None and sess.rtcp is not None:
                try:
                    sess.rtcp.send_bye(sess.transport)
                except Exception:
                    pass
        self.ticker.stop()

    # -- RFC 4733 DTMF over RTP (parity: msrtp.h:46-113) -----------------
    def send_dtmf(self, leg: int, digit: str, duration_ms: int = 100,
                  volume: int = 10):
        """Queue a DTMF digit as telephone-event packets on the leg
        (cf. audio_stream_send_dtmf / MS_RTP_SEND_SEND_DTMF)."""
        sess = self.sessions[leg]
        if sess is None:
            raise RuntimeError("set_transport first")
        sess.send_dtmf(digit, duration_ms=duration_ms, volume=volume)

    def enable_dtmf_receive(self, leg: int, play_tone: bool = False,
                            tone_ms: int = 100):
        """Deliver inbound telephone-events to `dtmf_received` (and, with
        play_tone, regenerate the dual tone into the leg's speaker path via
        the device dtmf_gen — requires features.dtmf)."""
        sess = self.sessions[leg]
        if sess is None:
            raise RuntimeError("set_transport first")
        if not hasattr(self, "dtmf_received"):
            self.dtmf_received: List = []

        def on_dtmf(digit, volume, _leg=leg):
            self.dtmf_received.append((_leg, digit))
            if play_tone and self.features.dtmf:
                from mediastreamer2_tpu.ops.tones import dtmf_freqs
                f1, f2 = dtmf_freqs(digit)
                samples = tone_ms * self.rate // 1000

                def trigger(tk):
                    p = tk.params["dtmf"]
                    p["f1"] = p["f1"].at[_leg].set(f1)
                    p["f2"] = p["f2"].at[_leg].set(f2)
                    p["remaining"] = p["remaining"].at[_leg].set(samples)
                self.ticker.mutate(trigger)
        sess.on_dtmf = on_dtmf

    def play_announcement(self, signal: np.ndarray,
                          legs: Optional[List[int]] = None):
        """Inject an announcement into the send path of the given legs
        (cf. audio_stream local player: play a file into the call).
        Applied at the next tick boundary."""
        if "announce" not in self.ticker.state:
            raise RuntimeError("stream built without local_play feature")
        legs = list(range(self.batch)) if legs is None else legs
        sig = np.asarray(signal, np.float32)

        def do_load(tk):
            st = dict(tk.state["announce"])
            data = np.asarray(st["data"])
            if data.shape[1] < len(sig):
                data = np.zeros((self.batch, len(sig)), np.float32)
            length = np.asarray(st["length"]).copy()
            pos = np.asarray(st["pos"]).copy()
            data = data.copy()
            for leg in legs:
                data[leg, : len(sig)] = sig
                length[leg] = len(sig)
                pos[leg] = 0
            tk.state = {**tk.state, "announce": {
                "data": jnp.asarray(data), "length": jnp.asarray(length),
                "pos": jnp.asarray(pos)}}
        self.ticker.mutate(do_load)

    def enable_rtcp(self, interval_s: float = 5.0):
        """rtcp-mux SR/RR on every leg (cf. oRTP RTCP scheduler)."""
        for sess in self.sessions:
            if sess is not None and sess.rtcp is None:
                sess.attach_rtcp(interval_s)

    def attach_bitrate_controller(self, leg: int, controller):
        """cf. audio_stream_enable_adaptive_bitrate_control."""
        self._brc[leg] = controller

    def attach_quality_indicator(self, leg: int, qi):
        self._qi[leg] = qi

    def attach_bandwidth_controller(self, leg: int, bc):
        """ms_bandwidth_controller_add_stream parity: this leg's
        packet-cluster bandwidth estimator feeds the controller each
        iterate(); the controller emits TMMBR at 0.7x/0.9x of the
        measured available bandwidth (bandwidthcontroller.c:30-160)."""
        if not hasattr(self, "_bwc"):
            self._bwc: Dict[int, object] = {}
        self._bwc[leg] = bc
        sess = self.sessions[leg]
        if sess is not None and sess.abe is None:
            sess.enable_audio_bandwidth_estimator()

    def iterate(self):
        """cf. media_stream_iterate (src/voip/mediastream.c:542) —
        app-thread pump: events, RTCP emission, QoS reaction."""
        from mediastreamer2_tpu.models.qos import QosStats
        n = self.ticker.event_queue.pump()
        if getattr(self, "_edge_jitter_ctrl", None) is not None:
            # adaptive playout depth for batch-edge legs (oRTP's jitter
            # adaptation; applied as rx.set_prefill value-reconfig)
            self._edge_jitter_ctrl.control()
        for leg, bc in getattr(self, "_bwc", {}).items():
            sess = self.sessions[leg]
            if sess is None:
                continue
            if sess.abe is not None and sess.abe.measurements:
                bc.update_estimate(sess.abe.available_bw_bps(), kind="audio")
            if sess.vbe is not None and sess.vbe.measurements:
                bc.update_estimate(sess.vbe.available_bw_bps(), kind="video")
        for leg, sess in enumerate(self.sessions):
            if sess is None or sess.rtcp is None:
                continue
            sess.rtcp.maybe_emit(sess.transport)
            if sess.rtcp.remote_reports:
                rb = sess.rtcp.remote_reports[-1]
                stats = QosStats(loss_rate=rb.fraction_lost / 256.0,
                                 rtt_ms=sess.rtcp.last_rtt_ms or 0.0)
                ctl = self._brc.get(leg)
                if ctl is not None:
                    ctl.update(stats)
                qi = self._qi.get(leg)
                if qi is not None:
                    qi.update(stats)
                # opus: feed observed loss back into the encoder's FEC
                # strength (MSOpusEnc adjusts expected loss from RTCP)
                enc = self._host_enc[leg] if leg < len(self._host_enc) else None
                if enc is not None and hasattr(enc, "set_packet_loss"):
                    enc.set_packet_loss(
                        min(30, int(stats.loss_rate * 100)))
                sess.rtcp.remote_reports.clear()
            # inbound TMMBR/REMB caps the sender's bitrate
            # (media_stream_process_rtcp TMMBR handling,
            # mediastream.c:983-1078)
            for fb in sess.rtcp.feedback_in:
                if fb.kind in ("tmmbr", "remb"):
                    self._apply_bitrate_cap(leg, fb.value)
            sess.rtcp.feedback_in.clear()
        return n

    def _apply_bitrate_cap(self, leg: int, bps: int):
        self.bitrate_caps[leg] = bps
        enc = self._host_enc[leg] if leg < len(self._host_enc) else None
        if enc is not None and hasattr(enc, "set_bitrate"):
            enc.set_bitrate(max(int(bps), 8000))
        if self.on_tmmbr is not None:
            self.on_tmmbr(leg, bps)

    # -- observability (cf. media_stream_get_*, audio_stream_get_quality) --
    def get_stats(self, leg: int):
        sess = self.sessions[leg]
        return None if sess is None else sess.stats

    def print_summary(self) -> str:
        """cf. media_stream_print_summary (src/voip/mediastream.c:1080)."""
        lines = [f"=== AudioStreamBatch[{self.batch}] codec={self.codec}"
                 f"@{self.rate} ==="]
        t = self.ticker.stats
        lines.append(f"ticker: {t.ticks} ticks, load {t.avg_load:.3f}, "
                     f"late {t.late_ticks}, mean {t.mean_step_ms:.2f} ms")
        for i, sess in enumerate(self.sessions):
            if sess is None:
                continue
            jb = sess.jitter_buffer
            jbs = (f" jb[lost={jb.lost} late={jb.late} "
                   f"underrun={jb.underruns}]" if jb else "")
            lines.append(f"leg {i}: tx {sess.stats.sent_packets} pkts/"
                         f"{sess.stats.sent_bytes}B, rx "
                         f"{sess.stats.recv_packets} pkts{jbs}")
        return "\n".join(lines)

    def alive(self, leg: int, timeout_s: float = 5.0) -> bool:
        """cf. media_stream_alive watchdog (mediastream.c:575)."""
        sess = self.sessions[leg]
        return sess is not None and sess.alive(timeout_s)

    def get_recording(self) -> Optional[np.ndarray]:
        if "rec" not in self.ticker.state:
            return None
        from mediastreamer2_tpu.ops.fileio import recorder_get_audio
        return recorder_get_audio(self.ticker.state["rec"],
                                  self.record_ticks, self.S)
