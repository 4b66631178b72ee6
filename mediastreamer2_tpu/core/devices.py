"""Sound card & webcam managers — device abstraction registries.

Reference: MSSndCard/MSSndCardManager (src/base/mssndcard.c, 697 LoC:
capability flags, reader/writer filter creation, per-platform detection
descriptors) and MSWebCam/MSWebCamManager (mswebcam.c: per-platform
MSWebCamDesc with detect + create-reader).

Batched: a "card" is a host I/O adapter that fills/drains tick tensors
for its legs (the ext_source/ext_sink boundary).  Detection descriptors
register per-platform backends; this round ships the backends that make
sense in a server/headless deployment: null (silence), file-backed, and
callback-driven cards, plus the static-image and mire webcams (parity with
the reference's nowebcam fallback).  ALSA/Pulse-style backends slot in as
additional descriptors with the same adapter interface.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from mediastreamer2_tpu.core.block import Format, tick_samples

# capability flags (cf. MS_SND_CARD_CAP_*)
CAP_CAPTURE = 1
CAP_PLAYBACK = 2
CAP_BUILTIN_EC = 4


class SndCard:
    """cf. MSSndCard: named device with capabilities and tick adapters."""

    def __init__(self, name: str, driver: str, capabilities: int,
                 rate: int = 48000, channels: int = 1):
        self.name = name
        self.driver = driver
        self.capabilities = capabilities
        self.rate = rate
        self.channels = channels
        # MS_AUDIO_CAPTURE/PLAYBACK_SET_VOLUME_GAIN (msinterfaces.h:255,
        # audio_stream_set_sound_card_input/output_gain): linear factors
        # applied at the device boundary
        self.input_gain = 1.0
        self.output_gain = 1.0

    def __repr__(self):
        return f"<SndCard {self.driver}:{self.name}>"

    def set_input_gain(self, gain: float):
        self.input_gain = float(gain)

    def set_output_gain(self, gain: float):
        self.output_gain = float(gain)

    # tick adapters — the batched replacement for create_reader/create_writer:
    # pull(tick, batch) -> [batch, S] capture block;
    # push(tick, block) consumes playback. Subclasses implement _pull_raw/
    # _push_raw; gains are applied here, uniformly.
    def pull(self, tick: int, batch: int) -> np.ndarray:
        raw = np.asarray(self._pull_raw(tick, batch), np.float32)
        return raw if self.input_gain == 1.0 else raw * self.input_gain

    def push(self, tick: int, block: np.ndarray):
        if self.output_gain != 1.0:
            block = np.asarray(block, np.float32) * self.output_gain
        self._push_raw(tick, block)

    def _pull_raw(self, tick: int, batch: int) -> np.ndarray:
        S = tick_samples(self.rate) * self.channels
        return np.zeros((batch, S), np.float32)

    def _push_raw(self, tick: int, block: np.ndarray):
        pass


class FileSndCard(SndCard):
    """Capture from a signal array, collect playback (test/server use)."""

    def __init__(self, name="file", signal: Optional[np.ndarray] = None,
                 rate: int = 8000):
        super().__init__(name, "file", CAP_CAPTURE | CAP_PLAYBACK, rate)
        self.signal = signal
        self.played: List[np.ndarray] = []

    def _pull_raw(self, tick, batch):
        S = tick_samples(self.rate)
        if self.signal is None:
            return np.zeros((batch, S), np.float32)
        seg = self.signal[tick * S:(tick + 1) * S]
        if len(seg) < S:
            seg = np.pad(seg, (0, S - len(seg)))
        return np.broadcast_to(seg, (batch, S)).astype(np.float32)

    def _push_raw(self, tick, block):
        self.played.append(np.asarray(block))


class CallbackSndCard(SndCard):
    def __init__(self, name, pull_cb=None, push_cb=None, rate=48000,
                 builtin_ec=False):
        caps = (CAP_CAPTURE if pull_cb else 0) | (CAP_PLAYBACK if push_cb else 0)
        super().__init__(name, "callback", caps | (CAP_BUILTIN_EC if builtin_ec else 0),
                         rate)
        self._pull, self._push = pull_cb, push_cb

    def _pull_raw(self, tick, batch):
        return self._pull(tick, batch) if self._pull \
            else super()._pull_raw(tick, batch)

    def _push_raw(self, tick, block):
        if self._push:
            self._push(tick, block)


class SndCardManager:
    """cf. MSSndCardManager: detection + lookup, default card selection."""

    def __init__(self):
        self.cards: List[SndCard] = []
        self._detectors: List[Callable[["SndCardManager"], None]] = []
        self.register_detector(_detect_null_cards)
        # platform backends register like the reference's MSSndCardDesc
        # detect functions (alsa.c): present only when the lib loads
        from mediastreamer2_tpu.core.alsa import detect_alsa_cards
        from mediastreamer2_tpu.core.pulse import detect_pulse_cards
        self.register_detector(detect_alsa_cards)
        self.register_detector(detect_pulse_cards)
        self.reload()

    def register_detector(self, fn):
        self._detectors.append(fn)

    def reload(self):
        self.cards.clear()
        for d in self._detectors:
            d(self)

    def add_card(self, card: SndCard):
        self.cards.append(card)

    def get_card(self, name: str) -> Optional[SndCard]:
        for c in self.cards:
            if c.name == name:
                return c
        return None

    def get_default(self, cap: int = CAP_PLAYBACK) -> Optional[SndCard]:
        for c in self.cards:
            if c.capabilities & cap:
                return c
        return None


def _detect_null_cards(mgr: SndCardManager):
    mgr.add_card(SndCard("null", "null", CAP_CAPTURE | CAP_PLAYBACK))


# ---------------------------------------------------------------- webcams
class WebCam:
    """cf. MSWebCam: named camera producing YUV tick frames."""

    def __init__(self, name: str, driver: str, fmt: Format):
        self.name = name
        self.driver = driver
        self.fmt = fmt

    def graph_source(self):
        """(filter_name, static_params) to instantiate in a graph."""
        raise NotImplementedError


class MireWebCam(WebCam):
    """Synthetic pattern camera (reference: mire.c, 'Mire: Mire (synthetic
    moving picture)')."""

    def __init__(self, fmt: Format):
        super().__init__("mire", "mire", fmt)

    def graph_source(self):
        return "mire", {"fmt": self.fmt}


class StaticImageWebCam(WebCam):
    """Static picture camera (reference: nowebcam.c fallback)."""

    def __init__(self, fmt: Format, image: Optional[np.ndarray] = None,
                 path: Optional[str] = None):
        super().__init__("static_image", "static", fmt)
        if image is None and path:
            from PIL import Image
            img = Image.open(path).convert("RGB").resize((fmt.width, fmt.height))
            image = np.asarray(img, np.float32) / 255.0
        self.image = image

    def graph_source(self):
        from mediastreamer2_tpu.ops.video import rgb_to_yuv420
        import jax.numpy as jnp
        if self.image is None:
            frame = np.zeros((self.fmt.height * 3 // 2, self.fmt.width), np.float32)
        else:
            frame = np.asarray(rgb_to_yuv420(self.image[None]))[0]
        T = self.fmt.height * 3 // 2 * self.fmt.width
        # reuse file_player with the flattened frame repeated per tick
        raise NotImplementedError("use get_frame() with an ext_source feed")

    def get_frame(self, batch: int) -> np.ndarray:
        from mediastreamer2_tpu.ops.video import rgb_to_yuv420
        if self.image is None:
            f = np.zeros((self.fmt.height * 3 // 2, self.fmt.width), np.float32)
        else:
            f = np.asarray(rgb_to_yuv420(self.image[None].astype(np.float32)))[0]
        return np.broadcast_to(f, (batch,) + f.shape)


class WebCamManager:
    """cf. MSWebCamManager."""

    def __init__(self, default_fmt: Format = Format(kind="yuv420", width=320,
                                                    height=240, fps=30.0)):
        self.cams: List[WebCam] = [MireWebCam(default_fmt),
                                   StaticImageWebCam(default_fmt)]

    def get_cam(self, name: str) -> Optional[WebCam]:
        for c in self.cams:
            if c.name == name:
                return c
        return None

    def add_cam(self, cam: WebCam):
        self.cams.insert(0, cam)

    def get_default(self) -> WebCam:
        return self.cams[0]
