"""Baudot TTY (text telephone) — FSK tone generation and detection.

Reference: src/baudot/ (1,824 LoC — baudot_generator_filter.cpp,
baudot_detector_filter.cpp): 45.45/50 baud FSK carrying ITA2 5-bit codes
(mark 1400 Hz / space 1800 Hz, 1 start + 5 data + 1.5 stop bits), used for
accessibility (TTY/TDD) over the audio path.

Device/host split:
* generation: fully on device — a per-leg bit schedule (uploaded on
  ``type_text``) drives a batched variable-frequency phase accumulator;
* detection: the device computes mark/space correlation envelopes per
  half-bit window (batched matmuls); the branchy start-bit/UART framing
  state machine consumes those envelopes **on the host**
  (``BaudotFramer``), mirroring the §7 device/host split rule.

ITA2 table: US-TTY variant; LTRS/FIGS shifting handled by the host codec.
"""
from __future__ import annotations

from typing import List

import numpy as np
import jax
import jax.numpy as jnp

from mediastreamer2_tpu.core.filter import FilterDef, register_filter

MARK_HZ = 1400.0
SPACE_HZ = 1800.0
DEFAULT_BAUD = 45.45

_LTRS = "\x00E\nA SIU\rDRJNFCKTZLWHYPQOBG\x0fMXV\x0e"
_FIGS = "\x003\n- \x0787\r$4',!:(5\")2#6019?&\x0f./;\x0e"
LTRS_SHIFT, FIGS_SHIFT = 0x1F, 0x1B


def char_to_code(ch: str, figs: bool):
    """Returns (code, needs_figs) or None."""
    ch = ch.upper()
    for table, is_figs in ((_LTRS, False), (_FIGS, True)):
        idx = table.find(ch)
        if idx >= 0 and idx not in (LTRS_SHIFT, FIGS_SHIFT):
            return idx, is_figs
    return None


def text_to_bits(text: str, stop_bits: float = 2.0) -> List[int]:
    """UART-style bit schedule: idle=mark(1), start=0, 5 data LSB-first,
    stop=mark."""
    bits: List[int] = [1] * 8          # leading idle marks
    figs = False

    def emit(code: int):
        bits.append(0)                                  # start
        bits.extend((code >> i) & 1 for i in range(5))  # LSB first
        bits.extend([1] * int(round(stop_bits)))        # stop

    emit(LTRS_SHIFT)                   # initial shift, like real TTYs
    for ch in text:
        m = char_to_code(ch, figs)
        if m is None:
            continue
        code, needs_figs = m
        if needs_figs != figs:
            emit(FIGS_SHIFT if needs_figs else LTRS_SHIFT)
            figs = needs_figs
        emit(code)
    bits.extend([1] * 8)
    return bits


def bits_to_text(decoded_codes: List[int]) -> str:
    out = []
    figs = False
    for code in decoded_codes:
        if code == LTRS_SHIFT:
            figs = False
        elif code == FIGS_SHIFT:
            figs = True
        else:
            ch = (_FIGS if figs else _LTRS)[code]
            if ch >= " " or ch in "\r\n":
                out.append(ch)
    return "".join(out)


MAX_BITS = 512


def _gen_init(ctx):
    B = ctx.batch
    return {
        "bits": jnp.ones((B, MAX_BITS), jnp.float32),   # mark idle
        "nbits": jnp.zeros((B,), jnp.int32),
        "bit_pos": jnp.zeros((B,), jnp.float32),        # fractional bit index
        "phase": jnp.zeros((B,), jnp.float32),
    }


def _gen_params(ctx):
    B = ctx.batch
    return {"amplitude": jnp.full((B,), 0.4, jnp.float32),
            "baud": jnp.full((B,), DEFAULT_BAUD, jnp.float32),
            "mute_input": jnp.ones((B,), jnp.bool_)}


def _gen_process(state, ins, params, ctx):
    x = ins[0]
    B, S = x.shape
    rate = ctx.in_formats[0].rate
    bit_per_sample = params["baud"] / rate                    # [B]
    k = jnp.arange(S, dtype=jnp.float32)[None, :]
    bit_idx_f = state["bit_pos"][:, None] + k * bit_per_sample[:, None]
    bit_idx = jnp.clip(bit_idx_f.astype(jnp.int32), 0, MAX_BITS - 1)
    sending = bit_idx_f < state["nbits"][:, None].astype(jnp.float32)
    bitval = jnp.take_along_axis(state["bits"], bit_idx, axis=1)
    freq = jnp.where(bitval > 0.5, MARK_HZ, SPACE_HZ)
    dphase = 2 * jnp.pi * freq / rate
    phase = state["phase"][:, None] + jnp.cumsum(dphase, axis=1)
    tone = jnp.sin(phase) * params["amplitude"][:, None] * sending
    base = jnp.where(params["mute_input"][:, None] & sending.any(axis=1, keepdims=True),
                     0.0, x)
    out = jnp.clip(base + tone, -1.0, 1.0)
    new_bit_pos = state["bit_pos"] + S * bit_per_sample
    done = (state["nbits"] > 0) & (new_bit_pos >= state["nbits"].astype(jnp.float32))
    new_state = {
        "bits": state["bits"],
        "nbits": jnp.where(done, 0, state["nbits"]),
        "bit_pos": jnp.where(done, 0.0, new_bit_pos),
        "phase": jnp.mod(phase[:, -1], 2 * jnp.pi),
    }
    return new_state, (out,), {"sending_done": done}


register_filter(FilterDef(
    name="baudot_gen", ninputs=1, noutputs=1,
    out_formats=lambda ctx: (ctx.in_formats[0],),
    init=_gen_init, runtime_params=_gen_params, process=_gen_process,
))


def load_text(state_entry, leg_texts: dict, batch: int):
    """Host helper: upload per-leg bit schedules into baudot_gen state."""
    bits = np.asarray(state_entry["bits"]).copy()
    nbits = np.asarray(state_entry["nbits"]).copy()
    pos = np.asarray(state_entry["bit_pos"]).copy()
    for leg, text in leg_texts.items():
        b = text_to_bits(text)[:MAX_BITS]
        bits[leg, :len(b)] = b
        bits[leg, len(b):] = 1.0
        nbits[leg] = len(b)
        pos[leg] = 0.0
    return {**state_entry, "bits": jnp.asarray(bits),
            "nbits": jnp.asarray(nbits), "bit_pos": jnp.asarray(pos)}


# ------------------------------------------------------------- detection
ENV_DECIM = 8      # envelope samples every 8 audio samples (1 ms @8k)


def _det_init(ctx):
    B = ctx.batch
    S = ctx.in_formats[0].samples_per_tick
    return {"tail": jnp.zeros((B, ENV_DECIM * 4), jnp.float32)}


def _det_process(state, ins, params, ctx):
    """Emit per-window mark/space correlation envelopes as events; the host
    BaudotFramer turns them into bits/chars."""
    x = ins[0]
    B, S = x.shape
    rate = ctx.in_formats[0].rate
    xe = jnp.concatenate([state["tail"], x], axis=1)
    W = ENV_DECIM * 4                              # 4 ms correlation window
    n_win = S // ENV_DECIM
    starts = jnp.arange(n_win) * ENV_DECIM
    idx = starts[:, None] + jnp.arange(W)[None, :]             # [n_win, W]
    wins = xe[:, idx]                                          # [B, n_win, W]
    t = jnp.arange(W, dtype=jnp.float32) / rate
    hann = 0.5 - 0.5 * jnp.cos(2 * jnp.pi * jnp.arange(W) / W)

    def band(freq):
        c = jnp.cos(2 * jnp.pi * freq * t) * hann
        s = jnp.sin(2 * jnp.pi * freq * t) * hann
        re = jnp.einsum("bnw,w->bn", wins, c, precision=jax.lax.Precision.HIGHEST)
        im = jnp.einsum("bnw,w->bn", wins, s, precision=jax.lax.Precision.HIGHEST)
        return re * re + im * im

    mark = band(MARK_HZ)
    space = band(SPACE_HZ)
    return {"tail": xe[:, -ENV_DECIM * 4:]}, (x,), {
        "mark_env": mark, "space_env": space}


register_filter(FilterDef(
    name="baudot_det", ninputs=1, noutputs=1,
    out_formats=lambda ctx: (ctx.in_formats[0],),
    init=_det_init, process=_det_process,
))


class BaudotFramer:
    """Host UART framer over device mark/space envelopes (one per leg)."""

    def __init__(self, rate: int = 8000, baud: float = DEFAULT_BAUD):
        self.samples_per_bit = rate / baud / ENV_DECIM   # envelope steps/bit
        self.env: List[int] = []        # decided mark(1)/space(0) per step
        self.codes: List[int] = []
        self._carrier = False

    def push_envelopes(self, mark: np.ndarray, space: np.ndarray,
                       threshold: float = 1e-3):
        for m, s in zip(mark, space):
            if m < threshold and s < threshold:
                self.env.append(-1)                 # no carrier
            else:
                self.env.append(1 if m >= s else 0)
        self._scan()

    def _scan(self):
        spb = self.samples_per_bit
        need = int(spb * 7) + 2
        while True:
            # find a start bit edge: carrier mark -> space
            i = 0
            found = -1
            for i in range(1, len(self.env) - need):
                if self.env[i] == 0 and self.env[i - 1] == 1:
                    found = i
                    break
            if found < 0:
                if len(self.env) > 4 * need:
                    self.env = self.env[-2 * need:]
                return
            # sample mid-bit positions for start + 5 data
            base = found
            mids = [int(base + spb * (k + 0.5)) for k in range(6)]
            if mids[-1] >= len(self.env):
                return
            samples = [self.env[m] for m in mids]
            if samples[0] != 0:                     # false start
                self.env = self.env[found + 1:]
                continue
            code = 0
            for k in range(5):
                code |= (1 if samples[1 + k] == 1 else 0) << k
            self.codes.append(code)
            self.env = self.env[int(base + spb * 6.5):]

    def text(self) -> str:
        return bits_to_text(self.codes)
