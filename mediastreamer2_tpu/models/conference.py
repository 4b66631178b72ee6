"""Audio conferencing — mixer mode (MSAudioConference parity).

Reference: src/voip/audioconference.c — one conference ticker + MSAudioMixer;
member AudioStreams' graphs are surgically cut and spliced into mixer pins
(:119-178 cut_audio_stream_graph), per-endpoint resamplers, active-talker
detection at -30 dB (:31), 50-member mixer cap (audiomixer.c:29).

Batched: the deployment-wide `conf_mixer` already mixes every conference
in the batch at once (ops/mixer.py); this class is the *control plane*:
allocate legs to conferences, keep group/active params in sync, surface
active-talker events (RMS over the device-computed levels), and expose the
reference's add/remove/mute API.  Graph surgery becomes a params update —
O(1), no recompile, no cap at 50.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import jax.numpy as jnp

ACTIVE_TALKER_DB = -30.0    # parity: audioconference.c:31


class AudioConferenceControl:
    """Manages conference membership over a conf_mixer node's params.

    Works against any Ticker whose graph contains a 'conf_mixer' node (the
    flagship graph, AudioStreamBatch variants, or a custom graph).
    """

    def __init__(self, ticker, mixer_node: str = "conf",
                 levels_node: Optional[str] = "levels"):
        self.ticker = ticker
        self.node = mixer_node
        self.levels_node = levels_node
        self.batch = ticker.graph.batch
        self.membership: List[Optional[int]] = [None] * self.batch
        self._free_group = 0
        self._sync()

    # -- reference API surface ------------------------------------------
    def new_conference(self) -> int:
        gid = self._free_group
        self._free_group += 1
        return gid

    def add_member(self, leg: int, conf_id: int):
        """cf. ms_audio_conference_add_member — here a params update."""
        self.membership[leg] = conf_id
        self._sync()

    def remove_member(self, leg: int):
        self.membership[leg] = None
        self._sync()

    def mute_member(self, leg: int, muted: bool = True):
        p = self.ticker.params[self.node]
        active = np.asarray(p["active"]).copy()
        active[leg] = not muted
        p["active"] = jnp.asarray(active)

    def member_count(self, conf_id: int) -> int:
        return sum(1 for m in self.membership if m == conf_id)

    def _sync(self):
        p = self.ticker.params[self.node]
        group = np.zeros(self.batch, np.int32)
        active = np.zeros(self.batch, bool)
        for leg, conf in enumerate(self.membership):
            if conf is None:
                group[leg] = self.batch - 1 - leg % 1  # parked: own group
                active[leg] = False
            else:
                group[leg] = conf
                active[leg] = True
        # parked legs: give unique groups beyond used conference ids
        parked_gid = max([m for m in self.membership if m is not None],
                         default=-1) + 1
        for leg, conf in enumerate(self.membership):
            if conf is None:
                group[leg] = parked_gid
                parked_gid = min(parked_gid + 1, self.batch - 1)
        p["group_id"] = jnp.asarray(group)
        p["active"] = jnp.asarray(active)

    # -- active talker detection (cf. conference talker events) ----------
    def active_talkers(self, threshold_db: float = ACTIVE_TALKER_DB
                       ) -> Dict[int, List[int]]:
        """Returns conf_id -> legs currently above threshold, using the
        audio_levels (or volume) node's device-computed energy."""
        if self.levels_node and self.levels_node in self.ticker.state:
            e = np.asarray(self.ticker.state[self.levels_node]["energy"])
        elif "vol_send" in self.ticker.state:
            e = np.asarray(self.ticker.state["vol_send"]["energy"])
        else:
            return {}
        db = 10 * np.log10(e + 1e-12)
        out: Dict[int, List[int]] = {}
        for leg, conf in enumerate(self.membership):
            if conf is not None and db[leg] > threshold_db:
                out.setdefault(conf, []).append(leg)
        return out

    def participant_volume(self, leg: int) -> int:
        """ms_audio_conference_get_participant_volume parity: the member's
        current level in dBov (0 loudest .. -127 silence)."""
        if self.levels_node and self.levels_node in self.ticker.state:
            e = np.asarray(self.ticker.state[self.levels_node]["energy"])
        elif "vol_send" in self.ticker.state:
            e = np.asarray(self.ticker.state["vol_send"]["energy"])
        else:
            return -127
        db = 10 * np.log10(float(e[leg]) + 1e-12)
        return int(np.clip(db, -127, 0))

    def csrc_levels_for(self, leg: int, ssrc_map: Optional[Dict[int, int]]
                        = None, top_n: int = 15) -> List:
        """RFC 6465 feed for a mixed output leg: the other members of
        `leg`'s conference ranked loudest-first as (ssrc, dBov) pairs,
        ready for RtpSession.set_csrc_audio_levels (the reference's
        mixer-to-client path: AudioStreamVolumes filled by the mixer leg).
        ssrc_map maps leg index -> RTP ssrc (defaults to the leg index)."""
        conf = self.membership[leg]
        if conf is None:
            return []
        if self.levels_node and self.levels_node in self.ticker.state:
            e = np.asarray(self.ticker.state[self.levels_node]["energy"])
        elif "vol_send" in self.ticker.state:
            e = np.asarray(self.ticker.state["vol_send"]["energy"])
        else:
            return []
        members = [(m, float(e[m])) for m, c in enumerate(self.membership)
                   if c == conf and m != leg]
        members.sort(key=lambda t: -t[1])
        out = []
        for m, energy in members[:top_n]:
            dbov = int(min(127, max(0, -10 * np.log10(energy + 1e-13))))
            out.append(((ssrc_map or {}).get(m, m), dbov))
        return out
