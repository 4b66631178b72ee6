"""Host<->device boundary filters.

``ext_source`` / ``ext_sink`` are the batched replacement for the
reference's soundcard/RTP edge filters' *data motion* role: where the
reference's MSRtpRecv drains a jitter buffer inside the tick
(src/otherfilters/msrtp.c:1050-1091) and MSAlsaRead blocks on ALSA, here the
host assembles fixed-shape tick tensors (from the jitter buffer, sound
backend, or test vectors) and feeds them to the compiled graph; sinks come
back as device outputs.  The engine special-cases these two names in
CompiledGraph.step.
"""
from __future__ import annotations

from mediastreamer2_tpu.core.block import Format, block_dtype  # noqa: F401 (re-export)
from mediastreamer2_tpu.core.filter import FilterDef, register_filter

register_filter(FilterDef(
    name="ext_source", ninputs=0, noutputs=1,
    out_formats=lambda ctx: (ctx.params["fmt"],),
))

register_filter(FilterDef(
    name="ext_sink", ninputs=1, noutputs=0,
    out_formats=lambda ctx: (),
))
