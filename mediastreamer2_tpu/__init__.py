"""mediastreamer2_tpu — a batched, accelerator-resident real-time
media-processing framework.

A ground-up re-design of the capabilities of mediastreamer2 (the Linphone
media engine) as one batched XLA program per tick, run on an NVIDIA GPU:

* The reference's MSFilter/MSTicker pull-graph (one POSIX thread per stream,
  10 ms tick, refcounted mblk_t queues — see reference src/base/msticker.c,
  src/base/msfilter.c) becomes a **declarative dataflow graph compiled to a
  single batched XLA program**: thousands of concurrent call legs are rows of
  a ``[legs, samples]`` tick block, and one device step advances every leg by
  one (or K fused) 10 ms tick(s).
* Hot DSP filters (resampler, AEC, AGC, mixer, tone gen/detect, companding)
  are vectorized jnp/lax code that XLA fuses into a handful of kernels.
* Branchy, byte-oriented work (RTP, jitter buffer, ICE, containers) stays on
  the host and exchanges fixed-shape tick buffers with the device.

Public entry points mirror the reference's layering:

* :mod:`mediastreamer2_tpu.core`      — factory / filter / graph / ticker (L1)
* :mod:`mediastreamer2_tpu.ops`       — the filter library (L3)
* :mod:`mediastreamer2_tpu.models`    — session-level graph builders (L6)
* :mod:`mediastreamer2_tpu.net`       — RTP/RTCP/jitter buffer/netsim (L4, host)
* :mod:`mediastreamer2_tpu.parallel`  — multi-chip leg sharding
"""

import os as _os

__version__ = "0.1.0"

# git-ignored, inside the checkout: a fixed path, so every process of this
# checkout (chip_smoke.py, bench.py, tools/) hits the same cache entries
_DEFAULT_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")


def compile_cache_dir() -> str:
    """Where compiled executables persist: ``JAX_COMPILATION_CACHE_DIR``
    when set, else a fixed directory in the checkout."""
    return _os.environ.get("JAX_COMPILATION_CACHE_DIR") or _DEFAULT_CACHE_DIR


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache for this process and
    return its directory.  When ``JAX_COMPILATION_CACHE_DIR`` is set JAX
    already reads it and nothing is changed here."""
    path = compile_cache_dir()
    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        import jax
        jax.config.update("jax_compilation_cache_dir", path)
    return path


from mediastreamer2_tpu.core.block import TICK_MS, Format, tick_samples  # noqa: F401
from mediastreamer2_tpu.core.filter import FilterDef, FilterCtx, register_filter  # noqa: F401
from mediastreamer2_tpu.core.factory import Factory  # noqa: F401
from mediastreamer2_tpu.core.graph import GraphBuilder  # noqa: F401
