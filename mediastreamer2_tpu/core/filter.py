"""Filter descriptors — the batched MSFilterDesc.

The reference models every processing element as an ``MSFilterDesc`` with
``init/preprocess/process/postprocess/uninit`` callbacks and a method table
(reference: include/mediastreamer2/msfilter.h:161-178).  Here a filter is a
**pure function over batched tick blocks**:

    process(state, inputs, params, ctx) -> (state, outputs, events)

* ``state``  — pytree of per-leg arrays (leading dim = batch). Carried by the
  compiled graph across ticks (the functional replacement for the C structs
  hanging off ``MSFilter.data``).
* ``inputs`` / ``outputs`` — tuples of tick blocks ``[batch, samples]``.
* ``params`` — dict of runtime-reconfigurable arrays (gains, enables, modes),
  fed fresh every device step.  This replaces the reference's
  ``ms_filter_call_method`` runtime reconfiguration (msfilter.c:171-205)
  without recompiling: methods that only change *values* mutate params;
  methods that change *shapes* re-bucket the leg to a different graph.
* ``events`` — dict name -> per-leg array, surfaced to the host EventQueue
  (the replacement for ``ms_filter_notify``, msfilter.c / eventqueue.c).

Filters also declare *interfaces* (strings), mirroring the reference's
MSFilterInterfaceId trait system (include/mediastreamer2/msinterfaces.h,
msfilter.h:77-94) so graph builders stay implementation-agnostic.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

from mediastreamer2_tpu.core.block import Format


@dataclasses.dataclass
class FilterCtx:
    """Build-time context handed to init/out_formats."""
    batch: int
    in_formats: Tuple[Format, ...]
    params: Dict[str, object]          # static (python-level) construction params
    name: str = ""                     # node instance name


# Categories mirror MSFilterCategory (reference: msfilter.h:96-117)
CATEGORIES = ("other", "encoder", "decoder", "encoding_capturer", "decoding_renderer")


@dataclasses.dataclass(frozen=True)
class FilterDef:
    """Descriptor registered into the factory (cf. MSFilterDesc)."""
    name: str
    ninputs: int
    noutputs: int
    # out_formats(ctx) -> tuple of Format, one per output pin
    out_formats: Callable[[FilterCtx], Tuple[Format, ...]]
    # init(ctx) -> state pytree (batched leading dim) — may be None
    init: Optional[Callable[[FilterCtx], object]] = None
    # process(state, inputs, params, ctx) -> (state, outputs, events)
    process: Callable = None
    # default runtime params: dict name -> (default array factory)(ctx)
    runtime_params: Optional[Callable[[FilterCtx], Dict[str, object]]] = None
    category: str = "other"
    interfaces: Tuple[str, ...] = ()
    # encoder/decoder mime type for factory create_encoder/create_decoder
    enc_fmt: str = ""

    def implements(self, interface: str) -> bool:
        # cf. ms_filter_implements_interface (reference: msfilter.h:454)
        return interface in self.interfaces


FILTER_REGISTRY: Dict[str, FilterDef] = {}


def register_filter(fdef: FilterDef) -> FilterDef:
    """Module-level registration; Factory snapshots this at construction.

    Mirrors the reference's build-time awk-generated descriptor tables
    (basedescs.h / voipdescs.h, reference: src/base/msfactory.c:193-194)
    — in Python the import system is the codegen.
    """
    if fdef.name in FILTER_REGISTRY:
        raise ValueError(f"duplicate filter name {fdef.name}")
    FILTER_REGISTRY[fdef.name] = fdef
    return fdef


def filter_def(name: str, ninputs: int, noutputs: int, *, category: str = "other",
               interfaces: Sequence[str] = (), enc_fmt: str = "",
               out_formats=None, init=None, runtime_params=None):
    """Decorator: the decorated function is the ``process`` callback."""
    def deco(process_fn):
        fdef = FilterDef(
            name=name, ninputs=ninputs, noutputs=noutputs,
            out_formats=out_formats or (lambda ctx: ctx.in_formats[:1] * max(noutputs, 0)),
            init=init, process=process_fn, runtime_params=runtime_params,
            category=category, interfaces=tuple(interfaces), enc_fmt=enc_fmt,
        )
        register_filter(fdef)
        return fdef
    return deco
