"""MSFactory equivalent: filter registry + plugin loading + codec lookup.

Reference: src/base/msfactory.c (registry at :193-194, plugin dlopen at
:531-586, create_encoder/decoder by mime).  Batched-design differences:

* filters are pure descriptors, so a factory is just a name->FilterDef map
  snapshotting the module-level registry plus any plugins;
* plugins are Python modules exposing ``ms_plugin_init(factory)`` — the
  import machinery replaces dlopen;
* statistics toggling maps to per-node timing collection in the Ticker.
"""
from __future__ import annotations

import importlib
import logging
from typing import Dict, List, Optional

from mediastreamer2_tpu.core.filter import FILTER_REGISTRY, FilterDef

log = logging.getLogger("ms2tpu")


def _load_builtin_filters():
    """Import every ops module so its register_filter() calls run.

    Mirrors ms_factory_init_voip registering voipdescs.h
    (reference: src/voip/msvoip.c:261-342).
    """
    import mediastreamer2_tpu.ops  # noqa: F401  (ops/__init__ imports all filter modules)


class Factory:
    def __init__(self, load_builtins: bool = True):
        if load_builtins:
            _load_builtin_filters()
        self._filters: Dict[str, FilterDef] = dict(FILTER_REGISTRY)
        self._disabled: set = set()
        self.mtu = 1500                       # cf. ms_factory_set_mtu
        self.statistics_enabled = False       # cf. ms_factory_enable_statistics
        self.plugins: List[str] = []

    # --- registry -----------------------------------------------------
    def register(self, fdef: FilterDef):
        self._filters[fdef.name] = fdef

    def lookup(self, name: str) -> FilterDef:
        if name in self._disabled:
            raise KeyError(f"filter '{name}' is disabled "
                           f"(ms_factory_enable_filter_from_name)")
        try:
            return self._filters[name]
        except KeyError:
            raise KeyError(f"no filter '{name}' registered "
                           f"(have: {sorted(self._filters)})") from None

    def has(self, name: str) -> bool:
        return name in self._filters and name not in self._disabled

    def filters(self) -> Dict[str, FilterDef]:
        return {k: v for k, v in self._filters.items()
                if k not in self._disabled}

    # --- per-filter enable/disable (ms_factory_enable_filter_from_name;
    # framework tester 'FilterDesc enabling/disabling') ----------------
    def enable_filter(self, name: str, enabled: bool = True):
        if name not in self._filters:
            raise KeyError(name)
        if enabled:
            self._disabled.discard(name)
        else:
            self._disabled.add(name)

    def filter_enabled(self, name: str) -> bool:
        return self.has(name)

    # --- codec lookup (cf. ms_factory_create_encoder/decoder) ---------
    def find_encoder(self, mime: str) -> Optional[FilterDef]:
        for name, f in self._filters.items():
            if name in self._disabled:
                continue
            if f.category == "encoder" and f.enc_fmt.lower() == mime.lower():
                return f
        return None

    def find_decoder(self, mime: str) -> Optional[FilterDef]:
        for name, f in self._filters.items():
            if name in self._disabled:
                continue
            if f.category == "decoder" and f.enc_fmt.lower() == mime.lower():
                return f
        return None

    def filters_implementing(self, interface: str) -> List[FilterDef]:
        return [f for f in self._filters.values() if f.implements(interface)]

    # --- plugins (cf. ms_factory_load_plugins, msfactory.c:531-586) ---
    def load_plugin(self, module_name: str):
        mod = importlib.import_module(module_name)
        init = getattr(mod, "ms_plugin_init", None)
        if init is None:
            raise ImportError(f"plugin {module_name} has no ms_plugin_init(factory)")
        init(self)
        self.plugins.append(module_name)
        log.info("loaded plugin %s", module_name)

    def enable_statistics(self, on: bool = True):
        self.statistics_enabled = on
