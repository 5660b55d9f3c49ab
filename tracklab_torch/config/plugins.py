"""Third-party plugin config discovery (counterpart of
tracklab_tpu.config.plugins).

Packages expose a ``tracklab_torch_plugin`` entry point whose value names a
module; that module's ``config_package`` attribute (a directory path or a
package name holding YAML groups) is appended to the config search path,
so plugin configs compose like the port's own.
"""
from __future__ import annotations

import importlib
import logging
from pathlib import Path

log = logging.getLogger(__name__)

__all__ = ["discover_plugin_config_dirs"]


def discover_plugin_config_dirs():
    try:
        from importlib.metadata import entry_points
        eps = entry_points(group="tracklab_torch_plugin")
    except Exception:
        return []
    dirs = []
    for ep in eps:
        try:
            mod = importlib.import_module(ep.module)
            pkg = getattr(mod, "config_package", None)
            if pkg is None:
                continue
            p = Path(pkg)
            if not p.exists():
                p = Path(importlib.import_module(pkg).__file__).parent
            dirs.append(p)
            log.info("Plugin configs: %s -> %s", ep.name, p)
        except Exception as e:
            log.warning("Failed to load plugin %s: %s", ep.name, e)
    return dirs
