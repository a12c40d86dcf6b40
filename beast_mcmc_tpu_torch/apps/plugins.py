"""Plugin loading — user extension modules discovered from a directory
(ref: src/dr/app/plugin/Plugin.java + PluginLoader — jars in -plugins_dir
contribute extra XML parsers; template in plugins_SDK/).

Here a plugin is a python file in the plugins directory exposing
`register(registry)`; the registry maps extension-point names to dicts a
plugin can add to:

  registry["xml_elements"]  — extra BEAST-XML element handlers
                              (beast_mcmc_tpu_torch.config.xml_import extension)
  registry["templates"]     — extra beastgen templates
  registry["operators"]     — named operator factories

The port's own copy of beast_mcmc_tpu/apps/plugins.py: host-side numpy over
this package's modules, the same outputs on the same inputs and seeds.
"""

from __future__ import annotations

import importlib.util
import os
import sys
from typing import Any, Dict, List


def default_registry() -> Dict[str, Dict[str, Any]]:
    from beast_mcmc_tpu_torch.apps.beastgen import TEMPLATES

    return {
        "xml_elements": {},
        "templates": TEMPLATES,
        "operators": {},
    }


def load_plugins(plugins_dir: str, registry: Dict[str, Dict[str, Any]] = None
                 ) -> List[str]:
    """Import every *.py in plugins_dir and call its register(registry).
    Returns the loaded plugin names."""
    if registry is None:
        registry = default_registry()
    loaded = []
    if not os.path.isdir(plugins_dir):
        return loaded
    for fname in sorted(os.listdir(plugins_dir)):
        if not fname.endswith(".py") or fname.startswith("_"):
            continue
        name = f"beast_mcmc_tpu_torch_plugin_{fname[:-3]}"
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(plugins_dir, fname))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
        if hasattr(mod, "register"):
            mod.register(registry)
            loaded.append(fname[:-3])
    return loaded
