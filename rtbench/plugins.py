"""Files found by name: ``rtbench/<folder>/<name>.py``.  A step kind
(``kinds``), a scene generator (``scenes``), a texture generator
(``textures``) or a per-layer metric's reader (``metrics``) is one such
file, so a later cell adds files and edits none."""
from __future__ import annotations

import importlib.util
import os
import re

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_loaded: dict[str, object] = {}


def load(folder: str, name: str, root: str = ROOT):
    """The module ``<root>/rtbench/<folder>/<name>.py``, loaded once."""
    path = os.path.join(root, "rtbench", folder, name + ".py")
    if path not in _loaded:
        if not os.path.isfile(path):
            raise KeyError(f"no file rtbench/{folder}/{name}.py")
        spec = importlib.util.spec_from_file_location(
            f"rtbench_{folder}_" + re.sub(r"\W", "_", name), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _loaded[path] = module
    return _loaded[path]
