"""``paddle.hub`` (port of the reference package's ``hapi/hub.py``, a
copy): list, help and load the entrypoints of a repo's ``hubconf.py``.

Zero-egress build: the ``local`` source (a directory containing
``hubconf.py``) is fully supported; ``github``/``gitee`` sources raise
with a clear message instead of attempting a download. Entrypoint
semantics match the reference: every public callable in hubconf is an
entrypoint; ``dependencies`` is an optional list checked before load.
"""

from __future__ import annotations

import importlib.util
import os
import sys

__all__ = ["list", "help", "load"]

MODULE_HUBCONF = "hubconf.py"


def _load_hubconf(repo_dir, source):
    if source not in ("local",):
        raise RuntimeError(
            f"source={source!r} requires network access; this build "
            "supports source='local' (a directory containing hubconf.py)")
    path = os.path.join(repo_dir, MODULE_HUBCONF)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {MODULE_HUBCONF} in {repo_dir!r}")
    name = f"paddle_tpu_hubconf_{abs(hash(os.path.abspath(path)))}"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    try:
        spec.loader.exec_module(module)
    except Exception:
        sys.modules.pop(name, None)
        raise
    deps = getattr(module, "dependencies", [])
    missing = []
    for d in deps:
        try:
            importlib.import_module(d)
        except ImportError:
            missing.append(d)
    if missing:
        raise RuntimeError(
            f"hub repo {repo_dir!r} requires missing packages: {missing}")
    return module


def _entrypoints(module):
    return {n: fn for n, fn in vars(module).items()
            if callable(fn) and not n.startswith("_")}


def list(repo_dir, source="local", force_reload=False):
    """Entrypoint names exposed by the repo's hubconf (reference
    `hub.py:172`)."""
    return sorted(_entrypoints(_load_hubconf(repo_dir, source)))


def help(repo_dir, model, source="local", force_reload=False):
    """Docstring of one entrypoint (reference `hub.py:help`)."""
    eps = _entrypoints(_load_hubconf(repo_dir, source))
    if model not in eps:
        raise RuntimeError(f"cannot find callable {model!r} in hubconf")
    return eps[model].__doc__


def load(repo_dir, model, source="local", force_reload=False, **kwargs):
    """Build one entrypoint (reference `hub.py:261`)."""
    eps = _entrypoints(_load_hubconf(repo_dir, source))
    if model not in eps:
        raise RuntimeError(f"cannot find callable {model!r} in hubconf")
    return eps[model](**kwargs)
