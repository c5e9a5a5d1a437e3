"""The package's former name, kept as an alias of ``tinyslam``.

``import <this name>.ops.hamming`` gives the very module object that
``import tinyslam.ops.hamming`` gives, and ``python -m <this name>.run``
runs ``tinyslam.run``.  Importing it warns; new code imports ``tinyslam``.
"""

from __future__ import annotations

import importlib
import importlib.abc
import importlib.util
import sys
import warnings

import tinyslam

_PREFIX = __name__ + "."


def _target(name: str) -> str:
    return "tinyslam." + name[len(_PREFIX):]


class _Alias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Resolves ``<this name>.X`` to the already imported ``tinyslam.X``."""

    def find_spec(self, name, path=None, target=None):
        if not name.startswith(_PREFIX):
            return None
        real = importlib.util.find_spec(_target(name))
        if real is None:
            return None
        spec = importlib.util.spec_from_loader(
            name, self, origin=real.origin,
            is_package=real.submodule_search_locations is not None)
        spec.loader_state = real
        return spec

    def create_module(self, spec):
        return importlib.import_module(spec.loader_state.name)

    def exec_module(self, module):
        # The import machinery set the alias spec on the shared module;
        # give it back its own.
        module.__spec__ = module.__spec__.loader_state

    def get_code(self, name):          # for ``python -m``
        real = importlib.util.find_spec(_target(name))
        return real.loader.get_code(real.name)


if not any(isinstance(f, _Alias) for f in sys.meta_path):
    sys.meta_path.insert(0, _Alias())
globals().update({k: v for k, v in vars(tinyslam).items()
                  if not k.startswith("__")})
warnings.warn(f"{__name__} is now tinyslam; import tinyslam instead",
              DeprecationWarning, stacklevel=2)
