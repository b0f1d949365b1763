"""The package's former name, kept so that decks and launchers written
against it keep working: importing it, or any submodule through it, gives
the same module objects as ``vpic_jax``, and ``python -m`` with it runs the
vpic_jax CLI.  A rank set in the environment variable of the former name
(``<FORMER NAME>_RANK``) is passed on as ``VPIC_RANK``."""

import importlib
import importlib.abc
import importlib.util
import os
import sys

import vpic_jax

_OLD = __name__
_OLD_RANK = _OLD.upper() + "_RANK"
if _OLD_RANK in os.environ:
    os.environ.setdefault("VPIC_RANK", os.environ[_OLD_RANK])


class _Alias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """``<former>.<sub>`` -> the module ``vpic_jax.<sub>`` itself (``__main__``
    is left to the path finder, which runs vpic_jax/__main__.py)."""

    def find_spec(self, name, path=None, target=None):
        if name.startswith(_OLD + ".") and not name.endswith(".__main__"):
            return importlib.util.spec_from_loader(name, self)
        return None

    def create_module(self, spec):
        module = importlib.import_module("vpic_jax" + spec.name[len(_OLD):])
        spec.loader_state = module.__spec__
        return module

    def exec_module(self, module):
        # the import system set the alias spec on the module; put back its own
        module.__spec__ = module.__spec__.loader_state


sys.meta_path.insert(0, _Alias())
sys.modules[_OLD] = vpic_jax
