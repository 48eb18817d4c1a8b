"""String-keyed solver registry (counterpart of ``repro.solvers.registry``).

    from repro_torch import solvers
    res = solvers.get("apc").solve(sys, iters=500)
    solvers.available()   # apc, cimmino, consensus, dgd, dhbm, dnag,
                          # madmm, pdhbm
"""
from __future__ import annotations

from typing import Dict, List

from .api import Solver

_REGISTRY: Dict[str, Solver] = {}


def register(name: str):
    """Class decorator: instantiate and register under ``name``."""
    def deco(cls):
        if not issubclass(cls, Solver):
            raise TypeError(f"{cls!r} must subclass solvers.Solver")
        cls.name = name
        _REGISTRY[name] = cls()
        return cls
    return deco


def get(name: str) -> Solver:
    """Look up a registered solver instance by name."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown solver {name!r}; available: "
                       f"{', '.join(available())}") from None


def available() -> List[str]:
    """Sorted names of every registered solver."""
    return sorted(_REGISTRY)
