"""Architecture registry: one module per assigned architecture (the
port's copy of ``repro.configs``: the same ten ids, full and smoke values).

``get(name)`` returns the full-size ModelConfig; ``get_smoke(name)`` returns
the reduced same-family config used by CPU smoke tests.  ``ARCHS`` lists all
assigned ids.
"""
from __future__ import annotations

import importlib

ARCHS = [
    "tinyllama-1.1b",
    "deepseek-7b",
    "deepseek-coder-33b",
    "qwen3-4b",
    "deepseek-v2-236b",
    "qwen3-moe-30b-a3b",
    "jamba-v0.1-52b",
    "pixtral-12b",
    "mamba2-130m",
    "whisper-tiny",
]

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCHS}


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get(name: str):
    return _mod(name).CONFIG


def get_smoke(name: str):
    return _mod(name).SMOKE
