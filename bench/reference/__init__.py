"""Plain PyTorch references the benchmark holds the program's outputs
against. They import nothing of the program and nothing of JAX.

A family's reference is the module named after its configuration file's
``model_type`` (``qwen2.py``, ``deepseek_v2.py``): its ``traits(c)`` gives
what the family fixes that its published config does not state, and its
``Reference`` the model. A new family is a new module here.
"""
from __future__ import annotations

import importlib
from types import ModuleType


def family(model_type: str) -> ModuleType:
    """The reference module of ``model_type``."""
    if not model_type.replace("_", "").isalnum():
        raise ValueError(f"model_type {model_type!r}")
    try:
        return importlib.import_module(f"bench.reference.{model_type}")
    except ModuleNotFoundError as e:
        raise ValueError(f"no reference for model_type {model_type!r} "
                         f"(bench/reference/{model_type}.py)") from e
