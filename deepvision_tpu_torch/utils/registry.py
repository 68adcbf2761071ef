"""Tiny name → object registries (own copy of deepvision_tpu/utils/registry.py).

One shared registry so configs and models are declared once and selected
through the same ``-m <name>`` CLI surface as the JAX package.
"""

from __future__ import annotations

from typing import Dict


class Registry:
    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, object] = {}

    def register(self, name: str, obj: object = None):
        if obj is not None:
            self._add(name, obj)
            return obj

        def deco(o):
            self._add(name, o)
            return o

        return deco

    def _add(self, name: str, obj: object):
        if name in self._entries:
            raise KeyError(f"duplicate {self.kind} registration: {name!r}")
        self._entries[name] = obj

    def get(self, name: str):
        try:
            return self._entries[name]
        except KeyError:
            known = ", ".join(sorted(self._entries))
            raise KeyError(f"unknown {self.kind} {name!r}; known: {known}") from None


MODELS = Registry("model")
CONFIGS = Registry("training config")
