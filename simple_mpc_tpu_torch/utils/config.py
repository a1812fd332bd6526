"""Settings-dict validation shared by every *Settings.from_dict.

The reference throws std::runtime_error on misuse (ocp-handler.cpp:26-33);
silently accepting an unknown key would let a typo'd weight name produce a
default-configured OCP with no error.
"""
from __future__ import annotations

import dataclasses


def settings_from_dict(cls, d: dict):
    """Instantiate a Settings dataclass from a dict, rejecting unknown keys."""
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = [k for k in d if k not in fields]
    if unknown:
        raise RuntimeError(
            f"{cls.__name__}: unknown setting(s) {sorted(unknown)}; "
            f"valid keys are {sorted(fields)}")
    s = cls()
    for k, v in d.items():
        setattr(s, k, v)
    return s
