"""Global ``--param key=value`` registry (ref: src/host.h:137-176).

The port's copy of ``ultragrid_tpu/utils/params.py`` (jax-free).

Modules self-register documented params with :func:`add_to_param`; the CLI
populates values with :func:`set_commandline_param`.
"""

from __future__ import annotations

from typing import Dict, Optional

_documented: Dict[str, str] = {}
_values: Dict[str, Optional[str]] = {}


def add_to_param(key: str, doc: str) -> None:
    """ref: ADD_TO_PARAM macro (src/host.h:146-176)."""
    _documented[key] = doc


def set_commandline_param(key: str, value: Optional[str] = None) -> None:
    _values[key] = value


def get_commandline_param(key: str) -> Optional[str]:
    return _values.get(key)


def param_is_set(key: str) -> bool:
    return key in _values


def print_param_doc() -> str:
    return "\n".join(f"--param {k}\n  {v}" for k, v in sorted(_documented.items()))


def reset_params() -> None:
    _values.clear()
