"""User config file (~/.ug.rc) device aliases.

The port's copy of ``ultragrid_tpu/utils/config_file.py`` (jax-free; copied, not imported, so
the port never runs the JAX package's ``__init__``).

Parity with the reference's config file (ref: src/utils/config_file.{h,cpp}):
lines of the form

    alias <class> <name> <substitution>
    capture-filter <alias> <filter-chain>

e.g. ``alias capture camera testcard:s=1280x720`` lets the user say
``-t camera``; an optional ``capture-filter camera logo:...`` line attaches a
filter chain whenever the alias is used.  Lookup is line-oriented exactly
like the reference's get_nth_word scan (first match wins, single spaces).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple


def default_config_file() -> Optional[str]:
    home = os.environ.get("HOME")
    if not home:
        return None
    return os.path.join(home, ".ug.rc")


class ConfigFile:
    """Parsed config file; missing file yields an empty instance (the
    reference reports no error either, config_file.cpp:90-106)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path if path is not None else default_config_file()
        self._lines: List[str] = []
        if self.path:
            try:
                with open(self.path, "r", encoding="utf-8", errors="replace") as f:
                    self._lines = [ln.rstrip("\n") for ln in f]
            except OSError:
                pass

    def _first_word_after(self, prefix: str) -> Optional[str]:
        for line in self._lines:
            if line.startswith(prefix):
                rest = line[len(prefix):].split(" ")
                if rest and rest[0]:
                    return rest[0]
        return None

    def get_alias(self, item_class: str, name: str) -> Optional[str]:
        """alias <class> <name> -> substitution (ref: config_file_get_alias)."""
        return self._first_word_after(f"alias {item_class} {name} ")

    def get_capture_filter_for_alias(self, alias: str) -> Optional[str]:
        return self._first_word_after(f"capture-filter {alias} ")

    def capture_aliases(self) -> Dict[str, str]:
        """All 'alias capture' entries (ref: get_configured_capture_aliases)."""
        out: Dict[str, str] = {}
        prefix = "alias capture "
        for line in self._lines:
            if line.lower().startswith(prefix):
                rest = line[len(prefix):].split(" ", 1)
                if len(rest) == 2 and rest[0]:
                    out.setdefault(rest[0], rest[1])
        return out

    def resolve_device(self, item_class: str, spec: str) -> Tuple[str, Optional[str]]:
        """Substitute an alias in a device spec's driver name.

        Returns (resolved_spec, capture_filter_or_None).  Non-aliased specs
        pass through unchanged (ref: video_capture_params.c alias handling).
        """
        driver, sep, cfg = spec.partition(":")
        target = self.get_alias(item_class, driver)
        if target is None:
            return spec, None
        resolved = target + (sep + cfg if sep else "")
        return resolved, self.get_capture_filter_for_alias(driver)
