"""Typed environment knobs that can never crash an import (counterpart
of glt_tpu/utils/env.py).

Every ``GLT_*`` tunable the port reads goes through :func:`knob`: a
malformed value (``GLT_OBS_BUFFER=zillion``) warns once and falls back to
the default instead of raising ``ValueError`` while a module imports.

Parsing contract (chosen by the ``default``'s type, or an explicit
``parse`` callable):

  * bool  — '1'/'true'/'yes'/'on' → True; '0'/''/'false'/'no'/'off' →
    False (case-insensitive); anything else warns and defaults.
  * int / float — the obvious conversions; ValueError warns + defaults.
  * str / None default — the raw string, unset → default.

``knob`` reads the environment on every call (tests monkeypatch knobs
mid-process; caching would make the patch a no-op). :func:`raw` is the
passthrough for opaque infrastructure strings.
"""
from __future__ import annotations

import os
import warnings
from typing import Callable, Optional, TypeVar

T = TypeVar('T')

_TRUE = frozenset(('1', 'true', 'yes', 'on'))
_FALSE = frozenset(('0', '', 'false', 'no', 'off'))

#: malformed values already warned for: (name, raw value) — one warning
#: per distinct bad value, not one per read in a hot loop
_warned: set = set()


def parse_bool(raw: str) -> bool:
  low = raw.strip().lower()
  if low in _TRUE:
    return True
  if low in _FALSE:
    return False
  raise ValueError(f'not a boolean: {raw!r}')


def knob(name: str, default: T,
         parse: Optional[Callable[[str], T]] = None) -> T:
  """Read env var ``name``, parsed to the type of ``default``.

  Unset or empty → ``default``. Malformed → ``warnings.warn`` once per
  distinct bad value, then ``default`` — never an exception.

  Args:
    name: environment variable, by convention ``GLT_*``.
    default: returned when unset/empty/malformed; its type picks the
      parser when ``parse`` is None (bool → :func:`parse_bool`,
      int/float → the constructor, anything else → identity).
    parse: explicit ``str -> T`` override; a raised ``ValueError`` /
      ``TypeError`` triggers the warn-and-default path.
  """
  raw = os.environ.get(name)
  if raw is None or raw == '':
    return default
  if parse is None:
    if isinstance(default, bool):        # before int: bool is an int
      parse = parse_bool
    elif isinstance(default, int):
      parse = int
    elif isinstance(default, float):
      parse = float
    else:
      return raw  # type: ignore[return-value]
  try:
    return parse(raw)
  except (ValueError, TypeError):
    key = (name, raw)
    if key not in _warned:
      _warned.add(key)
      warnings.warn(
          f'{name}={raw!r} is malformed; using default {default!r}',
          RuntimeWarning, stacklevel=2)
    return default


def raw(name: str, default: Optional[str] = None) -> Optional[str]:
  """Opaque string read (no parse, nothing to crash)."""
  return os.environ.get(name, default)
