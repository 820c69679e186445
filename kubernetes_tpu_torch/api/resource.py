"""Resource quantities: the Kubernetes quantity grammar reduced to what
scheduling needs.

Suffixes: decimal SI ``n u m "" k M G T P E``, binary ``Ki Mi Gi Ti Pi
Ei`` and scientific notation. A quantity is stored as an exact integer
count of nano-units (the finest suffix the grammar admits), so every
parseable quantity is exact. The scheduler reads two views of it:
``milli_value`` for CPU and ``value`` for memory, storage and counts.
"""

from __future__ import annotations

import math
import re
from functools import total_ordering

_NANO = 10**9

_SUFFIXES = {
    "n": 1,
    "u": 10**3,
    "m": 10**6,
    "": _NANO,
    "k": _NANO * 10**3,
    "M": _NANO * 10**6,
    "G": _NANO * 10**9,
    "T": _NANO * 10**12,
    "P": _NANO * 10**15,
    "E": _NANO * 10**18,
    "Ki": _NANO * 2**10,
    "Mi": _NANO * 2**20,
    "Gi": _NANO * 2**30,
    "Ti": _NANO * 2**40,
    "Pi": _NANO * 2**50,
    "Ei": _NANO * 2**60,
}

_QUANTITY_RE = re.compile(
    r"^(?P<sign>[+-]?)(?P<num>\d+(?:\.\d*)?|\.\d+)"
    r"(?:(?P<suffix>[numkMGTPE]i?|Ki)|[eE](?P<exp>[+-]?\d+))?$"
)


@total_ordering
class Quantity:
    """An exact resource amount, stored as integer nano-units. Immutable:
    parsed instances are shared through the parse cache."""

    __slots__ = ("nano",)

    def __init__(self, nano: int = 0):
        object.__setattr__(self, "nano", int(nano))

    def __setattr__(self, name, value):
        raise AttributeError("Quantity is immutable")

    def __reduce__(self):
        # immutable: unpickle through the constructor (the binary wire
        # codec pickles API objects)
        return (Quantity, (self.nano,))

    def milli_value(self) -> int:
        """Ceiling milli-units."""
        return -((-self.nano) // 10**6)

    def value(self) -> int:
        """Ceiling whole units."""
        return -((-self.nano) // _NANO)

    def __eq__(self, other) -> bool:
        return isinstance(other, Quantity) and self.nano == other.nano

    def __lt__(self, other: "Quantity") -> bool:
        return self.nano < other.nano

    def __hash__(self):
        return hash(self.nano)

    def __repr__(self):
        return f"Quantity({self.nano}n)"


_PARSE_CACHE: dict = {}
_PARSE_CACHE_MAX = 4096


def parse_quantity(s) -> Quantity:
    """Parse a quantity string (or an int/float unit count): "100m", "2",
    "1.5", "64Mi", "2Gi", "1e3". Raises ValueError on anything else.
    String parses are memoized (bounded): workloads repeat a handful of
    request strings across tens of thousands of pods."""
    if type(s) is str:
        q = _PARSE_CACHE.get(s)
        if q is None:
            q = _parse_uncached(s)
            if len(_PARSE_CACHE) < _PARSE_CACHE_MAX:
                _PARSE_CACHE[s] = q
        return q
    return _parse_uncached(s)


def _parse_uncached(s) -> Quantity:
    if isinstance(s, Quantity):
        return s
    if isinstance(s, bool):
        raise ValueError(f"cannot parse quantity from bool {s!r}")
    if isinstance(s, int):
        return Quantity(s * _NANO)
    if isinstance(s, float):
        if not math.isfinite(s):
            raise ValueError(f"cannot parse quantity from {s!r}")
        return Quantity(round(s * _NANO))
    m = _QUANTITY_RE.match(s.strip())
    if not m:
        raise ValueError(f"invalid quantity {s!r}")
    sign = -1 if m.group("sign") == "-" else 1
    num = m.group("num")
    if m.group("exp") is not None:
        scale = _NANO
        exp = int(m.group("exp"))
    else:
        suffix = m.group("suffix") or ""
        if suffix not in _SUFFIXES:
            raise ValueError(f"invalid quantity suffix in {s!r}")
        scale = _SUFFIXES[suffix]
        exp = 0
    if "." in num:
        int_part, frac_part = num.split(".")
        digits = int((int_part or "0") + frac_part)
        denom = 10 ** len(frac_part)
    else:
        digits = int(num)
        denom = 1
    if exp >= 0:
        numer = digits * scale * 10**exp
    else:
        denom *= 10**(-exp)
        numer = digits * scale
    if numer % denom != 0:
        # sub-nano precision: round half away from zero
        nano = (numer + denom // 2) // denom
    else:
        nano = numer // denom
    return Quantity(sign * nano)
