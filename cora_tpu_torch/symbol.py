"""GTSAM-style variable keys: one character + integer index.

Feature parity with the reference's `include/CORA/Symbol.h:19-88` /
`src/Symbol.cpp:28-41` (char + uint64 packed key, string round-trip,
ordering), implemented as a frozen, hashable Python dataclass.
"""

from __future__ import annotations

import dataclasses
import re

_CHR_BITS = 56  # index occupies low 56 bits; char occupies the top 8


@dataclasses.dataclass(frozen=True, order=True)
class Symbol:
    """A variable key: one character and a non-negative integer index.

    Ordering is (chr, index), matching the reference's
    ``Symbol::operator<`` so that per-robot pose chains sort correctly.
    """

    chr: str
    index: int

    def __init__(self, chr_or_str: "str | int | Symbol", index: int | None = None):
        if isinstance(chr_or_str, Symbol):
            c, j = chr_or_str.chr, chr_or_str.index
        elif index is None:
            if isinstance(chr_or_str, int):
                c, j = _unpack(chr_or_str)
            else:
                m = re.fullmatch(r"(\D)(\d+)", chr_or_str)
                if m is None:
                    raise ValueError(f"invalid symbol string: {chr_or_str!r}")
                c, j = m.group(1), int(m.group(2))
        else:
            c, j = chr_or_str, int(index)
        if len(c) != 1:
            raise ValueError(f"symbol character must be a single char, got {c!r}")
        if j < 0:
            raise ValueError(f"symbol index must be non-negative, got {j}")
        object.__setattr__(self, "chr", c)
        object.__setattr__(self, "index", j)

    def key(self) -> int:
        """Pack into a single integer key (char in high bits)."""
        return (ord(self.chr) << _CHR_BITS) | self.index

    def string(self) -> str:
        return f"{self.chr}{self.index}"

    def __str__(self) -> str:
        return self.string()

    def __repr__(self) -> str:
        return f"Symbol('{self.chr}', {self.index})"


def _unpack(k: int) -> tuple[str, int]:
    return chr(k >> _CHR_BITS), k & ((1 << _CHR_BITS) - 1)


def key(c: str, j: int) -> int:
    """Shorthand key constructor (reference `Symbol.h` `shorthand::A..Z`)."""
    return Symbol(c, j).key()


SymbolPair = tuple[Symbol, Symbol]


def pair_matches(a: SymbolPair, b: SymbolPair) -> bool:
    """Unordered pair equality (reference ``PairMeasurement::hasSymbolPair``)."""
    return (a[0] == b[0] and a[1] == b[1]) or (a[0] == b[1] and a[1] == b[0])


def _make_shorthand(c):
    def ctor(j: int) -> int:
        return Symbol(c, j).key()

    ctor.__name__ = c
    ctor.__doc__ = f"shorthand::{c}(j) — key for Symbol('{c}', j) " \
        "(reference `Symbol.h` shorthand namespace)."
    return ctor


class shorthand:
    """`shorthand.A(j) .. shorthand.Z(j)` key constructors (reference
    `include/CORA/Symbol.h` `namespace shorthand`), plus lowercase."""


for _c in (chr(o) for r in ((65, 91), (97, 123)) for o in range(*r)):
    setattr(shorthand, _c, staticmethod(_make_shorthand(_c)))
del _c
