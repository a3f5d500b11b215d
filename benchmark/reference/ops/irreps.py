"""Irreducible representation bookkeeping for O(3)-equivariant features.

A minimal, dependency-free replacement for the slice/parsing layer of
``e3nn.o3.Irreps`` — enough structure to define the fixed irrep ladders the
score model uses (reference ``models/tensor_layers.py:17-41``) and to drive
the tensor-product engine. Pure host-side metadata: nothing here touches
device arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Sequence, Union


@dataclasses.dataclass(frozen=True, order=True)
class Irrep:
    """One irrep of O(3): angular momentum ``l`` and parity ``p`` (+1/-1)."""

    l: int
    p: int

    def __post_init__(self):
        assert self.l >= 0 and self.p in (1, -1)

    @property
    def dim(self) -> int:
        return 2 * self.l + 1

    @classmethod
    def parse(cls, s: str) -> "Irrep":
        s = s.strip()
        l = int(s[:-1])
        p = {"e": 1, "o": -1}[s[-1]]
        return cls(l, p)

    def __str__(self) -> str:
        return f"{self.l}{'e' if self.p == 1 else 'o'}"

    def __mul__(self, other: "Irrep") -> Iterator["Irrep"]:
        """Selection rule: all irreps in the tensor product."""
        p = self.p * other.p
        for l in range(abs(self.l - other.l), self.l + other.l + 1):
            yield Irrep(l, p)


@dataclasses.dataclass(frozen=True)
class MulIrrep:
    mul: int
    ir: Irrep

    @property
    def dim(self) -> int:
        return self.mul * self.ir.dim

    def __str__(self) -> str:
        return f"{self.mul}x{self.ir}"


class Irreps(tuple):
    """An ordered direct sum of multiplicities of irreps, e.g. '16x0e + 4x1o'."""

    def __new__(cls, spec: Union[str, "Irreps", Sequence]) -> "Irreps":
        if isinstance(spec, Irreps):
            return spec
        entries: List[MulIrrep] = []
        if isinstance(spec, str):
            for part in spec.split("+"):
                part = part.strip()
                if not part:
                    continue
                if "x" in part:
                    mul_s, ir_s = part.split("x")
                    entries.append(MulIrrep(int(mul_s), Irrep.parse(ir_s)))
                else:
                    entries.append(MulIrrep(1, Irrep.parse(part)))
        else:
            for item in spec:
                if isinstance(item, MulIrrep):
                    entries.append(item)
                else:
                    mul, ir = item
                    if not isinstance(ir, Irrep):
                        ir = Irrep.parse(ir) if isinstance(ir, str) else Irrep(*ir)
                    entries.append(MulIrrep(int(mul), ir))
        return super().__new__(cls, entries)

    @property
    def dim(self) -> int:
        return sum(e.dim for e in self)

    @property
    def num_irreps(self) -> int:
        return sum(e.mul for e in self)

    def slices(self) -> List[slice]:
        out, start = [], 0
        for e in self:
            out.append(slice(start, start + e.dim))
            start += e.dim
        return out

    def count(self, ir: Union[str, Irrep]) -> int:  # type: ignore[override]
        if isinstance(ir, str):
            ir = Irrep.parse(ir)
        return sum(e.mul for e in self if e.ir == ir)

    def sorted_simplified(self) -> "Irreps":
        """Sort entries by (l, p) and merge equal irreps (for canonical
        intermediate layouts, cf. e3nn ``irreps.sort().irreps.simplify()``)."""
        entries = sorted(self, key=lambda e: (e.ir.l, -e.ir.p))
        merged: List[MulIrrep] = []
        for e in entries:
            if merged and merged[-1].ir == e.ir:
                merged[-1] = MulIrrep(merged[-1].mul + e.mul, e.ir)
            else:
                merged.append(MulIrrep(e.mul, e.ir))
        return Irreps(merged)

    def __repr__(self) -> str:
        return " + ".join(str(e) for e in self) if len(self) else "(empty)"

    __str__ = __repr__

    def __add__(self, other) -> "Irreps":  # type: ignore[override]
        return Irreps(tuple.__add__(self, Irreps(other)))

    @staticmethod
    def spherical_harmonics(lmax: int) -> "Irreps":
        return Irreps([(1, Irrep(l, (-1) ** l)) for l in range(lmax + 1)])


def get_irrep_seq(
    ns: int, nv: int, use_second_order_repr: bool, reduce_pseudoscalars: bool
) -> List[str]:
    """The per-conv-depth irrep ladder (reference ``tensor_layers.py:17-33``)."""
    if use_second_order_repr:
        return [
            f"{ns}x0e",
            f"{ns}x0e + {nv}x1o + {nv}x2e",
            f"{ns}x0e + {nv}x1o + {nv}x2e + {nv}x1e + {nv}x2o",
            f"{ns}x0e + {nv}x1o + {nv}x2e + {nv}x1e + {nv}x2o + "
            f"{nv if reduce_pseudoscalars else ns}x0o",
        ]
    return [
        f"{ns}x0e",
        f"{ns}x0e + {nv}x1o",
        f"{ns}x0e + {nv}x1o + {nv}x1e",
        f"{ns}x0e + {nv}x1o + {nv}x1e + {nv if reduce_pseudoscalars else ns}x0o",
    ]


def irrep_to_size(irrep: str) -> int:
    return Irreps(irrep).dim
