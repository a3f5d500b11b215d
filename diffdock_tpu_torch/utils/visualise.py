"""Reverse-diffusion trajectory writer (port of ``diffdock_tpu/utils/visualise.py``;
reference ``utils/visualise.py``): multi-MODEL PDB so viewers animate the
denoising path."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


class LigandTrajectoryWriter:
    def __init__(self, elements: Sequence[str]):
        self.elements = list(elements)
        self.frames: List[np.ndarray] = []

    def add(self, coords: np.ndarray) -> None:
        self.frames.append(np.asarray(coords))

    def to_pdb(self) -> str:
        lines = []
        for m, frame in enumerate(self.frames, start=1):
            lines.append(f"MODEL     {m:4d}")
            for i, (el, (x, y, z)) in enumerate(zip(self.elements, frame), 1):
                lines.append(
                    f"HETATM{i:5d} {el:<4s}LIG A   1    "
                    f"{x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00          {el:>2s}"
                )
            lines.append("ENDMDL")
        lines.append("END")
        return "\n".join(lines) + "\n"

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_pdb())
