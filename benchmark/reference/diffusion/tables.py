"""On-disk cache of the numpy-built diffusion tables.

Tables are generated with numpy (float64, bit-identical to the JAX
package's generators) and cached as ``.npz`` under
``benchmark/_build/reference_tables/`` inside the checkout, which git
ignores: the reference's own tables, never the program's.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path
from typing import Callable, Dict

import numpy as np

TABLE_DIR = Path(__file__).resolve().parents[2] / "_build" / "reference_tables"


def cached_tables(kind: str, cfg, generate: Callable[[], Dict[str, np.ndarray]]
                  ) -> Dict[str, np.ndarray]:
    """Load ``kind`` tables for ``cfg`` from the cache, or generate and
    store them (written to a per-process temporary, then renamed)."""
    key = hashlib.md5(repr(cfg).encode()).hexdigest()[:12]
    path = TABLE_DIR / f"{kind}_tables_{key}.npz"
    if path.exists():
        with np.load(path) as data:
            return {k: data[k] for k in data.files}
    arrays = generate()
    TABLE_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(f"{path}.{os.getpid()}.tmp.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    return arrays
