"""Stacking same-bucket complexes into one training batch (port of
``_stack`` in ``diffdock_tpu/data/loaders.py``)."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from diffdock_tpu_torch.data.complexes import ComplexData, pad_to


def stack_batch(members: Sequence[Tuple[str, ComplexData]], bucket: Tuple[int, int, int]
                ) -> Tuple[List[str], ComplexData]:
    """(names, one numpy ComplexData with a leading batch axis): every member
    padded to ``bucket`` (nl, nr, nb) and to the widest bonded-neighbour
    (at least 4: hypervalent atoms exceed it) and receptor kNN width of the
    batch. A field that any member lacks (``rec_scv``) is None."""
    nl, nr, nb = bucket
    kb = max(4, *(d.lig_bond_nbr.shape[1] for _, d in members))
    kr = max(d.rec_nbr.shape[1] for _, d in members)
    datas = [pad_to(d, nl, nr, nb, kb=kb, kr=kr) for _, d in members]

    def stack_field(f):
        vals = [getattr(d, f) for d in datas]
        if any(v is None for v in vals):
            return None
        return np.stack([np.asarray(v) for v in vals])

    return [n for n, _ in members], ComplexData(*[stack_field(f) for f in ComplexData._fields])
