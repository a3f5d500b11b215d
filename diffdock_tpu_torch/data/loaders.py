"""Stacking same-bucket complexes into one training batch (port of
``_stack`` in ``diffdock_tpu/data/loaders.py``, and the ``jnp.stack`` of
padded complexes in ``diffdock_tpu/cli/confidence_train.py``)."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from diffdock_tpu_torch.data.complexes import AAComplexData, ComplexData, pad_to


def stack_batch(members: Sequence[Tuple[str, ComplexData]], bucket: Tuple[int, int, int]
                ) -> Tuple[List[str], ComplexData]:
    """(names, one numpy ComplexData with a leading batch axis): every member
    padded to ``bucket`` (nl, nr, nb) and to the widest bonded-neighbour
    (at least 4: hypervalent atoms exceed it) and receptor kNN width of the
    batch. A field that any member lacks (``rec_scv``) is None."""
    nl, nr, nb = bucket
    kb = max(4, *(d.lig_bond_nbr.shape[1] for _, d in members))
    kr = max(d.rec_nbr.shape[1] for _, d in members)
    return [n for n, _ in members], stack_padded([pad_to(d, nl, nr, nb, kb=kb, kr=kr) for _, d in members])


def stack_padded(datas: Sequence):
    """One numpy ComplexData or AAComplexData with a leading batch axis from
    complexes already padded to one bucket and one set of widths. A field
    that any member lacks (``rec_scv``) is None."""
    if isinstance(datas[0], AAComplexData):
        return AAComplexData(stack_padded([d.base for d in datas]),
                             *[np.stack([np.asarray(d[i]) for d in datas])
                               for i in range(1, len(AAComplexData._fields))])
    fields = []
    for f in ComplexData._fields:
        vals = [getattr(d, f) for d in datas]
        fields.append(None if any(v is None for v in vals) else np.stack([np.asarray(v) for v in vals]))
    return ComplexData(*fields)
