"""Training data sources, combined-dataset epochs and batch stacking (port of
``diffdock_tpu/data/loaders.py``; the reference's ``datasets/loader.py:30-122``).

The reference trains DiffDock-L on PDBBind, Binding MOAD and the PDB
sidechain ("van der Mers") set together (``--combined_training`` /
``--triple_training``). Every dataset exposes one epoch of ``(name,
ComplexData)`` items; :class:`CombinedSource` interleaves its members'
epochs in a seeded shuffled order, and :func:`iter_bucketed_batches` groups
a stream of items into same-bucket padded stacked batches. The seeds and
``numpy.random.RandomState`` draws are the JAX module's, so both packages
serve the same items in the same order. :func:`stack_batch` (the JAX
``_stack``) also stacks the padded complexes of
``diffdock_tpu/cli/confidence_train.py``.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

from diffdock_tpu_torch.data.complexes import AAComplexData, ComplexData, bucket_sizes, pad_to


class PDBBindSource:
    """Adapter over :class:`diffdock_tpu_torch.data.datasets.ComplexDataset`:
    its names shuffled by ``RandomState(seed)``."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self) -> int:
        return len(self.dataset)

    def epoch_items(self, seed: int) -> Iterator[Tuple[str, ComplexData]]:
        names = list(self.dataset.names)
        np.random.RandomState(seed).shuffle(names)
        for name in names:
            yield name, self.dataset.get(name)


class EpochIteratorSource:
    """Adapter over :class:`~diffdock_tpu_torch.data.moad.MOADDataset` and
    :class:`~diffdock_tpu_torch.data.pdb_sidechain.PDBSidechainDataset`
    (cluster- or contact-sampled epochs)."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self) -> int:
        return len(self.dataset)

    def epoch_items(self, seed: int) -> Iterator[Tuple[str, ComplexData]]:
        yield from self.dataset.epoch_iterator(seed)


class CombinedSource:
    """Several sources in one epoch (the reference's ``CombineDatasets`` and
    its DataLoader's shuffle): each member's epoch (seed ``seed + 17 i``) is
    drawn from in a shuffled schedule of ``len(member)`` slots per member;
    a slot whose member has run out is skipped."""

    def __init__(self, sources: Sequence):
        self.sources = list(sources)

    def __len__(self) -> int:
        return sum(len(s) for s in self.sources)

    def epoch_items(self, seed: int) -> Iterator[Tuple[str, ComplexData]]:
        rng = np.random.RandomState(seed)
        schedule = np.concatenate([np.full(len(s), i, np.int32) for i, s in enumerate(self.sources)])
        rng.shuffle(schedule)
        iters = [s.epoch_items(seed + 17 * i) for i, s in enumerate(self.sources)]
        for si in schedule:
            try:
                yield next(iters[si])
            except StopIteration:
                continue


def iter_bucketed_batches(items: Iterator[Tuple[str, ComplexData]], batch_size: int,
                          flush_partial: bool = True) -> Iterator[Tuple[List[str], ComplexData]]:
    """Group a stream of complexes into same-bucket padded stacked batches:
    a batch leaves as soon as its bucket holds ``batch_size`` items; the
    rest leave at the end of the stream, bucket by bucket in first-seen
    order (``flush_partial``). Items that are None are skipped."""
    pending: Dict[Tuple[int, int, int], List[Tuple[str, ComplexData]]] = {}
    for name, data in items:
        if data is None:
            continue
        b = bucket_sizes(data.n_lig, data.n_rec, data.n_bonds)
        pending.setdefault(b, []).append((name, data))
        if len(pending[b]) >= batch_size:
            yield stack_batch(pending.pop(b), b)
    if flush_partial:
        for b, members in pending.items():
            if members:
                yield stack_batch(members, b)


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


def take_rows(batch, rows):
    """The complexes ``rows`` (a slice or index) of a stacked ComplexData or
    AAComplexData, numpy or torch; None fields stay None."""
    if isinstance(batch, AAComplexData):
        return AAComplexData(take_rows(batch.base, rows), *[a[rows] for a in batch[1:]])
    return ComplexData(*[None if a is None else a[rows] for a in batch])


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


def build_train_source(args):
    """The training source of the train CLI's arguments (the reference's
    ``construct_loader``): ``--dataset pdbbind|moad|pdbsidechain``, with
    ``--combined_training`` adding PDBBind and MOAD and
    ``--triple_training`` adding PDBSidechain; one source, or a
    :class:`CombinedSource` of them in that order."""
    sources = []

    def pdbbind():
        from diffdock_tpu_torch.data.datasets import ComplexDataset, DatasetConfig, pdbbind_specs

        specs = pdbbind_specs(args.data_dir, args.split_train,
                              esm_embeddings_dir=args.esm_embeddings_dir)
        if args.limit_complexes:
            specs = specs[: args.limit_complexes]
        ds = ComplexDataset(specs, DatasetConfig(cache_dir=args.cache_path))
        ds.preprocess(num_workers=args.num_workers)
        return PDBBindSource(ds)

    def moad():
        from diffdock_tpu_torch.data.moad import MOADConfig, MOADDataset

        ds = MOADDataset(MOADConfig(
            moad_dir=args.moad_dir, cache_dir=args.cache_path, split="train",
            limit_complexes=args.limit_complexes, chain_cutoff=args.chain_cutoff,
            unroll_clusters=args.unroll_clusters,
        ))
        esm_table = None
        if args.esm_embeddings_dir:
            from diffdock_tpu_torch.data.esm import LazyNpyTable

            esm_table = LazyNpyTable(args.esm_embeddings_dir)
        ds.preprocess(esm_table=esm_table)
        return EpochIteratorSource(ds)

    def pdbsidechain():
        from diffdock_tpu_torch.data.pdb_sidechain import PDBSidechainConfig, PDBSidechainDataset

        ds = PDBSidechainDataset(PDBSidechainConfig(
            data_dir=args.pdbsidechain_dir, cache_dir=args.cache_path,
            limit_complexes=args.limit_complexes,
            remove_second_segment=args.remove_second_segment,
        ))
        ds.preprocess()
        return EpochIteratorSource(ds)

    if args.dataset == "pdbbind" or args.combined_training:
        sources.append(pdbbind())
    if args.dataset == "moad" or args.combined_training:
        sources.append(moad())
    if args.dataset == "pdbsidechain" or args.triple_training:
        sources.append(pdbsidechain())
    if not sources:
        raise ValueError(f"no training source for dataset={args.dataset}")
    return sources[0] if len(sources) == 1 else CombinedSource(sources)
