"""The port's training data sources (``data/loaders.py``) vs the JAX
package's on the CPU.

PDBBind is a split of e2e_synth complexes, MOAD the layout of
``tests/test_torch_port_moad.py`` (its training split: one cluster per
receptor), PDBSidechain the generated full-sidechain proteins of
``tests/test_torch_port_pdb_sidechain.py``; each package preprocesses into
caches of its own. For the same seeds the sources, their combined epochs,
the bucketed batches of ``iter_bucketed_batches`` and the sources that
``build_train_source`` assembles from the train CLI's arguments must give
the same names in the same order and equal arrays, bit for bit.
"""

from types import SimpleNamespace

import pytest
import torch

from diffdock_tpu.data import loaders as jloaders
from diffdock_tpu.data import moad as jmoad
from diffdock_tpu.data import pdb_sidechain as jsc
from diffdock_tpu.data.datasets import ComplexDataset as JComplexDataset
from diffdock_tpu.data.datasets import DatasetConfig as JDatasetConfig
from diffdock_tpu.data.datasets import pdbbind_specs as j_pdbbind_specs
from diffdock_tpu_torch.data import loaders, moad
from diffdock_tpu_torch.data import pdb_sidechain as sc
from diffdock_tpu_torch.data.datasets import ComplexDataset, DatasetConfig, pdbbind_specs
from tests.test_torch_port_datasets import SYNTH
from tests.test_torch_port_moad import _same, layout  # noqa: F401
from tests.test_torch_port_pdb_sidechain import sc_dir  # noqa: F401

@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PDBBIND = ("syn044_l9r90", "syn131_l25r90", "syn128_l41r90", "syn001_l24r104", "syn006_l29r122")


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    path = tmp_path_factory.mktemp("split") / "train.txt"
    path.write_text("\n".join(PDBBIND) + "\n")
    return path


def _datasets(split, layout, sc_dir, tmp_path):
    """{source: (port dataset, JAX dataset)}, each preprocessed."""
    root = layout[0]
    out = {}
    ours = ComplexDataset(pdbbind_specs(str(SYNTH), str(split)), DatasetConfig(cache_dir=str(tmp_path / "p")))
    ref = JComplexDataset(j_pdbbind_specs(str(SYNTH), str(split)), JDatasetConfig(cache_dir=str(tmp_path / "j")))
    out["pdbbind"] = ours, ref
    out["moad"] = (moad.MOADDataset(moad.MOADConfig(moad_dir=str(root), cache_dir=str(tmp_path / "p"))),
                   jmoad.MOADDataset(jmoad.MOADConfig(moad_dir=str(root), cache_dir=str(tmp_path / "j"))))
    out["pdbsidechain"] = (
        sc.PDBSidechainDataset(sc.PDBSidechainConfig(data_dir=str(sc_dir), cache_dir=str(tmp_path / "p"))),
        jsc.PDBSidechainDataset(jsc.PDBSidechainConfig(data_dir=str(sc_dir), cache_dir=str(tmp_path / "j"))))
    for a, b in out.values():
        a.preprocess(verbose=False)
        b.preprocess(verbose=False)
    return out


def _sources(ds):
    ours = [loaders.PDBBindSource(ds["pdbbind"][0]), loaders.EpochIteratorSource(ds["moad"][0]),
            loaders.EpochIteratorSource(ds["pdbsidechain"][0])]
    ref = [jloaders.PDBBindSource(ds["pdbbind"][1]), jloaders.EpochIteratorSource(ds["moad"][1]),
           jloaders.EpochIteratorSource(ds["pdbsidechain"][1])]
    return ours, ref


def _same_items(a, b):
    a, b = list(a), list(b)
    assert [n for n, _ in a] == [n for n, _ in b]
    for (_, x), (_, y) in zip(a, b):
        _same(x, y)
    return [n for n, _ in a]


def test_sources_and_combined_epochs_equal_jax(split, layout, sc_dir, tmp_path):  # noqa: F811
    ours, ref = _sources(_datasets(split, layout, sc_dir, tmp_path))
    for seed in (0, 5):
        for a, b in zip(ours, ref):
            assert len(a) == len(b)
            _same_items(a.epoch_items(seed), b.epoch_items(seed))
        combined, jcombined = loaders.CombinedSource(ours), jloaders.CombinedSource(ref)
        assert len(combined) == len(jcombined) == len(PDBBIND) + 2 + 3
        names = _same_items(combined.epoch_items(seed), jcombined.epoch_items(seed))
        # all three sources are interleaved in the epoch
        assert {n[:3] for n in names} == {"syn", "s00", "sc0"}


@pytest.mark.parametrize("batch_size,flush", [(2, True), (3, True), (2, False)])
def test_iter_bucketed_batches_equal_jax(split, layout, sc_dir, tmp_path, batch_size, flush):  # noqa: F811
    ours, ref = _sources(_datasets(split, layout, sc_dir, tmp_path))
    got = list(loaders.iter_bucketed_batches(loaders.CombinedSource(ours).epoch_items(1), batch_size, flush))
    want = list(jloaders.iter_bucketed_batches(jloaders.CombinedSource(ref).epoch_items(1), batch_size,
                                               flush))
    assert [n for n, _ in got] == [n for n, _ in want] and got
    for (_, a), (_, b) in zip(got, want):
        _same(a, b)
    if not flush:
        assert all(len(n) == batch_size for n, _ in got)
    # a None item is skipped
    items = [("none", None)] + list(loaders.CombinedSource(ours).epoch_items(1))
    assert [n for n, _ in loaders.iter_bucketed_batches(iter(items), batch_size, flush)] == \
        [n for n, _ in got]


@pytest.mark.parametrize("dataset,combined,triple", [
    ("pdbbind", False, False), ("moad", False, False), ("pdbsidechain", False, False),
    ("pdbbind", True, False), ("pdbbind", True, True), ("moad", False, True),
])
def test_build_train_source_equals_jax(split, layout, sc_dir, tmp_path, dataset, combined, triple):  # noqa: F811
    def args(cache):
        return SimpleNamespace(
            dataset=dataset, combined_training=combined, triple_training=triple,
            data_dir=str(SYNTH), split_train=str(split), esm_embeddings_dir=None, limit_complexes=0,
            cache_path=str(tmp_path / cache), num_workers=0, moad_dir=str(layout[0]),
            chain_cutoff=None, unroll_clusters=False, pdbsidechain_dir=str(sc_dir),
            remove_second_segment=False)

    ours, ref = loaders.build_train_source(args("p")), jloaders.build_train_source(args("j"))
    assert type(ours).__name__ == type(ref).__name__ and len(ours) == len(ref)
    if isinstance(ours, loaders.CombinedSource):
        assert [type(s).__name__ for s in ours.sources] == [type(s).__name__ for s in ref.sources]
    _same_items(ours.epoch_items(2), ref.epoch_items(2))


def test_build_train_source_refuses_no_source():
    args = SimpleNamespace(dataset="other", combined_training=False, triple_training=False)
    with pytest.raises(ValueError, match="no training source"):
        loaders.build_train_source(args)
    with pytest.raises(ValueError, match="no training source"):
        jloaders.build_train_source(args)
