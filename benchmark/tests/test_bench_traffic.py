"""The cycle's sizes, order and buckets, and inputs made from the seed."""

import numpy as np
import pytest

from benchmark.harness import inputs, spec
from benchmark.reference.data.complexes import atom_bucket, bucket_sizes
from benchmark.tests.tiny import tiny_config

CYCLE = [(28, 1068), (36, 196), (12, 514), (48, 259), (19, 680), (32, 125), (41, 408), (24, 327)]
CELLS = ("dl-mix-p10", "v1-mix-p10")


@pytest.mark.parametrize("name", CELLS)
def test_cycle_sizes_and_order(name):
    traffic = spec.load_json(spec.BENCH_DIR / "traffic" / f"{name}.json")
    assert [tuple(c) for c in traffic["cycle"]] == CYCLE
    assert traffic["poses"] == 10 and traffic["batch_size"] is None
    # the largest complex leads the cycle
    assert max(CYCLE, key=lambda c: c[0] * c[1]) == CYCLE[0]


def test_cycle_buckets_on_the_fine_ladder():
    buckets = [bucket_sizes(nl, nr, nl // 4) for nl, nr in CYCLE]
    assert len({b[:2] for b in buckets}) == 7
    assert min(buckets, key=lambda b: b[0] * b[1]) == (32, 128, 8)
    assert max(buckets, key=lambda b: b[0] * b[1]) == (32, 1536, 8)
    atoms = sorted({atom_bucket(8 * nr) for _, nr in CYCLE})
    assert len(atoms) == 8 and atoms[0] == 1024 and atoms[-1] == 8704


def test_cycle_buckets_are_the_ports():
    from diffdock_tpu_torch.data.complexes import atom_bucket as port_atoms
    from diffdock_tpu_torch.data.complexes import bucket_sizes as port_buckets

    for nl, nr in CYCLE:
        assert port_buckets(nl, nr, nl // 4) == bucket_sizes(nl, nr, nl // 4)
        assert port_atoms(8 * nr) == atom_bucket(8 * nr)


def small_traffic():
    t = spec.load_json(spec.BENCH_DIR / "traffic" / "dl-mix-p10.json")
    t["cycle"] = [[10, 30], [7, 20]]
    return t


@pytest.mark.parametrize("seed", [0, 2**31 + 12345, 2**40 + 7])
def test_inputs_from_the_seed(seed):
    t, cfg = small_traffic(), tiny_config("diffdock_l")
    a = inputs.make_cycle(seed, t, cfg)
    b = inputs.make_cycle(seed, t, cfg)
    c = inputs.make_cycle(seed + 1, t, cfg)
    for (fa, aa), (fb, ab), (fc, _), (nl, nr) in zip(a, b, c, t["cycle"]):
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k])
        for k in aa:
            np.testing.assert_array_equal(aa[k], ab[k])
        # the sizes belong to the cell; the seed draws only the values
        assert fa["lig_pos"].shape == fc["lig_pos"].shape == (nl, 3)
        assert fa["rec_lm"].shape == (nr, 16)
        assert fa["rot_u"].shape == (nl // 4,)
        assert fa["rec_nbr"].shape == (nr, 6) and aa["atom_nbr"].shape == (8 * nr, 4)
        assert aa["atom_pos"].shape == (8 * nr, 3)
        assert not np.array_equal(fa["lig_pos"], fc["lig_pos"])


def test_knn_excludes_each_point_itself():
    pos = np.random.RandomState(0).randn(50, 3).astype(np.float32)
    idx, mask = inputs.knn(pos, 6)
    assert idx.shape == (50, 6) and mask.all()
    assert not (idx == np.arange(50)[:, None]).any()
    d = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
    np.fill_diagonal(d, np.inf)
    np.testing.assert_array_equal(np.sort(idx, axis=1), np.sort(np.argsort(d, axis=1)[:, :6], axis=1))


def test_knn_within_a_radius_keeps_each_points_nearest():
    pos = np.random.RandomState(1).randn(40, 3).astype(np.float32) * 10.0
    idx, mask = inputs.knn(pos, 8, 6.0)
    d = np.linalg.norm(pos[:, None] - pos[None], axis=-1)[np.arange(40)[:, None], idx]
    near = d <= 6.0
    assert near.any() and not near.all()
    lone = ~near.any(axis=1)
    np.testing.assert_array_equal(mask[~lone], near[~lone])
    # a point with no neighbour within the radius keeps its nearest
    assert lone.any() and mask[lone, 0].all() and not mask[lone, 1:].any()
    np.testing.assert_array_equal(inputs.knn(pos, 8)[0], idx)


@pytest.mark.parametrize("name", ["diffdock_l", "diffdock_v1"])
def test_graphs_at_the_published_widths(name):
    g = spec.load_json(spec.BENCH_DIR / "configs" / f"{name}.json")["graph"]
    assert g == {"c_alpha_max_neighbors": 24, "receptor_radius": 15.0, "atom_max_neighbors": 8,
                 "atom_radius": 5.0}


def test_rotatable_bonds_of_a_chain():
    edge_mask, mask_rotate = inputs.rotatable_bond_mask(6, [(i, i + 1) for i in range(5)])
    # the chain's inner bonds (1-2, 2-3, 3-4) rotate the smaller side
    assert edge_mask.sum() == 3 and mask_rotate.shape == (3, 6)
    assert mask_rotate.sum(axis=1).tolist() == [2, 3, 2]
