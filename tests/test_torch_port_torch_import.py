"""The port's reference-checkpoint importer against the JAX package's on
the CPU: the converted trees of the four reference architectures and the
faster sh_lmax=1 layout leaf by leaf (exactly: they are permutations,
transposes and reshapes), ``config_from_reference_args`` field by field,
the e3nn golden fixture through the port's conv layer (2e-4, as
``tests/test_e3nn_parity.py`` holds the JAX layer), the strict state-dict
loader, and ``simple_yaml`` against PyYAML on a reference args dump.

Reference state dicts come from ``tests/test_torch_import.py:build_ref_sd``
with parameters drawn from a numpy seed at small width (ns=8, nv=2).
"""

import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from diffdock_tpu.models.config import ScoreModelConfig as JConfig
from diffdock_tpu.utils import torch_import as jimport
from diffdock_tpu_torch.models.config import ScoreModelConfig
from diffdock_tpu_torch.ops.irreps import Irreps
from diffdock_tpu_torch.ops.tensor_product import FullyConnectedTensorProduct
from diffdock_tpu_torch.utils import simple_yaml, torch_import
from diffdock_tpu_torch.utils.convert import load_converted
from tests.test_torch_import import CFG, build_ref_sd, expected_params

torch.set_num_threads(1)

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "e3nn_golden.npz"

ARCHS = {
    "cg": CFG,
    "aa_confidence": dataclasses.replace(CFG, all_atoms=True, confidence_mode=True, lm_embedding_dim=16),
    "old_cg": JConfig(ns=8, nv=2, num_conv_layers=2, old_architecture=True, fixed_center_conv=False),
    "old_aa_confidence": JConfig(ns=8, nv=2, num_conv_layers=3, old_architecture=True, all_atoms=True,
                                 confidence_mode=True, lm_embedding_dim=16),
    "old_cg_confidence": JConfig(ns=8, nv=2, num_conv_layers=2, old_architecture=True,
                                 confidence_mode=True),
    "faster_sh1": dataclasses.replace(CFG, sh_lmax=1),
}


def port_cfg(jcfg) -> ScoreModelConfig:
    """The port's config with the JAX config's fields."""
    d = dataclasses.asdict(jcfg)
    from diffdock_tpu_torch.diffusion.schedules import SigmaConfig

    d["sigma"] = SigmaConfig(**d["sigma"])
    return ScoreModelConfig(**d)


def reference_sd(jcfg, seed=3):
    """A reference-format state dict (numpy) and the flax tree it encodes."""
    shapes, stat_shapes = expected_params(jcfg)
    rng = np.random.RandomState(seed)
    draw = lambda t: jax.tree.map(lambda s: rng.randn(*s.shape).astype(np.float32), t)  # noqa: E731
    params, stats = draw(shapes), draw(stat_shapes)
    return build_ref_sd(params, stats, jcfg), params, stats


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def assert_trees_equal(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert set(la) == set(lb), set(la) ^ set(lb)
    for k in la:
        assert la[k].dtype == lb[k].dtype and la[k].shape == lb[k].shape, k
        np.testing.assert_array_equal(la[k], lb[k], err_msg=str(k))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_converted_tree_equals_jax_exactly(arch):
    jcfg = ARCHS[arch]
    sd, params, stats = reference_sd(jcfg)
    jp, js, jr = jimport.convert_state_dict(dict(sd), jcfg)
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    p, s, r = torch_import.convert_state_dict(tsd, port_cfg(jcfg))
    assert r == jr and r["unconsumed"] == []
    assert_trees_equal(p, jp)
    assert_trees_equal(s, js)
    assert_trees_equal(p, jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("arch", ["cg", "old_cg_confidence", "old_aa_confidence"])
def test_load_converted_is_strict(arch):
    """The tree loads into the port model of its config; an unconsumed
    reference key, a missing entry and an extra one each raise by name."""
    jcfg = ARCHS[arch]
    cfg = port_cfg(jcfg)
    sd, _, _ = reference_sd(jcfg)
    p, s, r = torch_import.convert_state_dict(sd, cfg)
    weights = load_converted(p, s, r, cfg)
    from diffdock_tpu_torch.utils.convert import build_model

    model = build_model(cfg)
    model.load_state_dict(weights, strict=True)
    sd2 = dict(sd, **{"bogus.weight": np.zeros(2, np.float32)})
    with pytest.raises(ValueError, match="bogus.weight"):
        load_converted(*torch_import.convert_state_dict(sd2, cfg), cfg)
    top = sorted(p)[0]
    with pytest.raises(ValueError, match="missing"):
        load_converted({k: v for k, v in p.items() if k != top}, s, r, cfg)
    with pytest.raises(ValueError, match="not in the model"):
        load_converted(dict(p, extra_layer={"bias": np.zeros(2, np.float32)}), s, r, cfg)


def test_aa_score_model_tree_has_no_port_model():
    """New-architecture all-atom trees convert exactly (above) and, since
    the port has ``AAScoreModel``, load into it strictly: every entry
    consumed, none missing or extra (the test's name predates the model)."""
    from diffdock_tpu_torch.models.aa_model import AAScoreModel
    from diffdock_tpu_torch.utils.convert import build_model

    jcfg = ARCHS["aa_confidence"]
    sd, _, _ = reference_sd(jcfg)
    cfg = port_cfg(jcfg)
    p, s, r = torch_import.convert_state_dict(sd, cfg)
    weights = load_converted(p, s, r, cfg)
    model = build_model(cfg)
    assert isinstance(model, AAScoreModel)
    model.load_state_dict(weights, strict=True)
    with pytest.raises(ValueError, match="missing"):
        load_converted({k: v for k, v in p.items() if k != "conv_0"}, s, r, cfg)


@pytest.mark.parametrize("case", ["old_cg", "old_aa"])
def test_permutations_equal_jax(case):
    from diffdock_tpu.ops.tensor_product import FullyConnectedTensorProduct as JFCTP

    sh1, sh2 = "1x0e + 1x1o", str(Irreps.spherical_harmonics(2))
    for a, sh, b in (("8x0e", sh2, "8x0e + 2x1o"), ("8x0e + 2x1o + 2x1e", sh2, "8x0e + 2x1o + 2x1e + 8x0o"),
                     ("8x0e + 2x1o", sh1, "2x1o + 8x0e"), ("8x0e + 2x1o + 2x1e + 8x0o", sh1,
                                                           "8x0e + 2x1o + 2x1e + 8x0o")):
        tp, jtp = FullyConnectedTensorProduct(a, sh, b), JFCTP(a, sh, b)
        np.testing.assert_array_equal(torch_import.tp_weight_permutation(tp),
                                      jimport.tp_weight_permutation(jtp))
        if sh == sh1:
            np.testing.assert_array_equal(torch_import.faster_weight_permutation(tp),
                                          jimport.faster_weight_permutation(jtp))


REFERENCE_ARGS = [
    # a new-architecture score run with ESM (DiffDock-L-like)
    dict(ns=48, nv=10, num_conv_layers=3, num_prot_emb_layers=3, sh_lmax=2, reduce_pseudoscalars=True,
         embed_also_ligand=True, max_radius=5.0, cross_max_distance=80.0, dynamic_max_cross=True,
         crop_beyond=20.0, embedding_type="sinusoidal", embedding_scale=1000, sigma_embed_dim=64,
         distance_embed_dim=64, cross_distance_embed_dim=64, esm_embeddings_path="data/esm2_output",
         dropout=0.1, tr_sigma_max=19.0, rot_sigma_max=1.55, not_fixed_center_conv=False,
         no_differentiate_convolutions=False, smooth_edges=True, tp_weights_layers=3),
    # an old score run without ESM, predating embedding_type
    dict(ns=24, nv=6, num_conv_layers=4, max_radius=5.0, cross_max_distance=250.0, dynamic_max_cross=True,
         no_batch_norm=False, dropout=0.1, scale_by_sigma=True, use_second_order_repr=False,
         esm_embeddings_path=None, crop_beyond=None),
    # the shipped old all-atom confidence run with ESM
    dict(ns=24, nv=6, num_conv_layers=5, all_atoms=True, esm_embeddings_path="data/esm2_3billion",
         rmsd_classification_cutoff=[2.0], atom_rmsd_classification_cutoff=[2.0],
         atom_confidence_loss_weight=0.0, confidence_dropout=0.1, confidence_no_batchnorm=False,
         embedding_type="sinusoidal", embedding_scale=1000, crop_beyond=20.0, use_old_atom_encoder=True),
    # a confidence run with several cutoffs and moad ESM paths
    dict(ns=16, nv=4, num_conv_layers=2, rmsd_classification_cutoff=[1.0, 2.0, 5.0],
         moad_esm_embeddings_path="x", pdbbind_esm_embeddings_path=None, affinity_prediction=True,
         sidechain_loss_weight=0.5, backbone_loss_weight=None, sh_lmax=1, odd_parity=True),
    # the bare minimum
    dict(),
    # an old run without the old atom encoder, with crop_beyond and a fixed center
    dict(ns=32, nv=8, num_conv_layers=3, use_old_atom_encoder=False, crop_beyond=15.0,
         not_fixed_center_conv=True, no_torsion=True, embedding_type="fourier"),
]


@pytest.mark.parametrize("i", range(len(REFERENCE_ARGS)))
@pytest.mark.parametrize("confidence_mode,old", [(False, False), (True, False), (False, True), (True, True)])
def test_config_from_reference_args_equals_jax(i, confidence_mode, old):
    args = REFERENCE_ARGS[i]
    ours = torch_import.config_from_reference_args(dict(args), confidence_mode=confidence_mode, old=old)
    ref = jimport.config_from_reference_args(dict(args), confidence_mode=confidence_mode, old=old)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


def test_simple_yaml_reads_a_reference_args_dump_as_pyyaml_does():
    """A reference ``model_parameters.yml`` is ``yaml.dump`` of argparse
    values: block lists, nulls, floats such as 0.001 and 1.0e-05, paths."""
    args = dict(REFERENCE_ARGS[0], lr=0.001, w_decay=1e-05, restart_lr=None, batch_size=16,
                log_dir="workdir/v1.1/score_model", run_name="big_score_model", cudnn_benchmark=True,
                rmsd_classification_cutoff=[2.0], split_train="data/splits/timesplit_no_lig_overlap_train",
                pdbbind_dir="data/PDBBind_processed/", ema_rate=0.999, limit_complexes=0,
                inference_steps=20, tr_weight=0.33, num_workers=1, atom_radius=5, test_sigma_intervals=True,
                sampling_alpha=1, sampling_beta=1, scheduler="plateau", scheduler_patience=30,
                train_multiplicity=1, remove_hs=True, receptor_radius=15.0, c_alpha_max_neighbors=24,
                matching_popsize=20, num_dataloader_workers=0, max_lig_size=1e9, cache_path="data/cache",
                not_full_dataset=False, triple_training=False, chain_cutoff=None)
    for text in (yaml.dump(args), yaml.safe_dump(args)):
        assert simple_yaml.load(text) == yaml.safe_load(text)
    # what is outside the subset raises, never reads otherwise
    for bad in ("a: yes\n", "a: 0x1F\n", "a: !!python/tuple [1, 2]\n", "a: {b: 1}\n"):
        with pytest.raises(simple_yaml.YAMLError):
            simple_yaml.load(bad)


def test_golden_fixture_through_the_port_conv_layer():
    """The e3nn golden fixture (``tests/fixtures/e3nn_golden.npz``, the
    reference layer's outputs): the port's TP conv layer, loaded from the
    fixture's ``sd_*`` entries through the port's importer, reproduces
    ``expected`` to 2e-4, the tolerance ``tests/test_e3nn_parity.py`` holds
    the JAX layer to."""
    from diffdock_tpu_torch.models.tpconv import NeighborBlock, TPConvLayer
    from diffdock_tpu_torch.utils.convert import state_dict_from_flax
    from tests.test_e3nn_parity import IN_IRREPS, OUT_IRREPS, SH_IRREPS

    z = np.load(FIXTURE)
    sd = {k[3:]: z[k] for k in z.files if k.startswith("sd_")}
    tp = FullyConnectedTensorProduct(IN_IRREPS, SH_IRREPS, OUT_IRREPS)
    fc = torch_import._convert_fc(sd, "fc", tp, 2)
    bn, bn_stats = torch_import._convert_bn(sd, "batch_norm")
    assert not sd
    node_attr, edge_attr, edge_sh = z["node_attr"], z["edge_attr"], z["edge_sh"]
    n, K = node_attr.shape[0], int(z["K"])
    ea = np.zeros((n * K, edge_attr.shape[-1]), np.float32)
    es = np.zeros((n * K, edge_sh.shape[-1]), np.float32)
    ea[z["order"]], es[z["order"]] = edge_attr, edge_sh
    layer = TPConvLayer(IN_IRREPS, SH_IRREPS, OUT_IRREPS, edge_attr.shape[-1], residual=False,
                        batch_norm=True)
    layer.load_state_dict(state_dict_from_flax(
        {"params": {"fc": fc, "bn": bn}, "batch_stats": {"bn": bn_stats}}, ScoreModelConfig()), strict=True)
    layer.eval()
    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt)[None]  # noqa: E731
    block = NeighborBlock(sender_attr=t(node_attr), nbr_idx=t(z["nbr"], torch.int64),
                          nbr_mask=t(z["msk"], torch.bool), edge_attr=t(ea.reshape(n, K, -1)),
                          edge_sh=t(es.reshape(n, K, -1)))
    with torch.no_grad():
        got = layer(None, [block], torch.ones((1, n), dtype=torch.bool))[0].numpy()
    np.testing.assert_allclose(got, z["expected"], atol=2e-4)
