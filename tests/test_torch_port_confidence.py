"""The port's old-family confidence models and the all-atom complex vs the
JAX package on the CPU.

Flax parameters from the JAX models' ``init`` (perturbed so biases and
batch-norm statistics are off their trivial values) go through
``state_dict_from_flax``; the same numpy complexes go through both
packages. Confidences pass through ~10-20 layers: float32 reordering keeps
them within 1e-4 relative. The whole confidence-ranked dock is in
``tests/test_torch_port_confidence_dock.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdock_tpu.data import complexes as j_complexes
from diffdock_tpu.diffusion.so3 import SO3Config as JSO3Config, get_so3_tables as j_so3
from diffdock_tpu.diffusion.torus import TorusConfig as JTorusConfig, get_torus_tables as j_torus
from diffdock_tpu.inference.pipeline import _round_up as j_round_up
from diffdock_tpu.models.config import ScoreModelConfig as JScoreModelConfig
from diffdock_tpu.models.factory import build_model as j_build_model
from diffdock_tpu_torch.data.complexes import (
    atom_bucket,
    bucket_sizes,
    pad_aa_to,
    synthetic_aa_complex,
    to_device,
)
from diffdock_tpu_torch.diffusion.so3 import SO3Config, get_so3_tables
from diffdock_tpu_torch.diffusion.torus import TorusConfig, get_torus_tables
from diffdock_tpu_torch.inference.pipeline import DockingPipeline, auto_confidence_chunk
from diffdock_tpu_torch.models.config import ConfigError, ScoreModelConfig
from diffdock_tpu_torch.models.old_models import (
    OldAAScoreModel,
    OldCGScoreModel,
    build_confidence_model,
    confidence_launches,
)
from diffdock_tpu_torch.ops import fused_tp3 as ft
from diffdock_tpu_torch.utils.convert import state_dict_from_flax

SO3_SMALL = dict(n_eps=64, x_n=256, l_max=512)
TORUS_SMALL = dict(x_n=256, sigma_n=128, mc_samples=2000)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tables():
    return (j_so3(JSO3Config(**SO3_SMALL)), j_torus(JTorusConfig(**TORUS_SMALL)),
            get_so3_tables(SO3Config(**SO3_SMALL), "cpu"), get_torus_tables(TorusConfig(**TORUS_SMALL), "cpu"))


def _conf_kw(all_atoms, lm_dim, layers, **extra):
    return dict(ns=8, nv=2, num_conv_layers=layers, confidence_mode=True, old_architecture=True,
                all_atoms=all_atoms, lm_embedding_dim=lm_dim, **extra)


def _perturbed(variables, seed, weights=True):
    """Biases and batch-norm statistics (and, with ``weights``, every other
    parameter) off their init values; variances stay positive."""
    rng = np.random.RandomState(seed)

    def perturb(path, p):
        name = jax.tree_util.keystr(path)
        if "var" in name:
            return np.asarray(p) + 0.1 * np.abs(rng.randn(*p.shape)).astype(np.float32)
        if weights or "bias" in name or "mean" in name:
            return np.asarray(p) + 0.1 * rng.randn(*p.shape).astype(np.float32)
        return np.asarray(p)

    return jax.tree_util.tree_map_with_path(perturb, variables)


def _init_confidence(jcfg, jdata, js, jt, seed):
    model = j_build_model(jcfg)
    pos = jdata.base.lig_pos if jcfg.all_atoms else jdata.lig_pos
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), jdata, pos, jnp.asarray(0.0), js, jt)
    return model, _perturbed(params, seed)


def test_aa_complex_padding_and_atom_bucket_are_the_same():
    for kw, sizes in ((dict(n_lig=10, n_rec=12, n_bonds=2, atoms_per_res=3), None),
                      (dict(n_lig=17, n_rec=70, n_bonds=5, atoms_per_res=4, lm_dim=3, k_atom=5),
                       dict(ka=8, ar=6))):
        ours = synthetic_aa_complex(np.random.RandomState(7), **kw)
        ref = j_complexes.synthetic_aa_complex(np.random.RandomState(7), **kw)
        for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(ref)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        nl, nr, nb = bucket_sizes(ours.base.n_lig, ours.base.n_rec, ours.base.n_bonds)
        na = atom_bucket(ours.n_atoms)
        assert na == max(j_round_up(ref.n_atoms, 256), 256)
        padded = pad_aa_to(ours, nl, nr, nb, na, **(sizes or {}))
        jpadded = j_complexes.pad_aa_to(ref, nl, nr, nb, na, **(sizes or {}))
        for a, b in zip(jax.tree.leaves(padded), jax.tree.leaves(jpadded)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert [atom_bucket(n) for n in (1, 256, 257, 2560)] == [256, 256, 512, 2560]


@pytest.mark.parametrize("all_atoms,lm_dim,layers,dynamic", [
    (True, 6, 3, True), (True, 0, 2, False), (False, 6, 3, False), (False, 0, 2, True)])
def test_old_confidence_model_matches_jax(tables, all_atoms, lm_dim, layers, dynamic):
    js, jt, _, _ = tables
    kw = _conf_kw(all_atoms, lm_dim, layers, dynamic_max_cross=dynamic)
    jcfg, cfg = JScoreModelConfig(**kw), ScoreModelConfig(**kw)
    aa = synthetic_aa_complex(np.random.RandomState(0), n_lig=10, n_rec=12, n_bonds=2,
                              atoms_per_res=3, lm_dim=lm_dim)
    aa = pad_aa_to(aa, 16, 32, 4, 64)  # padded atoms, residues, atoms of residues
    data = aa if all_atoms else aa.base
    jdata = jax.tree.map(jnp.asarray, data)
    jmodel, params = _init_confidence(jcfg, jdata, js, jt, seed=layers)

    model = build_confidence_model(cfg)
    assert isinstance(model, OldAAScoreModel if all_atoms else OldCGScoreModel)
    model.load_state_dict(state_dict_from_flax(params, cfg), strict=True)
    model.eval()
    lig_pos = np.asarray(aa.base.lig_pos)
    poses = (lig_pos[None] + np.random.RandomState(1).randn(3, 16, 3) * 2.0).astype(np.float32)
    before = ft.counts.as_dict()
    with torch.no_grad():
        out = model(to_device(data, "cpu"), torch.from_numpy(poses), 0.0)
    after = ft.counts.as_dict()
    assert after["fused_tp3"] == before["fused_tp3"]
    assert after["fused_tp3_reference"] - before["fused_tp3_reference"] == confidence_launches(cfg)
    ref = jax.jit(jax.vmap(lambda p, q: jmodel.apply(p, jdata, q, jnp.asarray(0.0), js, jt),
                           in_axes=(None, 0)))(params, jnp.asarray(poses))
    assert out.shape == ref.shape == (3, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_confidence_chunks_do_not_change_results(tables):
    _, _, ps, pt = tables
    cfg = ScoreModelConfig(**_conf_kw(True, 0, 2))
    aa = to_device(pad_aa_to(synthetic_aa_complex(np.random.RandomState(3), n_lig=9, n_rec=10,
                                                  n_bonds=2, atoms_per_res=3), 16, 64, 8, 256), "cpu")
    poses = aa.base.lig_pos[None] + torch.from_numpy(
        np.random.RandomState(4).randn(5, 16, 3).astype(np.float32))
    runs = []
    for chunk in (None, 1, 2, 5):
        pipe = DockingPipeline(ScoreModelConfig(ns=8, nv=2, num_conv_layers=2), 0,
                               so3_tables=ps, torus_tables=pt, device="cpu",
                               confidence_cfg=cfg, confidence_weights=5, confidence_chunk=chunk)
        runs.append(pipe.confidence(aa, poses).numpy())
    for r in runs[1:]:
        np.testing.assert_allclose(r, runs[0], rtol=1e-6, atol=1e-6)
    assert auto_confidence_chunk(16, 256, 5) == 5
    assert auto_confidence_chunk(128, 18432, 40) < 40
    assert auto_confidence_chunk(10_000, 10_000_000, 40) == 1


def test_unported_confidence_configurations_are_refused():
    # old_architecture=False builds the new all-atom model
    # (tests/test_torch_port_confidence_head.py); atom_confidence is refused
    # by the pipeline alone, as the JAX pipeline fails on its outputs
    from diffdock_tpu_torch.models.aa_model import AAScoreModel

    new = dataclasses.replace(ScoreModelConfig(**_conf_kw(True, 0, 2)), old_architecture=False)
    assert isinstance(build_confidence_model(new), AAScoreModel)
    with pytest.raises(ConfigError, match="atom_confidence"):
        DockingPipeline(ScoreModelConfig(ns=8, nv=2), 0, device="cpu",
                        confidence_cfg=dataclasses.replace(new, atom_confidence=True),
                        confidence_weights=0, so3_tables=object(), torus_tables=object())
    # what stays refused: a confidence model needs confidence_mode, odd_parity
    # as the JAX package refuses it on the old family, and float16
    for kw in (dict(confidence_mode=False), dict(odd_parity=True), dict(compute_dtype="float16")):
        cfg = dataclasses.replace(ScoreModelConfig(**_conf_kw(True, 0, 2)), **kw)
        with pytest.raises(ConfigError):
            build_confidence_model(cfg)
        with pytest.raises(ConfigError):
            DockingPipeline(ScoreModelConfig(ns=8, nv=2), 0, device="cpu", confidence_cfg=cfg,
                            confidence_weights=0, so3_tables=object(), torus_tables=object())
    # the affinity column and the new encoder are ported
    # (tests/test_torch_port_old_score.py)
    for kw in (dict(affinity_prediction=True), dict(use_old_atom_encoder=False)):
        cfg = dataclasses.replace(ScoreModelConfig(**_conf_kw(True, 0, 2)), **kw)
        assert isinstance(build_confidence_model(cfg), OldAAScoreModel)
    with pytest.raises(ConfigError):
        OldAAScoreModel(ScoreModelConfig(**_conf_kw(False, 0, 2)))
    # bfloat16 is ported (tests/test_torch_port_bf16.py): every conv takes it
    bf = build_confidence_model(dataclasses.replace(ScoreModelConfig(**_conf_kw(True, 0, 2)),
                                                    compute_dtype="bfloat16"))
    assert {m.dtype for m in bf.conv_layers} == {"bfloat16"}
    # crop_beyond is ported (tests/test_torch_port_crop.py)
    build_confidence_model(dataclasses.replace(ScoreModelConfig(**_conf_kw(True, 0, 2)), crop_beyond=20.0))
