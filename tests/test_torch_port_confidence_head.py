"""The new-architecture confidence models of the port (the coarse-grained
model's confidence head and the all-atom ``AAScoreModel``) vs the JAX
package on the CPU, in evaluation and in training mode.

Flax parameters from the JAX models' ``init``, perturbed off their init
values, go through ``state_dict_from_flax``; the same numpy complexes go
through both packages. Evaluation: P poses of one complex (the JAX model
``vmap``ped over them). Training: a stacked batch of complexes with one
pose each against the JAX forward ``vmap``ped with the named axis
``batch`` (``bn_axis_names=("batch",)``), outputs and the new batch
statistics. Confidences pass through ~10-20 layers: float32 reordering
keeps them within 1e-4 (the tolerance of ``test_torch_port_confidence.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdock_tpu.models.config import ScoreModelConfig as JScoreModelConfig
from diffdock_tpu.models.factory import build_model as j_build_model
from diffdock_tpu_torch.data.complexes import pad_aa_to, pad_to, synthetic_aa_complex, synthetic_complex
from diffdock_tpu_torch.data.complexes import to_device
from diffdock_tpu_torch.data.loaders import stack_padded
from diffdock_tpu_torch.models.aa_model import AAScoreModel
from diffdock_tpu_torch.models.config import ScoreModelConfig
from diffdock_tpu_torch.models.factory import build_model
from diffdock_tpu_torch.models.old_models import build_confidence_model, confidence_launches
from diffdock_tpu_torch.models.score_model import CGScoreModel, ScoreOutput
from diffdock_tpu_torch.ops import fused_tp3 as ft
from diffdock_tpu_torch.utils.convert import flax_from_model, state_dict_from_flax
from tests.test_torch_port_confidence import _one_thread, _perturbed, tables  # noqa: F401

RTOL = ATOL = 1e-4
N_POSES = 3
BATCH = 3
# (nl, nr, nb) of the padded complexes and the all-atom extras (na, ka, ar)
BUCKET = (16, 32, 4)
AA_BUCKET = dict(na=96, ka=8, ar=4)


def _configs(**kw):
    base = dict(ns=8, nv=2, confidence_mode=True)
    base.update(kw)
    return JScoreModelConfig(**base), ScoreModelConfig(**base)


def _complexes(all_atoms: bool, n: int, lm_dim: int, seed: int = 0):
    """``n`` padded numpy complexes of one bucket (the all-atom tree with
    ``all_atoms``), sizes differing."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        kw = dict(n_lig=10 + 2 * i, n_rec=12 + 4 * i, n_bonds=1 + i % 3, lm_dim=lm_dim)
        if all_atoms:
            aa = synthetic_aa_complex(rng, atoms_per_res=3, **kw)
            out.append(pad_aa_to(aa, *BUCKET, **AA_BUCKET))
        else:
            out.append(pad_to(synthetic_complex(rng, **kw), *BUCKET))
    return out


def _base(d):
    return d.base if hasattr(d, "base") else d


def _poses(d, n, seed):
    lig = np.asarray(_base(d).lig_pos)
    return (lig[None] + np.random.RandomState(seed).randn(n, *lig.shape) * 2.0).astype(np.float32)


def _pair(jcfg, cfg, data, tables, seed=1):
    """(JAX model, variables, port model with the same weights): the port
    model's random weights perturbed off their init values (biases and
    batch-norm statistics too), as the flax tree both take. The tree's
    names and shapes are those of the JAX model's ``init`` (traced with
    ``jax.eval_shape``, not compiled)."""
    js, jt, _, _ = tables
    jmodel = j_build_model(jcfg)
    jdata = jax.tree.map(jnp.asarray, data)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jdata, _base(jdata).lig_pos,
                            jnp.asarray(0.0), js, jt)
    model = build_model(cfg)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    variables = _perturbed(flax_from_model(model), seed)
    ref = {k: v.shape for k, v in _flat(jax.tree.map(lambda x: np.zeros(x.shape), shapes))}
    ours = {k: v.shape for k, v in _flat(variables)}
    assert ours == ref, set(ours) ^ set(ref)
    model.load_state_dict(state_dict_from_flax(variables, cfg), strict=True)
    return jmodel, variables, model


def _jax_eval(jmodel, variables, data, poses, t, tables):
    js, jt, _, _ = tables
    jdata = jax.tree.map(jnp.asarray, data)
    return jax.jit(jax.vmap(lambda q: jmodel.apply(variables, jdata, q, jnp.asarray(t), js, jt)))(
        jnp.asarray(poses))


def _jax_train(jmodel, variables, batch, poses, tables):
    """The JAX forward over a stacked batch in training mode, batch norms
    over the named axis: (outputs, new batch_stats)."""
    js, jt, _, _ = tables

    def one(d, q):
        out, mut = jmodel.apply(variables, d, q, jnp.asarray(0.0), js, jt, train=True,
                                mutable=["batch_stats"])
        return out, mut["batch_stats"]

    out, stats = jax.jit(jax.vmap(one, axis_name="batch"))(jax.tree.map(jnp.asarray, batch),
                                                           jnp.asarray(poses))
    return out, jax.tree.map(lambda x: np.asarray(x[0]), stats)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def _close(ours, ref):
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=ATOL)


def _check_train_mode(jmodel, variables, model, cfg, lm_dim, seed, tables):
    """One stacked batch of BATCH complexes, one pose each, in training
    mode: the outputs and the new running statistics against JAX's."""
    datas = _complexes(cfg.all_atoms, BATCH, lm_dim, seed=seed)
    batch = stack_padded(datas)
    poses = np.stack([_poses(d, 1, 10 + i)[0] for i, d in enumerate(datas)])
    ref, ref_stats = _jax_train(jmodel, variables, batch, poses, tables)
    model.train()
    out = model(to_device(batch, "cpu"), torch.from_numpy(poses), torch.zeros(BATCH))
    model.eval()
    _close(jax.tree.map(lambda x: x.detach(), out), ref)
    ours = dict(_flat(flax_from_model(model)["batch_stats"]))
    ref_stats = dict(_flat(ref_stats))
    assert set(ours) == set(ref_stats)
    for k, v in ref_stats.items():
        np.testing.assert_allclose(ours[k], v, rtol=RTOL, atol=1e-5, err_msg=k)


CG_CASES = {
    "2_layers": dict(num_prot_emb_layers=0, num_conv_layers=2),
    # 3 layers: the head reads the ladder's last block (nv x0o here)
    "3_layers_reduce_ps_3_outputs_affinity": dict(
        num_prot_emb_layers=1, num_conv_layers=2, reduce_pseudoscalars=True, num_confidence_outputs=3,
        dynamic_max_cross=True, affinity_prediction=True),
    "3_layers_lm_atom_confidence": dict(num_prot_emb_layers=0, num_conv_layers=3, lm_embedding_dim=6,
                                        atom_confidence=True, atom_num_confidence_outputs=2),
    "no_batchnorm_3_outputs": dict(num_prot_emb_layers=1, num_conv_layers=2, confidence_no_batchnorm=True,
                                   num_confidence_outputs=3),
}


@pytest.mark.parametrize("case", sorted(CG_CASES))
def test_cg_confidence_matches_jax(tables, case):
    """Evaluation (P poses of one complex, the receptor embedding cached
    and inline) and training mode (a stacked batch: the batch norms take
    their statistics over the batch, the head's over its B pooled rows)."""
    kw = CG_CASES[case]
    lm = kw.get("lm_embedding_dim", 0)
    jcfg, cfg = _configs(**kw, bn_axis_names=("batch",))
    data = _complexes(False, 1, lm)[0]
    jmodel, variables, model = _pair(jcfg, cfg, data, tables)
    assert isinstance(model, CGScoreModel) and isinstance(build_confidence_model(cfg), CGScoreModel)
    poses = _poses(data, N_POSES, 2)
    ref = _jax_eval(jmodel, variables, data, poses, 0.0, tables)
    tdata = to_device(data, "cpu")
    before = ft.counts.as_dict()
    with torch.no_grad():
        cache = model.embed_receptor(tdata)
        mid = ft.counts.as_dict()
        out = model(tdata, torch.from_numpy(poses), 0.0, rec_cache=cache)
        inline = model(tdata, torch.from_numpy(poses), 0.0)
    after = ft.counts.as_dict()
    assert mid["fused_tp3_reference"] - before["fused_tp3_reference"] == confidence_launches(cfg, embed=True)
    assert (after["fused_tp3_reference"] - mid["fused_tp3_reference"]
            == 2 * confidence_launches(cfg) + confidence_launches(cfg, embed=True))
    assert after["fused_tp3"] == before["fused_tp3"]
    n_out = cfg.num_confidence_outputs + (cfg.ns if cfg.affinity_prediction else 0)
    if cfg.atom_confidence:
        assert out[0].shape == (N_POSES, n_out) and out[1].shape == (N_POSES, BUCKET[0], 2)
    else:
        assert out.shape == (N_POSES, n_out)
    _close(out, ref)
    _close(inline, ref)
    if cfg.affinity_prediction:
        feats = np.asarray(ref)[:, cfg.num_confidence_outputs:]
        jaff = jmodel.apply(variables, jnp.asarray(feats), method="predict_affinity")
        with torch.no_grad():
            aff = model.predict_affinity(out[:, cfg.num_confidence_outputs:])
        assert aff.shape == ()
        np.testing.assert_allclose(aff.item(), float(jaff), rtol=RTOL, atol=ATOL)
    _check_train_mode(jmodel, variables, model, cfg, lm, 3, tables)


AA_CASES = {
    "confidence": dict(num_prot_emb_layers=1, num_conv_layers=2),
    "confidence_3_layers_lm": dict(num_prot_emb_layers=0, num_conv_layers=3, lm_embedding_dim=6,
                                   dynamic_max_cross=True, num_confidence_outputs=3),
    "score": dict(num_prot_emb_layers=1, num_conv_layers=2, confidence_mode=False),
}


@pytest.mark.parametrize("case", sorted(AA_CASES))
def test_aa_model_matches_jax(tables, case):
    """Both modes of the all-atom model in evaluation (the protein
    embedding cached), and the confidence mode in training mode."""
    kw = dict(AA_CASES[case], all_atoms=True)
    lm = kw.get("lm_embedding_dim", 0)
    jcfg, cfg = _configs(**kw, bn_axis_names=("batch",))
    data = _complexes(True, 1, lm, seed=5)[0]
    jmodel, variables, model = _pair(jcfg, cfg, data, tables)
    assert isinstance(model, AAScoreModel)
    poses = _poses(data, N_POSES, 4)
    _, _, ps, pt = tables
    t = 0.0 if cfg.confidence_mode else 0.4
    ref = _jax_eval(jmodel, variables, data, poses, t, tables)
    tdata = to_device(data, "cpu")
    before = ft.counts.as_dict()
    with torch.no_grad():
        cache = model.embed_receptor(tdata)
        out = model(tdata, torch.from_numpy(poses), t, ps, pt, rec_cache=cache)
    launches = ft.counts["fused_tp3_reference"] - before["fused_tp3_reference"]
    if not cfg.confidence_mode:
        assert isinstance(out, ScoreOutput)
        _close((out.tr, out.rot, out.tor), (ref.tr, ref.rot, ref.tor))
        return
    assert launches == confidence_launches(cfg) + confidence_launches(cfg, embed=True)
    assert out.shape == (N_POSES, cfg.num_confidence_outputs)
    _close(out, ref)
    _check_train_mode(jmodel, variables, model, cfg, lm, 6, tables)


@pytest.mark.parametrize("arch", ["cg_atom_affinity", "aa"])
def test_converter_round_trips_new_confidence_trees(tables, arch):
    """The flax tree of JAX's ``init`` -> ``state_dict`` -> the flax tree
    again, leaf for leaf (the confidence heads and the all-atom layers'
    FC groups and joint norms included)."""
    extra = (dict(atom_confidence=True, affinity_prediction=True, num_prot_emb_layers=1)
             if arch == "cg_atom_affinity" else dict(all_atoms=True, num_prot_emb_layers=1))
    jcfg, cfg = _configs(num_conv_layers=2, **extra)
    js, jt, _, _ = tables
    data = jax.tree.map(jnp.asarray, _complexes(cfg.all_atoms, 1, 0)[0])
    variables = _perturbed(jax.jit(j_build_model(jcfg).init)(
        jax.random.PRNGKey(0), data, _base(data).lig_pos, jnp.asarray(0.0), js, jt), 0)
    model = build_model(cfg)
    model.load_state_dict(state_dict_from_flax(variables, cfg), strict=True)
    back = flax_from_model(model)
    for coll in ("params", "batch_stats"):
        ref = dict(_flat(jax.tree.map(np.asarray, variables[coll])))
        ours = dict(_flat(back[coll]))
        assert set(ours) == set(ref), set(ours) ^ set(ref)
        for k in ref:
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    names = {k.split("/")[0] for k, _ in _flat(back["params"])}
    if arch == "cg_atom_affinity":
        assert {"confidence_predictor", "atom_confidence_predictor", "affinity_predictor"} <= names
    else:
        assert "conv_1" in names and "cross_edge_embedding" not in names


def test_confidence_model_builds_and_refuses():
    """The factory's four-way dispatch; what stays refused."""
    from diffdock_tpu_torch.models.config import ConfigError
    from diffdock_tpu_torch.models.old_models import OldAAScoreModel, OldCGScoreModel

    kw = dict(ns=8, nv=2, num_conv_layers=2)
    for extra, cls in ((dict(), CGScoreModel), (dict(all_atoms=True), AAScoreModel),
                       (dict(old_architecture=True, confidence_mode=True), OldCGScoreModel),
                       (dict(old_architecture=True, confidence_mode=True, all_atoms=True), OldAAScoreModel)):
        assert type(build_model(ScoreModelConfig(**kw, **extra))) is cls
    with pytest.raises(ConfigError):
        build_confidence_model(ScoreModelConfig(**kw))
    with pytest.raises(ConfigError):
        CGScoreModel(ScoreModelConfig(**kw, all_atoms=True))
    with pytest.raises(ConfigError):
        AAScoreModel(ScoreModelConfig(**kw))
    with pytest.raises(ConfigError):
        AAScoreModel(ScoreModelConfig(**kw, all_atoms=True, smooth_edges=True))
    cfg = dataclasses.replace(ScoreModelConfig(**kw), confidence_mode=True)
    assert not hasattr(build_model(cfg), "final_conv")
