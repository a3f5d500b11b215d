"""The trainer's receptor crop under ``crop_beyond`` vs the JAX package's on
the CPU, and ``pocket_crop_complex``.

The JAX train step crops each complex's receptor to the residues within
``3 tr_sigma(t) + crop_beyond`` of a ligand atom of its noised pose
(``diffdock_tpu/train/trainer.py:191-205``) and passes the mask to the
model as ``rec_keep``; its eval step does not crop. One float32 step of the
port with ``crop_beyond`` is held to JAX's ``make_train_step`` leaf by
leaf, with JAX's own draws injected, at the tolerances of
``tests/test_torch_port_train_step.py``; the model and batch are that
test's, with ``tr_sigma_max`` 3 and ``crop_beyond`` 2 A so that the crop
drops residues of every complex.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdock_tpu.data import complexes as j_complexes
from diffdock_tpu.data import featurize as jfeaturize
from diffdock_tpu.data.chem import read_molecule_file as j_read_molecule_file
from diffdock_tpu.data.chem import read_pdb_file as j_read_pdb_file
from diffdock_tpu.diffusion.schedules import SigmaConfig as JSigmaConfig
from diffdock_tpu.models.config import ScoreModelConfig as JScoreModelConfig
from diffdock_tpu.train import trainer as jtrainer
from diffdock_tpu_torch.data import featurize
from diffdock_tpu_torch.data.chem import read_molecule_file, read_pdb_file
from diffdock_tpu_torch.data.complexes import to_device
from diffdock_tpu_torch.diffusion.schedules import SigmaConfig
from diffdock_tpu_torch.models.config import ScoreModelConfig
from diffdock_tpu_torch.models.score_model import CGScoreModel
from diffdock_tpu_torch.train import trainer
from diffdock_tpu_torch.train.noise import apply_noise
from diffdock_tpu_torch.utils.convert import state_dict_from_flax
from tests.test_torch_port_datasets import SYNTH
from tests.test_torch_port_model import _init_params
from tests.test_torch_port_moad import _same
from tests.test_torch_port_train_parts import draws_from_keys, synthetic_batch, tables  # noqa: F401
from tests.test_torch_port_train_step import (
    GRAD_RTOL, LM, LR, METRIC_RTOL, MODEL_KW, assert_leaves_close, compare_states, flat, port_tree,
    step_draws,
)

CROP = 2.0
N = lambda a: np.asarray(a)  # noqa: E731


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def crop_pair(tables, jtc, tc, crop=CROP, seed: int = 0):
    """(JAX model, JAX state, port model, port state, numpy batch) with
    ``crop_beyond`` = ``crop`` from the same perturbed parameters."""
    js, jt, _, _ = tables
    kw = dict(MODEL_KW, crop_beyond=crop)
    jcfg = JScoreModelConfig(**kw, sigma=JSigmaConfig(tr_sigma_max=3.0))
    cfg = ScoreModelConfig(**kw, sigma=SigmaConfig(tr_sigma_max=3.0))
    batch = synthetic_batch(seed, lm_dim=LM)
    example = jax.tree.map(lambda a: None if a is None else jnp.asarray(a[0]),
                           j_complexes.ComplexData(*batch))
    jmodel, variables = _init_params(jcfg, example, js, jt, seed=seed)
    params = variables["params"]
    jstate = jtrainer.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=variables["batch_stats"],
        opt_state=jtrainer.make_optimizer(jtc).init(params), ema_params=params)
    model = CGScoreModel(cfg)
    model.load_state_dict(state_dict_from_flax(variables, cfg), strict=True)
    return jmodel, jstate, model, trainer.create_train_state(model, tc), batch


def test_one_cropped_train_step_matches_jax(tables):
    js, jt, ps, pt = tables
    tc, jtc = trainer.TrainConfig(lr=LR), jtrainer.TrainConfig(lr=LR)
    jmodel, jstate, model, state, batch = crop_pair(tables, jtc, tc)
    rng = jax.random.PRNGKey(13)
    jbatch = jax.tree.map(jnp.asarray, j_complexes.ComplexData(*batch))
    jnew, jmetrics = jax.jit(jtrainer.make_train_step(jmodel, jtc, js, jt))(jstate, jbatch, rng)
    draws = step_draws(rng, 0, batch)
    tbatch = to_device(batch, "cpu")

    # the crop the step takes: the port's masks equal JAX's rec_keep_mask
    # on the same noised poses, and drop real residues of every complex
    sample = apply_noise(tbatch, draws, model.cfg.sigma, ps, pt, no_torsion=model.cfg.no_torsion)
    keep = trainer.train_rec_keep(model.cfg, tbatch, sample).numpy()
    for b in range(keep.shape[0]):
        sig, t = model.cfg.sigma, sample.t[b].numpy()
        tr_sigma = sig.tr_sigma_min ** (1.0 - t) * sig.tr_sigma_max ** t
        ref = j_complexes.rec_keep_mask(jnp.asarray(batch.rec_pos[b]), jnp.asarray(batch.rec_mask[b]),
                                        jnp.asarray(sample.pos[b].numpy())[None],
                                        jnp.asarray(batch.lig_mask[b]), 3.0 * tr_sigma + CROP)
        assert np.array_equal(keep[b], N(ref))
        assert 0 < keep[b].sum() < batch.rec_mask[b].sum()

    step = trainer.make_train_step(model, tc, ps, pt)
    state, metrics = step(state, tbatch, draws)
    assert set(metrics) == set(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(metrics[k].numpy(), N(jmetrics[k]), rtol=METRIC_RTOL, err_msg=k)
    grads_ref = {k: v / 0.1 for k, v in flat(jnew.opt_state[0][0].mu)}
    assert_leaves_close(port_tree(model, state.grads), grads_ref, GRAD_RTOL, "grad")
    compare_states(model, state, jnew, LR, grads_ref)

    # the crop matters: JAX's step without it gives another loss
    jm0, js0, _, _, _ = crop_pair(tables, jtc, tc, crop=None)
    _, jm_uncropped = jax.jit(jtrainer.make_train_step(jm0, jtc, js, jt))(js0, jbatch, rng)
    assert abs(float(jm_uncropped["loss"]) - float(metrics["loss"])) > 100 * METRIC_RTOL * float(metrics["loss"])


def test_eval_step_does_not_crop(tables):
    """JAX's eval step ignores ``crop_beyond``; so does the port's: its
    metrics with the crop config equal JAX's and equal its own without the
    crop."""
    js, jt, ps, pt = tables
    tc, jtc = trainer.TrainConfig(lr=LR), jtrainer.TrainConfig(lr=LR)
    jmodel, jstate, model, state, batch = crop_pair(tables, jtc, tc, seed=1)
    rng = jax.random.PRNGKey(12)
    jbatch = jax.tree.map(jnp.asarray, j_complexes.ComplexData(*batch))
    jm = jax.jit(jtrainer.make_eval_step(jmodel, jtc, js, jt))(jstate, jbatch, rng)
    draws = draws_from_keys(jax.random.split(rng, 3), batch.rot_u.shape[1])
    m = trainer.make_eval_step(model, tc, ps, pt)(state, to_device(batch, "cpu"), draws)
    for k in m:
        np.testing.assert_allclose(m[k].numpy(), N(jm[k]), rtol=METRIC_RTOL, err_msg=k)
    _, _, plain, plain_state, _ = crop_pair(tables, jtc, tc, crop=None, seed=1)
    m0 = trainer.make_eval_step(plain, tc, ps, pt)(plain_state, to_device(batch, "cpu"), draws)
    assert all(torch.equal(m[k], m0[k]) for k in m)


@pytest.mark.parametrize("name", ["syn001_l24r104", "syn006_l29r122"])
def test_pocket_crop_complex_equals_jax(name):
    mol = read_molecule_file(str(SYNTH / name / f"{name}_ligand.sdf"))
    prot = read_pdb_file(str(SYNTH / name / f"{name}_protein_processed.pdb"))
    jmol = j_read_molecule_file(str(SYNTH / name / f"{name}_ligand.sdf"))
    jprot = j_read_pdb_file(str(SYNTH / name / f"{name}_protein_processed.pdb"))
    data, _ = featurize.build_complex_data(mol, prot)
    jdata, _ = jfeaturize.build_complex_data(jmol, jprot)
    for capacity, k_rec in ((48, 10), (64, 6), (data.n_rec, 10), (data.n_rec + 5, 10)):
        ours = featurize.pocket_crop_complex(data, capacity, k_rec)
        ref = jfeaturize.pocket_crop_complex(jdata, capacity, k_rec)
        _same(ours, ref)
        assert ours.n_rec == min(capacity, data.n_rec)
    no_scv = featurize.pocket_crop_complex(data._replace(rec_scv=None), 48)
    assert no_scv.rec_scv is None and no_scv.n_rec == 48
