"""The sidechain head and the auxiliary backbone/sidechain losses of the
port against the JAX package on the CPU.

The coarse-grained model with ``sidechain_pred`` gives, besides its scores,
per-residue [4 chi, N-CA, C-CA] predictions from the final receptor
features (the head's even and odd halves summed); one float32 train step
with ``backbone_weight`` and ``sidechain_weight`` then matches JAX's
``make_train_step`` on a batch whose ``rec_scv`` targets carry NaN chis and
vectors, in ``tests/test_torch_port_train_step.py``'s manner: the loss and
every metric (the two auxiliary losses among them), every gradient leaf
(the head's too), the params, Adam's moments, the EMA and the batch stats,
at that file's tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdock_tpu.data import complexes as j_complexes
from diffdock_tpu.train import trainer as jtrainer
from diffdock_tpu_torch.data.complexes import pad_to, synthetic_complex, to_device
from diffdock_tpu_torch.models.score_model import CGScoreModel
from diffdock_tpu_torch.train import trainer
from diffdock_tpu_torch.utils.convert import state_dict_from_flax
from tests.test_torch_port_model import _init_params
from tests.test_torch_port_train_parts import synthetic_batch, tables  # noqa: F401
from tests.test_torch_port_train_step import (
    GRAD_RTOL,
    LM,
    LR,
    METRIC_RTOL,
    N,
    compare_states,
    configs,
    flat,
    port_tree,
    assert_leaves_close,
    step_draws,
)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs():
    return tuple(dataclasses.replace(c, sidechain_pred=True) for c in configs())


def test_sidechain_head_matches_jax(tables):
    js, jt, ps, pt = tables
    jcfg, cfg = (dataclasses.replace(c, bn_axis_names=()) for c in _configs())
    data = pad_to(synthetic_complex(np.random.RandomState(0), n_lig=10, n_rec=20, n_bonds=3, lm_dim=LM),
                  16, 32, 4)
    jdata = j_complexes.ComplexData(*[None if a is None else jnp.asarray(a) for a in data])
    jmodel, params = _init_params(jcfg, jdata, js, jt, seed=5)
    assert "sidechain_predictor" in params["params"]
    model = CGScoreModel(cfg)
    model.load_state_dict(state_dict_from_flax(params, cfg), strict=True)
    model.eval()
    poses = (data.lig_pos[None] + np.random.RandomState(1).randn(2, 16, 3) * 0.5).astype(np.float32)
    ref = jax.jit(jax.vmap(lambda p, q: jmodel.apply(p, jdata, q, jnp.asarray(0.6), js, jt),
                           in_axes=(None, 0)))(params, jnp.asarray(poses))
    tdata = to_device(data, "cpu")
    with torch.no_grad():
        cache = model.embed_receptor(tdata)
        out = model(tdata, torch.from_numpy(poses), torch.tensor(0.6), ps, pt, rec_cache=cache,
                    step_cache=model.step_cache(tdata, torch.tensor(0.6), cache))
    assert out.sidechain.shape == ref.sidechain.shape == (2, 32, 10)
    for name in ("tr", "rot", "tor", "sidechain"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    # the confidence mode and the other families build no head
    assert not hasattr(CGScoreModel(dataclasses.replace(cfg, confidence_mode=True)), "sidechain_predictor")


def test_train_step_with_sidechain_losses_matches_jax(tables):
    js, jt, ps, pt = tables
    tc = trainer.TrainConfig(lr=LR, backbone_weight=0.5, sidechain_weight=0.7)
    jtc = jtrainer.TrainConfig(lr=LR, backbone_weight=0.5, sidechain_weight=0.7)
    jcfg, cfg = _configs()
    batch = synthetic_batch(2, lm_dim=LM)
    rng = np.random.RandomState(3)
    scv = rng.randn(*batch.rec_mask.shape, 10).astype(np.float32)
    scv[rng.rand(*scv.shape) < 0.2] = np.nan  # undefined chis and vectors
    batch = batch._replace(rec_scv=scv)
    example = jax.tree.map(lambda a: None if a is None else jnp.asarray(a[0]), j_complexes.ComplexData(*batch))
    jmodel, variables = _init_params(jcfg, example, js, jt, seed=2)
    params = variables["params"]
    jstate = jtrainer.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=variables["batch_stats"],
        opt_state=jtrainer.make_optimizer(jtc).init(params), ema_params=params)
    model = CGScoreModel(cfg)
    model.load_state_dict(state_dict_from_flax(variables, cfg), strict=True)
    state = trainer.create_train_state(model, tc)

    key = jax.random.PRNGKey(13)
    jbatch = jax.tree.map(jnp.asarray, j_complexes.ComplexData(*batch))
    jnew, jmetrics = jax.jit(jtrainer.make_train_step(jmodel, jtc, js, jt))(jstate, jbatch, key)
    state, metrics = trainer.make_train_step(model, tc, ps, pt)(state, to_device(batch, "cpu"),
                                                                step_draws(key, 0, batch))
    assert {"backbone_loss", "sidechain_loss"} <= set(metrics) and set(metrics) == set(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(metrics[k].numpy(), N(jmetrics[k]), rtol=METRIC_RTOL, err_msg=k)
    assert float(metrics["backbone_loss"]) > 0 and float(metrics["sidechain_loss"]) > 0
    adam = jnew.opt_state[0][0]
    grads_ref = {k: v / 0.1 for k, v in flat(adam.mu)}  # mu = (1 - b1) g after one step
    grads = port_tree(model, state.grads)
    assert np.abs(grads["sidechain_predictor/w_0"]).max() > 0
    assert_leaves_close(grads, grads_ref, GRAD_RTOL, "grad")
    compare_states(model, state, jnew, LR, grads_ref)
    # the eval step leaves the auxiliary losses out, as JAX's does
    ev = trainer.make_eval_step(model, tc, ps, pt)(state, to_device(batch, "cpu"), step_draws(key, 1, batch))
    assert "backbone_loss" not in ev
