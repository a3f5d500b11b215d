"""One f32 train step of the port vs the JAX package's ``make_train_step``
on the CPU (the eval step is in ``test_torch_port_train_state.py``).

A small DiffDock-L-like model (``dynamic_max_cross``,
``reduce_pseudoscalars``, ``embed_also_ligand``, LM features, ns 8, nv 2,
2 joint layers, 1 protein-embedding layer) with JAX's ``init`` parameters
perturbed off their init values; a batch of 3 ``synthetic_complex``es
padded to one bucket; JAX's own draws rebuilt from the step's key and fed
to the port. Compared after the step: the loss and every metric, the
gradient of every leaf (JAX's through its first Adam moment, mu = 0.1 g),
the params, both Adam moments and the count, the EMA and the batch stats.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdock_tpu.data import complexes as j_complexes
from diffdock_tpu.diffusion.schedules import SigmaConfig as JSigmaConfig
from diffdock_tpu.models.config import ScoreModelConfig as JScoreModelConfig
from diffdock_tpu.train import trainer as jtrainer
from diffdock_tpu_torch.data.complexes import to_device
from diffdock_tpu_torch.diffusion.schedules import SigmaConfig
from diffdock_tpu_torch.models.config import ScoreModelConfig
from diffdock_tpu_torch.models.score_model import CGScoreModel
from diffdock_tpu_torch.train import trainer
from diffdock_tpu_torch.utils.convert import flax_from_model, state_dict_from_flax
from tests.test_torch_port_model import _init_params
from tests.test_torch_port_train_parts import draws_from_keys, synthetic_batch, tables  # noqa: F401

LM = 6
MODEL_KW = dict(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=1, dynamic_max_cross=True,
                reduce_pseudoscalars=True, embed_also_ligand=True, lm_embedding_dim=LM,
                bn_axis_names=("batch",))
LR = 1e-3
# loss and metrics: float32 through ~10 layers, summed in other orders
# (1e-7 to 2e-5 seen)
METRIC_RTOL = 1e-4
# a gradient leaf within GRAD_RTOL of its largest element (1.1e-5 seen)
GRAD_RTOL = 2e-4
N = lambda a: np.asarray(a)  # noqa: E731


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs():
    return (JScoreModelConfig(**MODEL_KW, sigma=JSigmaConfig(tr_sigma_max=19.0)),
            ScoreModelConfig(**MODEL_KW, sigma=SigmaConfig(tr_sigma_max=19.0)))


def setup_pair(tables, jtc, tc, seed: int = 0):
    """(JAX model, JAX state, port model, port state, numpy batch) from the
    same perturbed parameters."""
    js, jt, _, _ = tables
    jcfg, cfg = configs()
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


def step_draws(rng, step: int, batch):
    """The noise draws of JAX's train step ``step`` from ``rng``."""
    key = jax.random.fold_in(jax.random.fold_in(rng, step), 0)
    return draws_from_keys(jax.random.split(key, batch.lig_cat.shape[0]), batch.rot_u.shape[1])


def flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def port_tree(model, named):
    return dict(flat(flax_from_model(model, params=named)["params"]))


def assert_leaves_close(ours: dict, ref: dict, rtol: float, what: str):
    assert set(ours) == set(ref), what
    for k in ref:
        scale = max(np.abs(ref[k]).max(initial=0.0), 1e-6)
        err = np.abs(ours[k] - ref[k]).max(initial=0.0)
        assert err <= rtol * scale, f"{what} {k}: {err:.3e} > {rtol} x {scale:.3e}"


def assert_params_after_adam(ours: dict, ref: dict, grad_ref: dict, lr: float, what: str):
    """Adam's first steps move each weight by about lr * sign(g): where |g|
    is near its rounding the two signs may differ. So a weight is held to
    1e-6 + 1e-2 lr where its |g| is above GRAD_RTOL of its leaf's largest
    gradient, and to 2 lr (a flipped sign) elsewhere."""
    for k in ref:
        g = np.abs(grad_ref[k])
        solid = g > 5 * GRAD_RTOL * max(g.max(initial=0.0), 1e-12)
        err = np.abs(ours[k] - ref[k])
        assert np.all(err[solid] <= 1e-6 + 1e-2 * lr), f"{what} {k}: {err[solid].max():.3e}"
        assert np.all(err <= 2 * lr + 1e-6), f"{what} {k}: {err.max():.3e}"


def compare_states(model, state, jstate, lr: float, grads_ref: dict):
    """Port state vs JAX state after the same steps."""
    ref_params = dict(flat(jstate.params))
    assert_params_after_adam(port_tree(model, state.params), ref_params, grads_ref, lr, "params")
    adam = jax.tree_util.tree_leaves(jstate.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
    adam = [a for a in adam if hasattr(a, "mu")][0]
    assert int(state.opt_state.count) == int(adam.count)
    assert_leaves_close(port_tree(model, state.opt_state.mu), dict(flat(adam.mu)), GRAD_RTOL, "mu")
    assert_leaves_close(port_tree(model, state.opt_state.nu), dict(flat(adam.nu)), 2 * GRAD_RTOL, "nu")
    ema = port_tree(model, state.ema_params)
    for k, v in flat(jstate.ema_params):
        # the EMA moves by (1 - rate) of the params' gap
        assert np.abs(ema[k] - v).max(initial=0.0) <= 2 * lr * 1e-3 + 1e-6, k
    stats = dict(flat(flax_from_model(model)["batch_stats"]))
    for k, v in flat(jstate.batch_stats):
        np.testing.assert_allclose(stats[k], v, rtol=1e-4, atol=1e-5, err_msg=k)


def test_one_train_step_matches_jax(tables):
    js, jt, ps, pt = tables
    # with the per-sigma-interval metrics on
    tc = trainer.TrainConfig(lr=LR, log_sigma_intervals=True)
    jtc = jtrainer.TrainConfig(lr=LR, log_sigma_intervals=True)
    jmodel, jstate, model, state, batch = setup_pair(tables, jtc, tc)
    rng = jax.random.PRNGKey(11)
    jbatch = jax.tree.map(jnp.asarray, j_complexes.ComplexData(*batch))
    jstep = jax.jit(jtrainer.make_train_step(jmodel, jtc, js, jt))
    jnew, jmetrics = jstep(jstate, jbatch, rng)

    step = trainer.make_train_step(model, tc, ps, pt)
    state, metrics = step(state, to_device(batch, "cpu"), step_draws(rng, 0, batch))
    assert set(metrics) == set(jmetrics) and "tr_loss_by_sigma" in metrics
    for k in metrics:
        np.testing.assert_allclose(metrics[k].numpy(), N(jmetrics[k]), rtol=METRIC_RTOL, err_msg=k)
    adam = jnew.opt_state[0][0]
    grads_ref = {k: v / 0.1 for k, v in flat(adam.mu)}  # mu = (1 - b1) g after one step
    assert_leaves_close(port_tree(model, state.grads), grads_ref, GRAD_RTOL, "grad")
    assert state.step == 1
    compare_states(model, state, jnew, LR, grads_ref)
