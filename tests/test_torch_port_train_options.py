"""Three f32 train steps of the port vs the JAX package's ``make_train_step``
with the optimizer's options on, and dropout, on the CPU.

Options: ``grad_clip`` (set below the gradient's norm, so it clips),
``warmup_steps`` (the linear warmup from lr * 1e-3), ``w_decay`` (AdamW),
``lr_scale`` 0.5 and a ``layer_warmup_mask`` (stage 1 of 2 conv layers:
the heads and the top conv layer train), dropout 0. The model, batch and
draws are those of ``test_torch_port_train_step.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdock_tpu.data import complexes as j_complexes
from diffdock_tpu.train import schedulers as jschedulers
from diffdock_tpu.train import trainer as jtrainer
from diffdock_tpu_torch.data.complexes import to_device
from diffdock_tpu_torch.models.config import ScoreModelConfig
from diffdock_tpu_torch.models.score_model import CGScoreModel
from diffdock_tpu_torch.train import schedulers, trainer
from diffdock_tpu_torch.train.noise import draw_noise
from diffdock_tpu_torch.utils.convert import flax_from_model
from tests.test_torch_port_train_parts import synthetic_batch, tables  # noqa: F401
from tests.test_torch_port_train_step import (
    GRAD_RTOL, LR, METRIC_RTOL, assert_leaves_close, flat, port_tree, setup_pair, step_draws,
)

OPTIONS = dict(lr=LR, grad_clip=0.05, warmup_steps=2, w_decay=0.01)
LR_SCALE = 0.5
N_STEPS = 3


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_three_steps_with_options_match_jax(tables):
    js, jt, ps, pt = tables
    jtc, tc = jtrainer.TrainConfig(**OPTIONS), trainer.TrainConfig(**OPTIONS)
    jmodel, jstate, model, state, batch = setup_pair(tables, jtc, tc, seed=2)
    jstate = jstate.replace(lr_scale=jnp.asarray(LR_SCALE, jnp.float32),
                            param_mask=jschedulers.layer_warmup_mask(jstate.params, 1, 2))
    state.lr_scale = LR_SCALE
    state.param_mask = schedulers.layer_warmup_mask(state.params, 1, 2)
    # the same freezing as JAX's, leaf by leaf
    jmask = dict(flat(jstate.param_mask))
    ours_mask = port_tree(model, {k: torch.tensor(v) for k, v in state.param_mask.items()})
    one = lambda v: float(np.asarray(v).reshape(-1)[0])  # noqa: E731
    assert {k: one(v) for k, v in ours_mask.items()} == {k: one(v) for k, v in jmask.items()}
    assert 0 < sum(state.param_mask.values()) < len(state.param_mask)
    start = {k: v.detach().clone() for k, v in state.params.items()}

    rng = jax.random.PRNGKey(21)
    jbatch = jax.tree.map(jnp.asarray, j_complexes.ComplexData(*batch))
    jstep = jax.jit(jtrainer.make_train_step(jmodel, jtc, js, jt))
    step = trainer.make_train_step(model, tc, ps, pt)
    tbatch = to_device(batch, "cpu")
    for i in range(N_STEPS):
        jstate, jm = jstep(jstate, jbatch, rng)
        state, m = step(state, tbatch, step_draws(rng, i, batch))
        for k in m:
            # after a step the params differ where Adam's sign(g) is unsure
            np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]),
                                       rtol=METRIC_RTOL if i == 0 else 1e-3, err_msg=f"{k} {i}")
        if i == 0:
            g_norm = torch.sqrt(sum(g.square().sum() for g in state.grads.values()))
            assert g_norm > OPTIONS["grad_clip"]  # the clip acts

    adam = jstate.opt_state[1][0]  # (clip, (adam, decay, schedule))
    assert int(state.opt_state.count) == int(adam.count) == N_STEPS
    assert int(jstate.opt_state[1][2].count) == N_STEPS
    assert_leaves_close(port_tree(model, state.opt_state.mu), dict(flat(adam.mu)), 50 * GRAD_RTOL, "mu")
    assert_leaves_close(port_tree(model, state.opt_state.nu), dict(flat(adam.nu)), 100 * GRAD_RTOL, "nu")
    # a weight moves at most sum_t lr_t * lr_scale * |mu_hat / sqrt(nu_hat)|
    # per step; held to twice that where signs may differ
    lrs = [float(trainer._schedule(tc, torch.tensor(i))) for i in range(N_STEPS)]
    bound = 2 * LR_SCALE * sum(lrs) * 1.5 + 1e-6
    ours, ref = port_tree(model, state.params), dict(flat(jstate.params))
    for k in ref:
        assert np.abs(ours[k] - ref[k]).max(initial=0.0) <= bound, k
    for k, v in state.params.items():  # frozen weights do not move ...
        if state.param_mask[k] == 0.0:
            assert torch.equal(v.detach(), start[k]), k
    # ... but their Adam moments advance
    frozen = [k for k, w in state.param_mask.items() if w == 0.0]
    assert any(state.opt_state.mu[k].abs().max() > 0 for k in frozen)
    ema, jema = port_tree(model, state.ema_params), dict(flat(jstate.ema_params))
    for k in jema:
        assert np.abs(ema[k] - jema[k]).max(initial=0.0) <= bound * 3e-3 + 1e-6, k
    stats = dict(flat(flax_from_model(model)["batch_stats"]))
    for k, v in flat(jstate.batch_stats):
        np.testing.assert_allclose(stats[k], v, rtol=1e-3, atol=1e-4, err_msg=k)


def test_dropout_masks_in_training_and_not_in_evaluation(tables):
    """With dropout 0.3 the training forward depends on the generator's
    draws; the evaluation forward does not, and equals the dropout-0
    model's with the same weights."""
    _, _, ps, pt = tables
    kw = dict(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=1)
    model = CGScoreModel(ScoreModelConfig(**kw, dropout=0.3))
    model.reset_parameters(torch.Generator().manual_seed(0))
    batch = to_device(synthetic_batch(3), "cpu")
    draws = draw_noise(torch.Generator().manual_seed(1), 3, batch.rot_u.shape[1], device="cpu")
    t = draws.t

    def run(m, seed=None):
        if seed is not None:
            m.set_generator(torch.Generator().manual_seed(seed))
        with torch.no_grad():
            return m(batch, batch.lig_pos, t, ps, pt).tr

    model.train()
    a, b, a2 = run(model, 5), run(model, 6), run(model, 5)
    assert not torch.allclose(a, b) and torch.equal(a, a2)
    model.eval()
    plain = CGScoreModel(ScoreModelConfig(**kw))
    plain.load_state_dict(model.state_dict(), strict=True)  # the running stats moved
    torch.testing.assert_close(run(model, 5), run(model, 6), rtol=0, atol=0)
    torch.testing.assert_close(run(model), run(plain), rtol=0, atol=0)
