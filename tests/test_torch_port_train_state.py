"""Train states across the two packages, on the CPU.

A JAX train state written by the JAX package's ``save_train_state``
resumes in the port (``load_train_state``; the reverse is in
``test_torch_port_train_resume.py``): every leaf
equal (params, batch stats, both Adam moments and the counts, EMA, step,
``lr_scale``), and the next step from either gives the same loss and
metrics. The optimizer has clipping, warmup and AdamW on, so the optax
state tree nests as it does in a real run. Model, batch and draws as in
``test_torch_port_train_step.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdock_tpu.data import complexes as j_complexes
from diffdock_tpu.train import checkpoints as jckpt
from diffdock_tpu.train import trainer as jtrainer
from diffdock_tpu_torch.data.complexes import to_device
from diffdock_tpu_torch.models.score_model import CGScoreModel
from diffdock_tpu_torch.train import checkpoints as ckpt
from diffdock_tpu_torch.train import trainer
from diffdock_tpu_torch.utils.convert import flax_from_model
from tests.test_torch_port_train_parts import tables  # noqa: F401
from tests.test_torch_port_train_step import (
    LR, METRIC_RTOL, configs, flat, port_tree, setup_pair, step_draws,
)

OPTIONS = dict(lr=LR, grad_clip=0.05, warmup_steps=3, w_decay=0.01)
N = lambda a: np.asarray(a)  # noqa: E731


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_leaves(jstate):
    adam = jstate.opt_state[1][0]
    out = {f"params/{k}": v for k, v in flat(jstate.params)}
    out.update({f"batch_stats/{k}": v for k, v in flat(jstate.batch_stats)})
    out.update({f"mu/{k}": v for k, v in flat(adam.mu)})
    out.update({f"nu/{k}": v for k, v in flat(adam.nu)})
    out.update({f"ema/{k}": v for k, v in flat(jstate.ema_params)})
    out.update(count=N(adam.count), schedule_count=N(jstate.opt_state[1][2].count),
               step=N(jstate.step), lr_scale=N(jstate.lr_scale))
    return out


def _port_leaves(model, state):
    out = {f"params/{k}": v for k, v in port_tree(model, state.params).items()}
    out.update({f"batch_stats/{k}": v for k, v in flat(flax_from_model(model)["batch_stats"])})
    out.update({f"mu/{k}": v for k, v in port_tree(model, state.opt_state.mu).items()})
    out.update({f"nu/{k}": v for k, v in port_tree(model, state.opt_state.nu).items()})
    out.update({f"ema/{k}": v for k, v in port_tree(model, state.ema_params).items()})
    count = np.asarray(int(state.opt_state.count), np.int32)
    out.update(count=count, schedule_count=count, step=np.asarray(state.step, np.int32),
               lr_scale=np.asarray(state.lr_scale, np.float32))
    return out


def _assert_equal_leaves(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(N(a[k]), N(b[k]), err_msg=k)


def _next_steps_agree(tables, jstep, jstate, model, state, batch, rng, tc):
    _, _, ps, pt = tables
    jbatch = jax.tree.map(jnp.asarray, j_complexes.ComplexData(*batch))
    _, jm = jstep(jstate, jbatch, rng)
    _, m = trainer.make_train_step(model, tc, ps, pt)(
        state, to_device(batch, "cpu"), step_draws(rng, int(jstate.step), batch))
    for k in m:
        np.testing.assert_allclose(m[k].numpy(), N(jm[k]), rtol=METRIC_RTOL, err_msg=k)


def test_jax_train_state_resumes_in_the_port(tables, tmp_path):
    js, jt, _, _ = tables
    jtc, tc = jtrainer.TrainConfig(**OPTIONS), trainer.TrainConfig(**OPTIONS)
    jmodel, jstate, _, _, batch = setup_pair(tables, jtc, tc, seed=4)
    rng = jax.random.PRNGKey(31)
    jbatch = jax.tree.map(jnp.asarray, j_complexes.ComplexData(*batch))
    jstep = jax.jit(jtrainer.make_train_step(jmodel, jtc, js, jt))
    jstate, _ = jstep(jstate, jbatch, rng)
    jstate = jstate.replace(lr_scale=jnp.asarray(0.7, jnp.float32))
    jckpt.save_train_state(str(tmp_path), jstate, configs()[0])

    model = CGScoreModel(configs()[1])
    state = trainer.create_train_state(model, tc)
    ckpt.load_train_state(str(tmp_path), model, state)
    _assert_equal_leaves(_port_leaves(model, state), _jax_leaves(jstate))
    _next_steps_agree(tables, jstep, jstate, model, state, batch, rng, tc)
