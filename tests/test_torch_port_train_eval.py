"""The port's eval step vs the JAX package's ``make_eval_step`` on the CPU:
the same noising and loss as training in evaluation mode (running
statistics, no dropout, no gradient), the running statistics untouched.
Model, batch and draws as in ``test_torch_port_train_step.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdock_tpu.data import complexes as j_complexes
from diffdock_tpu.train import trainer as jtrainer
from diffdock_tpu_torch.data.complexes import to_device
from diffdock_tpu_torch.train import trainer
from tests.test_torch_port_train_parts import draws_from_keys, tables  # noqa: F401
from tests.test_torch_port_train_step import LR, METRIC_RTOL, setup_pair

N = lambda a: np.asarray(a)  # noqa: E731


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_eval_step_matches_jax(tables):
    js, jt, ps, pt = tables
    tc = trainer.TrainConfig(lr=LR)
    jmodel, jstate, model, state, batch = setup_pair(tables, jtrainer.TrainConfig(lr=LR), tc, seed=1)
    rng = jax.random.PRNGKey(12)
    jbatch = jax.tree.map(jnp.asarray, j_complexes.ComplexData(*batch))
    jm = jax.jit(jtrainer.make_eval_step(jmodel, jtrainer.TrainConfig(lr=LR), js, jt))(jstate, jbatch, rng)
    draws = draws_from_keys(jax.random.split(rng, 3), batch.rot_u.shape[1])
    before = {k: v.clone() for k, v in state.batch_stats.items()}
    m = trainer.make_eval_step(model, tc, ps, pt)(state, to_device(batch, "cpu"), draws)
    assert set(m) == set(jm)
    for k in m:
        np.testing.assert_allclose(m[k].numpy(), N(jm[k]), rtol=METRIC_RTOL, err_msg=k)
    assert all(torch.equal(before[k], v) for k, v in state.batch_stats.items())
