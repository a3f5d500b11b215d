"""A port train state resumes in the JAX package, on the CPU: the port's
``save_train_state`` read by the JAX package's ``load_train_state`` into
its template, every leaf equal, the config as the JAX CLI writes it, and
the next step from either gives the same loss and metrics (helpers and
the other direction in ``test_torch_port_train_state.py``).
"""

import jax
import pytest
import torch
import yaml

from diffdock_tpu.train import checkpoints as jckpt
from diffdock_tpu.train import trainer as jtrainer
from diffdock_tpu_torch.data.complexes import to_device
from diffdock_tpu_torch.train import checkpoints as ckpt
from diffdock_tpu_torch.train import trainer
from tests.test_torch_port_train_parts import tables  # noqa: F401
from tests.test_torch_port_train_state import (
    OPTIONS, _assert_equal_leaves, _jax_leaves, _next_steps_agree, _port_leaves,
)
from tests.test_torch_port_train_step import configs, setup_pair, step_draws


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_port_train_state_resumes_in_jax(tables, tmp_path):
    _, _, ps, pt = tables
    jtc, tc = jtrainer.TrainConfig(**OPTIONS), trainer.TrainConfig(**OPTIONS)
    jmodel, jtemplate, model, state, batch = setup_pair(tables, jtc, tc, seed=5)
    rng = jax.random.PRNGKey(32)
    state, _ = trainer.make_train_step(model, tc, ps, pt)(
        state, to_device(batch, "cpu"), step_draws(rng, 0, batch))
    state.lr_scale = 0.7
    jcfg, cfg = configs()
    ckpt.save_train_state(str(tmp_path), model, state, cfg, tc, extra={"epoch": 0})
    jstate = jckpt.load_train_state(str(tmp_path), jtemplate)
    _assert_equal_leaves(_jax_leaves(jstate), _port_leaves(model, state))
    meta = yaml.safe_load((tmp_path / ckpt.CONFIG_FILE).read_text())
    # the config as the JAX CLI writes it, bn_axis_names included
    assert jckpt._cfg_from_dict(meta["model"]) == jcfg and meta["epoch"] == 0
    jstep = jax.jit(jtrainer.make_train_step(jmodel, jtc, tables[0], tables[1]))
    _next_steps_agree(tables, jstep, jstate, model, state, batch, rng, tc)
