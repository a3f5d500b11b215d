"""The port's CGScoreModel at the full DiffDock-L width vs the JAX model on the CPU.

``__graft_entry__.py:entry``'s configuration: the ``diffdock_l`` preset
(ns=48, nv=10, 3 protein-embedding and 3 joint layers, dynamic cross
cutoff), with ``lm_embedding_dim`` 0 as there and with the preset's 1280.
Flax parameters from the JAX model's ``init`` (biases and batch-norm
statistics perturbed off their init values; the weights as initialized,
since perturbing every weight at this width drives the scores to ~1e14)
go through ``state_dict_from_flax``; one small padded complex and
two poses go through both models, with the receptor cache and the step
cache. Tolerance: 1e-4 relative and absolute on the scores, as the
narrow-width model test (float32 reordering through ~15 layers).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdock_tpu.data import complexes as j_complexes
from diffdock_tpu.models.config import PRESETS as J_PRESETS
from diffdock_tpu_torch.data.complexes import pad_to, synthetic_complex, to_device
from diffdock_tpu_torch.models.config import PRESETS
from diffdock_tpu_torch.models.score_model import CGScoreModel
from diffdock_tpu_torch.utils.convert import state_dict_from_flax
from diffdock_tpu.models.score_model import CGScoreModel as JCGScoreModel
from tests.test_torch_port_confidence import _perturbed
from tests.test_torch_port_model import T, tables  # noqa: F401


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("lm_dim", [0, 1280])
def test_diffdock_l_forward_matches_jax(tables, lm_dim):
    js, jt, ps, pt = tables
    jcfg = dataclasses.replace(J_PRESETS["diffdock_l"], lm_embedding_dim=lm_dim)
    cfg = dataclasses.replace(PRESETS["diffdock_l"], lm_embedding_dim=lm_dim)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg) and cfg.ns == 48 and cfg.nv == 10
    data = synthetic_complex(np.random.RandomState(0), n_lig=10, n_rec=24, n_bonds=3, lm_dim=lm_dim)
    data = pad_to(data, 16, 32, 4)
    jdata = j_complexes.ComplexData(*[None if a is None else jnp.asarray(a) for a in data])
    jmodel = JCGScoreModel(jcfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(5), jdata, jnp.asarray(jdata.lig_pos),
                                  jnp.asarray(0.5), js, jt)
    params = _perturbed(params, 5, weights=False)

    model = CGScoreModel(cfg)
    model.load_state_dict(state_dict_from_flax(params, cfg), strict=True)
    model.eval()
    tdata = to_device(data, "cpu")
    rng = np.random.RandomState(1)
    poses = (data.lig_pos[None] + rng.randn(2, 16, 3) * 0.5).astype(np.float32)
    t = 0.6
    with torch.no_grad():
        cache = model.embed_receptor(tdata)
        step = model.step_cache(tdata, torch.tensor(t), cache)
        out = model(tdata, T(poses), torch.tensor(t), ps, pt, rec_cache=cache, step_cache=step)
    ref = jax.jit(jax.vmap(lambda p, q: jmodel.apply(p, jdata, q, jnp.asarray(t), js, jt),
                           in_axes=(None, 0)))(params, jnp.asarray(poses))
    for name in ("tr", "rot", "tor"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    assert np.all(out.tor[:, 3:].numpy() == 0.0)  # padded bond slot
