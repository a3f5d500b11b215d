"""The port's data-parallel score-model train step on 2 gloo ranks.

A small DiffDock-L-like model (``test_torch_port_train_step.py``'s, at
ns 8, nv 2, 2 joint layers) with ``bn_axis_names=("batch", "dp")`` and a
stacked batch of 4 ``synthetic_complex``es whose two halves hold as many
rotatable bonds (the torsion loss is a mean over a batch's bonds, and the
JAX step's ``pmean`` of its shards' losses is the whole batch's only
then). Within the port: 2 ranks x 2
complexes against 1 rank x 4 with the same draws, over 2 steps: the
params, EMA, batch statistics and metrics, and the params bit-identical
on both ranks (``tests/test_training.py:192``). Against JAX: one step
against ``shard_train_step`` on 2 of the conftest's virtual devices, each
port rank fed its JAX shard's draws (``fold_in(fold_in(rng, step),
axis_index)``), under ``test_torch_port_train_step.py``'s limits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdock_tpu.data import complexes as j_complexes
from diffdock_tpu.diffusion.schedules import SigmaConfig as JSigmaConfig
from diffdock_tpu.models.config import ScoreModelConfig as JScoreModelConfig
from diffdock_tpu.parallel.mesh import make_mesh as jmake_mesh
from diffdock_tpu.parallel.mesh import shard_train_step as jshard_train_step
from diffdock_tpu.train import trainer as jtrainer
from diffdock_tpu_torch.diffusion.schedules import SigmaConfig
from diffdock_tpu_torch.models.config import ScoreModelConfig
from diffdock_tpu_torch.models.score_model import CGScoreModel
from diffdock_tpu_torch.parallel import mesh as mesh_mod
from diffdock_tpu_torch.train import trainer
from diffdock_tpu_torch.utils.convert import flax_from_model, state_dict_from_flax
from tests import torch_port_parallel_ranks as ranks
from tests.test_torch_port_model import _init_params
from diffdock_tpu_torch.data.complexes import synthetic_complex
from diffdock_tpu_torch.data.loaders import stack_batch
from tests.test_torch_port_train_parts import draws_from_keys, tables  # noqa: F401
from tests.test_torch_port_train_step import (
    GRAD_RTOL,
    METRIC_RTOL,
    assert_leaves_close,
    assert_params_after_adam,
    flat,
)

LM = 6
MODEL_KW = dict(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=1, dynamic_max_cross=True,
                reduce_pseudoscalars=True, embed_also_ligand=True, lm_embedding_dim=LM,
                bn_axis_names=("batch", "dp"))
LR = 1e-3
BATCH = 4
STEPS = 2


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch():
    """4 complexes of different sizes with 1, 2, 2 and 1 rotatable bonds,
    with random LM features, padded to one bucket and stacked (numpy)."""
    rng = np.random.RandomState(0)
    members = []
    for i, nb in enumerate((1, 2, 2, 1)):
        d = synthetic_complex(rng, n_lig=14 + 3 * i, n_rec=30 + 5 * i, n_bonds=nb, lm_dim=LM)
        members.append((str(i), d._replace(rec_lm=rng.randn(*d.rec_lm.shape).astype(np.float32))))
    return stack_batch(members, (32, 64, 4))[1]


def _tree(cfg, named: dict) -> dict:
    """Named port tensors (numpy) as flat flax leaves."""
    model = CGScoreModel(cfg)
    return dict(flat(flax_from_model(model, params={k: torch.from_numpy(v) for k, v in named.items()})
                     ["params"]))


def _stats(cfg, stats: dict) -> dict:
    model = CGScoreModel(cfg)
    model.load_state_dict({**model.state_dict(), **{k: torch.from_numpy(v) for k, v in stats.items()}})
    return dict(flat(flax_from_model(model)["batch_stats"]))


@pytest.fixture(scope="module")
def runs(tables, tmp_path_factory):  # noqa: F811
    js, jt, _, _ = tables
    sigma = dict(tr_sigma_max=19.0)
    jcfg = JScoreModelConfig(**MODEL_KW, sigma=JSigmaConfig(**sigma))
    cfg = ScoreModelConfig(**MODEL_KW, sigma=SigmaConfig(**sigma))
    batch = _batch()
    example = jax.tree.map(lambda a: None if a is None else jnp.asarray(a[0]), j_complexes.ComplexData(*batch))
    jmodel, variables = _init_params(jcfg, example, js, jt, seed=0)
    sd = state_dict_from_flax(variables, cfg)
    nb = batch.rot_u.shape[1]

    # the JAX reference: one sharded step, each shard's draws rebuilt
    rng = jax.random.PRNGKey(11)
    params = variables["params"]
    jtc = jtrainer.TrainConfig(lr=LR)
    jstate = jtrainer.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=variables["batch_stats"],
        opt_state=jtrainer.make_optimizer(jtc).init(params), ema_params=params)
    jstep = jshard_train_step(jtrainer.make_train_step(jmodel, jtc, js, jt, dp_axis="dp"), jmake_mesh(2))
    jnew, jmetrics = jstep(jstate, jax.tree.map(jnp.asarray, j_complexes.ComplexData(*batch)), rng)
    shard_draws = []
    for r in range(2):
        key = jax.random.fold_in(jax.random.fold_in(rng, 0), r)
        d = draws_from_keys(jax.random.split(jax.random.fold_in(key, 0), BATCH // 2), nb)
        shard_draws.append([tuple(np.asarray(a) for a in d)])

    # the port-vs-port runs: global draws of 4 complexes per step
    g = np.random.RandomState(5)
    global_draws = [(g.rand(BATCH).astype(np.float32), g.randn(BATCH, 3).astype(np.float32),
                     g.rand(BATCH).astype(np.float32), g.randn(BATCH, 3).astype(np.float32),
                     g.randn(BATCH, nb).astype(np.float32)) for _ in range(STEPS)]
    out = tmp_path_factory.mktemp("train_ranks")
    # each rank's draws: its rows of the global ones, or its JAX shard's
    own_rows = [[tuple(a[r * 2:(r + 1) * 2] for a in d) for d in global_draws] for r in range(2)]
    jobs = [("pp", "train_steps", dict(cfg=cfg, state_dict=sd, batch=batch, lr=LR, draws=own_rows)),
            ("jax", "train_steps", dict(cfg=cfg, state_dict=sd, batch=batch, lr=LR, draws=shard_draws))]
    assert mesh_mod.launch(ranks.run, (str(out), jobs), 2, "cpu") == 0
    single = ranks.train_steps(None, cfg, sd, batch, global_draws, LR)
    return dict(cfg=cfg, pp=ranks.results(out, "pp"), jax=ranks.results(out, "jax"), single=single,
                jnew=jnew, jmetrics=jmetrics)


def test_two_ranks_of_two_equal_one_rank_of_four(runs):
    cfg, (r0, r1), single = runs["cfg"], runs["pp"], runs["single"]
    # the parameters, EMA and statistics stay identical on the ranks
    for k in ("params", "ema", "stats"):
        for name in r0[k]:
            np.testing.assert_array_equal(r0[k][name], r1[k][name], err_msg=f"{k} {name}")
    for s in range(STEPS):
        for k, v in single["metrics"][s].items():
            np.testing.assert_allclose(r0["metrics"][s][k], v, rtol=METRIC_RTOL, err_msg=k)
    steps = [_tree(cfg, g) for g in single["grads"]]
    for s in range(STEPS):
        assert_leaves_close(_tree(cfg, r0["grads"][s]), steps[s], GRAD_RTOL, f"grad of step {s}")
    # Adam moves a weight by about lr a step, in the direction of its
    # gradient: a weight whose gradient is solid (above 5 GRAD_RTOL of its
    # leaf's largest) at every step is held to 1e-6 + 1e-2 lr, any other
    # to 2 lr a step (a sign that rounding may flip)
    ours, ref = _tree(cfg, r0["params"]), _tree(cfg, single["params"])
    for k in ref:
        solid = np.all([np.abs(g[k]) > 5 * GRAD_RTOL * max(np.abs(g[k]).max(initial=0.0), 1e-12)
                        for g in steps], axis=0)
        err = np.abs(ours[k] - ref[k])
        assert np.all(err[solid] <= 1e-6 + 1e-2 * LR), f"params {k}: {err[solid].max():.3e}"
        assert np.all(err <= 2 * LR * STEPS + 1e-6), f"params {k}: {err.max(initial=0.0):.3e}"
    ema, ref_ema = _tree(cfg, r0["ema"]), _tree(cfg, single["ema"])
    for k, v in ref_ema.items():
        assert np.abs(ema[k] - v).max(initial=0.0) <= 2 * LR * 1e-3 * STEPS + 1e-6, k
    stats, ref_stats = _stats(cfg, r0["stats"]), _stats(cfg, single["stats"])
    for k, v in ref_stats.items():
        np.testing.assert_allclose(stats[k], v, rtol=1e-4, atol=1e-5, err_msg=k)


def test_one_sharded_step_matches_jax_shard_train_step(runs):
    cfg, (r0, r1), jnew, jm = runs["cfg"], runs["jax"], runs["jnew"], runs["jmetrics"]
    for name in r0["params"]:
        np.testing.assert_array_equal(r0["params"][name], r1["params"][name], err_msg=name)
    ours = r0["metrics"][0]
    assert set(ours) == set(jm)
    for k in ours:
        np.testing.assert_allclose(ours[k], np.asarray(jm[k]), rtol=METRIC_RTOL, err_msg=k)
    adam = jnew.opt_state[0][0]
    grads_ref = {k: v / 0.1 for k, v in flat(adam.mu)}  # mu = (1 - b1) g after one step
    assert_leaves_close(_tree(cfg, r0["grads"][0]), grads_ref, GRAD_RTOL, "grad")
    assert_params_after_adam(_tree(cfg, r0["params"]), dict(flat(jnew.params)), grads_ref, LR, "params")
    ema = _tree(cfg, r0["ema"])
    for k, v in flat(jnew.ema_params):
        assert np.abs(ema[k] - v).max(initial=0.0) <= 2 * LR * 1e-3 + 1e-6, k
    stats = _stats(cfg, r0["stats"])
    for k, v in flat(jnew.batch_stats):
        np.testing.assert_allclose(stats[k], v, rtol=1e-4, atol=1e-5, err_msg=k)
