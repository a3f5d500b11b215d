"""The port's data-parallel confidence train step on 2 gloo ranks
(``tests/test_confidence_train.py:185``'s counterpart).

The coarse-grained confidence model (``test_torch_port_confidence_train.py``'s
step case ``cg_bce``) with ``bn_axis_names=("batch", "dp")`` on a stacked
batch of 4 small complexes, one pose each, BCE labels. Within the port:
2 ranks x 2 complexes against 1 rank x 4, 2 steps (the params, batch
statistics and metrics; the params bit-identical on both ranks). Against
JAX: one step against ``make_confidence_train_step(..., dp_axis="dp")``
under ``shard_confidence_train_step`` on 2 of the conftest's virtual
devices, under that file's limits (the leaves whose exact gradient is zero
held apart).
"""

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdock_tpu.parallel.mesh import make_mesh as jmake_mesh
from diffdock_tpu.parallel.mesh import shard_confidence_train_step as jshard_confidence_train_step
from diffdock_tpu.train import confidence as jconf
from diffdock_tpu_torch.data.loaders import stack_padded
from diffdock_tpu_torch.models.factory import build_model
from diffdock_tpu_torch.parallel import mesh as mesh_mod
from diffdock_tpu_torch.train import confidence as conf
from diffdock_tpu_torch.utils.convert import flax_from_model, state_dict_from_flax
from tests import torch_port_parallel_ranks as ranks
from tests.test_torch_port_confidence import _one_thread, tables  # noqa: F401
from tests.test_torch_port_confidence_head import _complexes, _configs, _pair, _poses
from tests.test_torch_port_train_step import GRAD_RTOL, METRIC_RTOL, assert_leaves_close, flat

LR = 1e-3
BATCH = 4
STEPS = 2


def _tree(model, named: dict) -> dict:
    return dict(flat(flax_from_model(model, params={k: torch.from_numpy(v) for k, v in named.items()})
                     ["params"]))


def _stats(model, stats: dict) -> dict:
    model.load_state_dict({**model.state_dict(), **{k: torch.from_numpy(v) for k, v in stats.items()}})
    return dict(flat(flax_from_model(model)["batch_stats"]))


@pytest.fixture(scope="module")
def runs(tables, tmp_path_factory):  # noqa: F811
    js, jt, _, _ = tables
    jtc, tc = jconf.ConfidenceTrainConfig(lr=LR), conf.ConfidenceTrainConfig(lr=LR)
    jcfg, cfg = _configs(num_prot_emb_layers=1, num_conv_layers=2, num_confidence_outputs=tc.num_outputs,
                         bn_axis_names=("batch", "dp"))
    datas = _complexes(False, BATCH, 0, seed=7)
    jmodel, variables, model = _pair(jcfg, cfg, datas[0], tables, seed=4)
    batch = stack_padded(datas)
    poses = np.stack([_poses(d, 1, 30 + i)[0] for i, d in enumerate(datas)])
    labels = tc.labels_from_rmsds(np.array([1.0, 3.5, 7.0, 0.5], np.float32))

    step, tx = jconf.make_confidence_train_step(jmodel, jtc, js, jt, dp_axis="dp")
    step = jshard_confidence_train_step(step, jmake_mesh(2))
    params = variables["params"]
    jparams, jstats, jopt, jm = step(
        params, variables["batch_stats"], tx.init(params),
        (jax.tree.map(jnp.asarray, batch), jnp.asarray(poses), jnp.asarray(labels)),
        jax.random.PRNGKey(0))

    sd = state_dict_from_flax(variables, cfg)
    kw = dict(cfg=cfg, tcfg=tc, state_dict=sd, batch=batch, poses=poses, labels=labels)
    out = tmp_path_factory.mktemp("confidence_ranks")
    jobs = [("pp", "confidence_steps", dict(kw, seeds=list(range(STEPS)))),
            ("jax", "confidence_steps", dict(kw, seeds=[0]))]
    assert mesh_mod.launch(ranks.run, (str(out), jobs), 2, "cpu") == 0
    single = ranks.confidence_steps(None, seeds=list(range(STEPS)), **kw)
    return dict(model=build_model(cfg), pp=ranks.results(out, "pp"), jax=ranks.results(out, "jax"),
                single=single, jax_ref=(jparams, jstats, jopt, jm))


def _zero_leaves(model):
    return chip_smoke.conf_zero_gradient_leaves(model)


def _check_params(model, ours: dict, ref: dict, grads: list, what: str):
    """Adam's steps: a weight whose gradient is solid at every step within
    1e-6 + 1e-2 lr, any other within 2 lr a step; the leaves whose exact
    gradient is zero (rounding noise only) within 2 lr a step."""
    zero = _zero_leaves(model)
    for k in ref:
        err = np.abs(ours[k] - ref[k])
        assert np.all(err <= 2 * LR * len(grads) + 1e-6), f"{what} {k}: {err.max(initial=0.0):.3e}"
        if k in zero:
            continue
        solid = np.all([np.abs(g[k]) > 5 * GRAD_RTOL * max(np.abs(g[k]).max(initial=0.0), 1e-12)
                        for g in grads], axis=0)
        assert np.all(err[solid] <= 1e-6 + 1e-2 * LR), f"{what} {k}: {err[solid].max():.3e}"


def _check_grads(model, ours: dict, ref: dict):
    zero = _zero_leaves(model)
    largest = max(np.abs(g).max(initial=0.0) for g in ref.values())
    for k in zero:
        assert max(np.abs(ours[k]).max(), np.abs(ref[k]).max()) <= GRAD_RTOL * largest, k
    keep = lambda d: {k: v for k, v in d.items() if k not in zero}  # noqa: E731
    assert_leaves_close(keep(ours), keep(ref), GRAD_RTOL, "grad")


def test_two_ranks_of_two_equal_one_rank_of_four(runs):
    model, (r0, r1), single = runs["model"], runs["pp"], runs["single"]
    for k in ("params", "stats"):
        for name in r0[k]:
            np.testing.assert_array_equal(r0[k][name], r1[k][name], err_msg=f"{k} {name}")
    for s in range(STEPS):
        for k, v in single["metrics"][s].items():
            np.testing.assert_allclose(r0["metrics"][s][k], v, rtol=METRIC_RTOL, atol=1e-7, err_msg=k)
    grads = [_tree(model, g) for g in single["grads"]]
    for s in range(STEPS):
        _check_grads(model, _tree(model, r0["grads"][s]), grads[s])
    _check_params(model, _tree(model, r0["params"]), _tree(model, single["params"]), grads, "params")
    # the head's norms follow a Dense whose bias has a zero gradient (see
    # _check_grads): after the first step that bias differs by up to 2 lr
    # between the runs, and the next step's running mean, which moves by
    # momentum 0.1, by up to 0.1 x 2 lr more (the variance does not see it)
    stats, ref = _stats(model, r0["stats"]), _stats(model, single["stats"])
    for k, v in ref.items():
        drift = 0.1 * 2 * LR * (STEPS - 1) if k.startswith("confidence_predictor/") and \
            k.endswith("/mean") else 0.0
        np.testing.assert_allclose(stats[k], v, rtol=1e-4, atol=1e-5 + drift, err_msg=k)


def test_one_sharded_step_matches_jax(runs):
    model, (r0, r1) = runs["model"], runs["jax"]
    jparams, jstats, jopt, jm = runs["jax_ref"]
    for name in r0["params"]:
        np.testing.assert_array_equal(r0["params"][name], r1["params"][name], err_msg=name)
    for k in ("loss", "accuracy"):
        np.testing.assert_allclose(r0["metrics"][0][k], float(jm[k]), rtol=METRIC_RTOL, atol=1e-7, err_msg=k)
    grads_ref = {k: v / 0.1 for k, v in flat(jopt[0].mu)}  # mu = (1 - b1) g after one step
    _check_grads(model, _tree(model, r0["grads"][0]), grads_ref)
    _check_params(model, _tree(model, r0["params"]), dict(flat(jparams)), [grads_ref], "params")
    stats = _stats(model, r0["stats"])
    for k, v in flat(jstats):
        np.testing.assert_allclose(stats[k], v, rtol=1e-4, atol=1e-5, err_msg=k)
