"""The port's sharded docks on 2 gloo ranks against the JAX pipeline on a
2-device mesh (the conftest's virtual CPU devices).

The score model's tr and rot heads are scaled down, as in
``tests/test_torch_port_old_score.py``. Pose sharding:
``DockingPipeline(mesh=...)`` of both packages dock 3 poses
(rounded up to 4, 2 per shard) of one small complex in 3 steps, ranked by
a coarse-grained confidence model with ``affinity_prediction``, each
port rank fed the JAX shard's own draws (``fold_in(PRNGKey(seed), rank)``):
poses and the step-major trajectory within 1e-3 A, confidences within
1e-4 of scale, the same ranking, the averaged affinity, and each rank's
launch count (the counterpart of ``tests/test_pose_sharding.py:73-128``).
Complex sharding: ``dock_batch`` of 3 complexes of two sizes over the
2-device mesh, complex ``i`` from ``fold_in(PRNGKey(seed * 100003), i)``,
in input order (``tests/test_complex_sharding.py:52-85``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdock_tpu.data import complexes as j_complexes
from diffdock_tpu.inference.pipeline import DockingPipeline as JDockingPipeline
from diffdock_tpu.inference.sampler import SamplerConfig as JSamplerConfig
from diffdock_tpu.models.config import ScoreModelConfig as JScoreModelConfig
from diffdock_tpu.models.score_model import CGScoreModel as JCGScoreModel
from diffdock_tpu.parallel.mesh import make_mesh as jmake_mesh
from diffdock_tpu_torch.data.complexes import bucket_sizes, synthetic_aa_complex, synthetic_complex
from diffdock_tpu_torch.models.config import ScoreModelConfig
from diffdock_tpu_torch.models.old_models import confidence_launches
from diffdock_tpu_torch.parallel import mesh as mesh_mod
from diffdock_tpu_torch.utils.convert import state_dict_from_flax
from tests import torch_port_parallel_ranks as ranks
from tests.test_torch_port_confidence import _init_confidence, _perturbed, tables  # noqa: F401

SKW = dict(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=1)
CKW = dict(SKW, confidence_mode=True, affinity_prediction=True)
STEPS = 3
SAMPLER = dict(inference_steps=STEPS, actual_steps=STEPS)
HEAD_SCALE = 0.02
POSE_ATOL = 1e-3  # float32 docks of the two packages, as in the single-device tests
N = np.asarray


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_draws(key, P, nb):
    """The start-pose and per-step draws JAX's ``_make_run`` makes from
    ``key``, as numpy (InitNoise fields, StepNoise fields)."""
    k_init, k_diff = jax.random.split(key)
    k_tor, k_rot, k_tr, k_res = jax.random.split(k_init, 4)
    init = (N(jax.random.uniform(k_tor, (P, nb), minval=-jnp.pi, maxval=jnp.pi)),
            N(jax.random.normal(k_rot, (P, 4))), N(jax.random.normal(k_tr, (P, 1, 3))),
            N(jax.random.uniform(k_res, (P,))))
    k, draws = k_diff, []
    for _ in range(STEPS):
        k, a, b, c = jax.random.split(k, 4)
        draws.append((N(jax.random.normal(a, (P, 3))), N(jax.random.normal(b, (P, 3))),
                      N(jax.random.normal(c, (P, nb)))))
    return init, tuple(np.stack([d[i] for d in draws]) for i in range(3))


@pytest.fixture(scope="module")
def docks(tables, tmp_path_factory):  # noqa: F811
    """Both JAX references and one 2-rank spawn running both port docks."""
    js, jt, _, _ = tables
    n = dict(n_lig=10, n_rec=16, n_bonds=2, atoms_per_res=3)
    data = synthetic_aa_complex(np.random.RandomState(0), **n).base
    jdata = j_complexes.synthetic_aa_complex(np.random.RandomState(0), **n).base
    jscore = jax.jit(JCGScoreModel(JScoreModelConfig(**SKW)).init)(
        jax.random.PRNGKey(2), jdata, jnp.asarray(jdata.lig_pos), jnp.asarray(0.5), js, jt)
    # biases and statistics perturbed, weights as initialized, the tr and
    # rot heads scaled by HEAD_SCALE so that the poses stay near the
    # receptor (tests/test_torch_port_old_score.py says why)
    jscore = jax.tree.map(np.asarray, _perturbed(jscore, 2, weights=False))
    for head in ("tr_final_layer", "rot_final_layer"):
        last = jscore["params"][head]["Dense_1"]
        last.update(kernel=last["kernel"] * HEAD_SCALE, bias=last["bias"] * HEAD_SCALE)
    nl, nr, nb = bucket_sizes(data.n_lig, data.n_rec, data.n_bonds)
    jpad = jax.tree.map(jnp.asarray, j_complexes.pad_to(jdata, nl, nr, nb))
    _, jconf = _init_confidence(JScoreModelConfig(**CKW), jpad, js, jt, 3)
    P, seed = 3, 4
    jpipe = JDockingPipeline(JScoreModelConfig(**SKW), jscore, JSamplerConfig(**SAMPLER),
                             confidence_cfg=JScoreModelConfig(**CKW), confidence_params=jconf,
                             so3_tables=js, torus_tables=jt, mesh=jmake_mesh(2))
    ref = jpipe.dock_complex(jdata, num_poses=P, seed=seed, return_trajectory=True)
    pose_draws = {(seed, r): jax_draws(jax.random.fold_in(jax.random.PRNGKey(seed), r), 2, nb)
                  for r in range(2)}

    sizes = [dict(n_lig=10, n_rec=16, n_bonds=2), dict(n_lig=14, n_rec=24, n_bonds=2),
             dict(n_lig=10, n_rec=16, n_bonds=2)]
    datas = [synthetic_complex(np.random.RandomState(10 + i), **kw) for i, kw in enumerate(sizes)]
    jdatas = [j_complexes.synthetic_complex(np.random.RandomState(10 + i), **kw)
              for i, kw in enumerate(sizes)]
    jbatch = JDockingPipeline(JScoreModelConfig(**SKW), jscore, JSamplerConfig(**SAMPLER),
                              so3_tables=js, torus_tables=jt, mesh=jmake_mesh(2))
    bseed = 5
    batch_ref = jbatch.dock_batch(jdatas, num_poses=3, seed=bseed)
    nb_b = max(bucket_sizes(d.n_lig, d.n_rec, d.n_bonds)[2] for d in datas)
    batch_draws = {(bseed * 100003, i): jax_draws(
        jax.random.fold_in(jax.random.PRNGKey(bseed * 100003), i), 3, nb_b) for i in range(3)}

    score_cfg, conf_cfg = ScoreModelConfig(**SKW), ScoreModelConfig(**CKW)
    score_sd, conf_sd = state_dict_from_flax(jscore, score_cfg), state_dict_from_flax(jconf, conf_cfg)
    out = tmp_path_factory.mktemp("dock_ranks")
    jobs = [("dock", "dock", dict(score_cfg=score_cfg, score_sd=score_sd, conf_cfg=conf_cfg,
                                  conf_sd=conf_sd, sampler_kw=SAMPLER, data=data, num_poses=P,
                                  seed=seed, draws=pose_draws)),
            ("batch", "dock_batch", dict(score_cfg=score_cfg, score_sd=score_sd, sampler_kw=SAMPLER,
                                         datas=datas, num_poses=3, seed=bseed, draws=batch_draws))]
    assert mesh_mod.launch(ranks.run, (str(out), jobs), 2, "cpu") == 0
    return dict(ref=ref, got=ranks.results(out, "dock"), batch_ref=batch_ref,
                batch=ranks.results(out, "batch"), datas=datas, conf_cfg=conf_cfg)


def test_pose_sharded_dock_matches_jax_mesh(docks):
    ref = docks["ref"]
    (res, launches0), (res1, launches1) = docks["got"]
    # every rank returns the same gathered result
    np.testing.assert_array_equal(res.poses, res1.poses)
    assert res.poses.shape == ref.poses.shape == (3, 10, 3)
    np.testing.assert_allclose(res.poses, ref.poses, rtol=0, atol=POSE_ATOL)
    tol = 1e-4 * max(np.abs(ref.confidence).max(), 1.0)
    np.testing.assert_allclose(res.confidence, ref.confidence, rtol=0, atol=tol)
    for a, b in zip(ref.order[:-1], ref.order[1:]):
        if ref.confidence[a] - ref.confidence[b] > 2 * tol:
            assert res.confidence[a] > res.confidence[b]
    assert sorted(res.order) == list(range(3))
    # the only collective of the JAX program: the affinity's pmean
    np.testing.assert_allclose(res.affinity, ref.affinity, rtol=0, atol=1e-4 * max(abs(ref.affinity), 1.0))
    assert res.trajectory.shape == ref.trajectory.shape == (STEPS + 1, 3, 10, 3)
    np.testing.assert_allclose(res.trajectory, ref.trajectory, rtol=0, atol=POSE_ATOL)
    # each rank docked its 2 poses: its score model and one confidence chunk
    conf_cfg = docks["conf_cfg"]
    per_rank = 1 + 12 * STEPS + confidence_launches(conf_cfg, embed=True) + confidence_launches(conf_cfg)
    assert launches0 == launches1 == per_rank


def test_complex_sharded_dock_batch_matches_jax_mesh(docks):
    got, other = docks["batch"]
    assert len(got) == len(docks["batch_ref"]) == 3
    for d, r, o, ref in zip(docks["datas"], got, other, docks["batch_ref"]):
        assert r.poses.shape == ref.poses.shape == (3, d.n_lig, 3)
        np.testing.assert_array_equal(r.poses, o.poses)
        np.testing.assert_allclose(r.poses, ref.poses, rtol=0, atol=POSE_ATOL)
        assert r.confidence is None and list(r.order) == [0, 1, 2]
    # the two complexes of one size drew from their own input indices
    assert not np.allclose(got[0].poses, got[2].poses)
