"""The port's confidence-ranked dock vs the JAX pipeline on the CPU.

One small synthetic complex docked by both packages' ``DockingPipeline``
with the same converted flax parameters (score model and a confidence
model: old-family or new-architecture, all-atom and coarse-grained), the JAX pipeline's own
``jax.random`` draws injected into the port: poses within 1e-3 A,
confidences within 1e-4 x max(max|conf|, 1), the same ranking wherever
neighbouring confidences differ by more than twice that.
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
from diffdock_tpu_torch.data.complexes import atom_bucket, bucket_sizes, synthetic_aa_complex
from diffdock_tpu_torch.inference.pipeline import DockingPipeline
from diffdock_tpu_torch.inference.sampler import SamplerConfig
from diffdock_tpu_torch.models.config import ScoreModelConfig
from diffdock_tpu_torch.models.old_models import confidence_launches
from diffdock_tpu_torch.ops import fused_tp3 as ft
from diffdock_tpu_torch.utils.convert import state_dict_from_flax
from tests.test_torch_port_confidence import _conf_kw, _init_confidence, _perturbed, tables  # noqa: F401
from tests.test_torch_port_dock import _jax_noise


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _compare_docks(tables, ckw, all_atoms):
    """One dock of a small synthetic complex by both pipelines with the
    same weights and the JAX pipeline's draws; returns the two results."""
    js, jt, ps, pt = tables
    skw = dict(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=1)
    n = dict(n_lig=10, n_rec=16, n_bonds=2, atoms_per_res=3)
    aa = synthetic_aa_complex(np.random.RandomState(0), **n)
    jaa = j_complexes.synthetic_aa_complex(np.random.RandomState(0), **n)
    jscore = jax.jit(JCGScoreModel(JScoreModelConfig(**skw)).init)(
        jax.random.PRNGKey(2), jaa.base, jnp.asarray(jaa.base.lig_pos), jnp.asarray(0.5), js, jt)
    # the score model's weights as initialized, so the poses stay near the
    # receptor over the steps
    jscore = _perturbed(jscore, 2, weights=False)
    nl, nr, nb = bucket_sizes(aa.base.n_lig, aa.base.n_rec, aa.base.n_bonds)
    jpad = jax.tree.map(jnp.asarray, j_complexes.pad_aa_to(jaa, nl, nr, nb, atom_bucket(jaa.n_atoms)))
    _, jconf = _init_confidence(JScoreModelConfig(**ckw), jpad if all_atoms else jpad.base, js, jt, 3)

    P, seed, steps = 3, 4, (3, 3)
    sampler = dict(inference_steps=steps[0], actual_steps=steps[1])
    jpipe = JDockingPipeline(JScoreModelConfig(**skw), jscore, JSamplerConfig(**sampler),
                             confidence_cfg=JScoreModelConfig(**ckw), confidence_params=jconf,
                             so3_tables=js, torus_tables=jt)
    ref = jpipe.dock_complex(jaa.base, num_poses=P, seed=seed, aa_data=jaa)

    score_cfg, conf_cfg = ScoreModelConfig(**skw), ScoreModelConfig(**ckw)
    pipe = DockingPipeline(score_cfg, state_dict_from_flax(jscore, score_cfg), SamplerConfig(**sampler),
                           ps, pt, device="cpu", confidence_cfg=conf_cfg,
                           confidence_weights=state_dict_from_flax(jconf, conf_cfg))
    before = ft.counts["fused_tp3_reference"]
    res = pipe.dock_complex(aa.base, num_poses=P, seed=seed, noise=_jax_noise(steps[1]),
                            aa_data=aa)
    # score model: 1 receptor layer + 12 per step; confidence: its receptor
    # embedding (new architectures) and one chunk
    assert ft.counts["fused_tp3_reference"] - before == (
        1 + 12 * steps[1] + confidence_launches(conf_cfg, embed=True) + confidence_launches(conf_cfg))
    np.testing.assert_allclose(res.poses, ref.poses, rtol=0, atol=1e-3)
    tol = 1e-4 * max(np.abs(ref.confidence).max(), 1.0)
    np.testing.assert_allclose(res.confidence, ref.confidence, rtol=0, atol=tol)
    # the ranking agrees wherever neighbouring confidences differ by more
    # than twice the tolerance
    for a, b in zip(ref.order[:-1], ref.order[1:]):
        if ref.confidence[a] - ref.confidence[b] > 2 * tol:
            assert res.confidence[a] > res.confidence[b]
    assert sorted(res.order) == list(range(P))
    return res, ref


@pytest.mark.parametrize("all_atoms", [True, False])
def test_confidence_ranked_dock_matches_jax(tables, all_atoms):
    """Poses, confidences and order of one dock: the JAX pipeline with its
    own random draws, the port with the same draws injected."""
    res, ref = _compare_docks(tables, _conf_kw(all_atoms, 0, 2), all_atoms)
    assert res.affinity is None and ref.affinity is None


@pytest.mark.parametrize("all_atoms", [True, False])
def test_new_architecture_confidence_dock_matches_jax(tables, all_atoms):
    """The same dock ranked by a new-architecture confidence model: the
    coarse-grained model in confidence mode (with ``affinity_prediction``:
    the pose set's affinity within the confidences' tolerance) or
    ``AAScoreModel``, each with a protein-embedding layer whose receptor
    embedding runs once."""
    ckw = dict(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=1, confidence_mode=True,
               all_atoms=all_atoms, affinity_prediction=not all_atoms)
    res, ref = _compare_docks(tables, ckw, all_atoms)
    if all_atoms:
        assert res.affinity is None and ref.affinity is None
    else:
        np.testing.assert_allclose(res.affinity, ref.affinity, rtol=0,
                                   atol=1e-4 * max(abs(ref.affinity), 1.0))
