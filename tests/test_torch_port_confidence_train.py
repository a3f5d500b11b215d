"""Confidence training of the port vs the JAX package on the CPU: labels,
the pose caches both ways, the pose-generation labels, one f32 step leaf by
leaf against ``make_confidence_train_step``, the learning regression of
``tests/test_confidence_train.py`` and the head's dropout.

The step: a stacked batch of 3 small complexes (one pose each) through the
JAX step (``jit``, batch norms over the named axis ``batch``) and the
port's, from the same perturbed weights, dropout 0. Compared after the
step: loss and accuracy within METRIC_RTOL, every gradient leaf (JAX's
through its first Adam moment, mu = 0.1 g) within GRAD_RTOL of its largest
element, both Adam moments, the params and the batch statistics — the
tolerances of ``tests/test_torch_port_train_step.py``.
"""

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdock_tpu.train import confidence as jconf
from diffdock_tpu_torch.data.chem import read_molecule_file
from diffdock_tpu_torch.data.complexes import pad_to, synthetic_complex, to_device
from diffdock_tpu_torch.data.loaders import stack_padded
from diffdock_tpu_torch.inference.pipeline import DockingResult
from diffdock_tpu_torch.models.config import ScoreModelConfig
from diffdock_tpu_torch.models.factory import build_model
from diffdock_tpu_torch.train import confidence as conf
from diffdock_tpu_torch.train.trainer import training_model_config
from diffdock_tpu_torch.utils.convert import flax_from_model
from tests.test_torch_port_confidence import _one_thread, tables  # noqa: F401
from tests.test_torch_port_confidence_head import _complexes, _configs, _pair, _poses
from tests.test_torch_port_train_step import (
    GRAD_RTOL,
    METRIC_RTOL,
    assert_leaves_close,
    assert_params_after_adam,
    flat,
    port_tree,
)

LR = 1e-3
BATCH = 3
E2E_LIGAND = "data/e2e_synth/syn000_l50r368/syn000_l50r368_ligand.sdf"


def _tcfgs(kind: str):
    kw = {"bce": dict(), "ce": dict(rmsd_classification_cutoff=(2.0, 5.0)),
          "mse": dict(rmsd_prediction=True)}[kind]
    return jconf.ConfidenceTrainConfig(lr=LR, **kw), conf.ConfidenceTrainConfig(lr=LR, **kw)


def test_labels_and_outputs_match_jax():
    rmsds = np.random.RandomState(0).rand(50).astype(np.float32) * 9
    rmsds[:4] = [2.0, 5.0, 0.0, 1.9999]  # at and beside the cutoffs
    for kw in (dict(), dict(rmsd_classification_cutoff=(2.0, 5.0)),
               dict(rmsd_classification_cutoff=(1.0, 2.0, 4.0)), dict(rmsd_prediction=True),
               dict(rmsd_classification_cutoff=(2.0, 5.0), rmsd_prediction=True)):
        ref, ours = jconf.ConfidenceTrainConfig(**kw), conf.ConfidenceTrainConfig(**kw)
        assert ours.num_outputs == ref.num_outputs
        got = ours.labels_from_rmsds(rmsds)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, ref.labels_from_rmsds(rmsds))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pose_caches_are_read_both_ways(tmp_path, writer):
    """Files named by one package's ``pose_cache_file`` and written as its
    CLI writes them, read by the other's ``load_pose_cache``: the plain
    file, and the ``cache_ids`` accumulation over generation runs."""
    write_mod, read_mod = (jconf, conf) if writer == "jax" else (conf, jconf)
    rng = np.random.RandomState(1)
    banks = {("A", None): (4, 10), ("A", 1): (4, 10), ("B", 1): (4, 12), ("B", 2): (3, 12),
             ("C", 2): (3, 8)}
    data = {}
    for (name, cid), (n, nl) in banks.items():
        poses, rmsds = rng.randn(n, nl, 3).astype(np.float32), (rng.rand(n) * 5).astype(np.float32)
        assert str(write_mod.pose_cache_file(tmp_path, name, cid)) == \
            str(read_mod.pose_cache_file(tmp_path, name, cid))
        np.savez_compressed(write_mod.pose_cache_file(tmp_path, name, cid), poses=poses, rmsds=rmsds)
        data[(name, cid)] = (poses, rmsds)
    for name, ids in (("A", None), ("A", [1, 2]), ("B", [1, 2]), ("B", [2]), ("C", [1, 2]),
                      ("D", [1, 2]), ("B", None)):
        got, ref = read_mod.load_pose_cache(tmp_path, name, ids), write_mod.load_pose_cache(tmp_path, name, ids)
        if ref is None:
            assert got is None
            continue
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    pb, rb = read_mod.load_pose_cache(tmp_path, "B", [1, 2])
    np.testing.assert_array_equal(rb, np.concatenate([data[("B", 1)][1], data[("B", 2)][1]]))
    assert pb.shape == (7, 12, 3)


class _FixedPoses:
    """A pipeline stand-in whose dock returns given poses (input frame, at
    the padded width), so both packages label the same poses."""

    def __init__(self, poses):
        self.poses = poses
        self.calls = []

    def dock_complex(self, data, num_poses, seed, aa_data=None):
        self.calls.append((num_poses, seed))
        return DockingResult(poses=self.poses[:num_poses], confidence=None, order=np.arange(num_poses))


@pytest.mark.parametrize("topology", [False, True])
def test_generated_pose_labels_match_jax(topology):
    """``generate_poses_for_complex`` on the same poses: RMSD over the real
    atoms only (symmetry-corrected with the ligand's topology), poses back
    at the padded width with zero padding rows."""
    mol = read_molecule_file(E2E_LIGAND).remove_hs()
    n = mol.num_atoms
    rng = np.random.RandomState(2)
    data = synthetic_complex(rng, n_lig=n, n_rec=20, n_bonds=2)
    data = pad_to(data._replace(lig_pos=np.asarray(mol.coords, np.float32) - data.original_center),
                  n + 6, 32, 4)
    crystal = np.asarray(data.lig_pos) + data.original_center
    poses = (crystal[None] + rng.randn(5, n + 6, 3).astype(np.float32)
             * np.array([0.3, 1.0, 2.0, 0.0, 4.0], np.float32)[:, None, None])
    kw = dict(elements=mol.elements, bonds=[(i, j) for i, j, _ in mol.bonds]) if topology else {}
    got = conf.generate_poses_for_complex(_FixedPoses(poses), data, 5, seed=3, **kw)
    ref = jconf.generate_poses_for_complex(_FixedPoses(poses), data, 5, seed=3, **kw)
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[0].shape == (5, n + 6, 3) and not got[0][:, n:].any()
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-9, atol=1e-9)
    assert got[1][3] == 0.0  # the crystal pose itself


STEP_CASES = {
    "cg_bce": (False, "bce"),
    "cg_ce": (False, "ce"),
    "cg_mse": (False, "mse"),
    "aa_bce": (True, "bce"),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_one_confidence_step_matches_jax(tables, case):
    all_atoms, kind = STEP_CASES[case]
    jtc, tc = _tcfgs(kind)
    js, jt, _, _ = tables
    jcfg, cfg = _configs(num_prot_emb_layers=0 if all_atoms else 1, num_conv_layers=2,
                         all_atoms=all_atoms, num_confidence_outputs=tc.num_outputs,
                         bn_axis_names=("batch",))
    datas = _complexes(all_atoms, BATCH, 0, seed=7)
    jmodel, variables, model = _pair(jcfg, cfg, datas[0], tables, seed=4)
    batch = stack_padded(datas)
    poses = np.stack([_poses(d, 1, 30 + i)[0] for i, d in enumerate(datas)])
    rmsds = np.array([1.0, 3.5, 7.0], np.float32)
    labels = tc.labels_from_rmsds(rmsds)

    step, tx = jconf.make_confidence_train_step(jmodel, jtc, js, jt)
    params, stats = variables["params"], variables["batch_stats"]
    jparams, jstats, jopt, jm = jax.jit(step)(
        params, stats, tx.init(params),
        (jax.tree.map(jnp.asarray, batch), jnp.asarray(poses), jnp.asarray(labels)),
        jax.random.PRNGKey(0))

    state = conf.create_confidence_train_state(model, tc)
    state, metrics = conf.make_confidence_train_step(model, tc)(
        state, to_device(batch, "cpu"), torch.from_numpy(poses), torch.from_numpy(labels),
        torch.Generator().manual_seed(0))
    for k in ("loss", "accuracy"):
        np.testing.assert_allclose(metrics[k].item(), float(jm[k]), rtol=METRIC_RTOL, atol=1e-7, err_msg=k)
    adam = jopt[0]
    grads_ref = {k: v / 0.1 for k, v in flat(adam.mu)}
    grads, new_params = port_tree(model, state.grads), port_tree(model, state.params)
    ref_params = dict(flat(jparams))
    # the leaves whose exact gradient is zero when the head starts with a
    # training-mode batch norm (chip_smoke.conf_zero_gradient_leaves: the
    # head's Dense biases before a norm, the last conv's bn bias) carry
    # only rounding noise, and Adam's first step moves such a weight by at
    # most lr in the noise's direction. Held to that: the noise within
    # GRAD_RTOL of the model's largest gradient.
    zero = chip_smoke.conf_zero_gradient_leaves(model)
    largest = max(np.abs(g).max() for g in grads_ref.values())
    for k in zero:
        assert max(np.abs(grads[k]).max(), np.abs(grads_ref[k]).max()) <= GRAD_RTOL * largest, k
        assert np.abs(new_params[k] - ref_params[k]).max() <= 2 * LR + 1e-6, k
    keep = lambda d: {k: v for k, v in d.items() if k not in zero}  # noqa: E731
    assert_leaves_close(keep(grads), keep(grads_ref), GRAD_RTOL, "grad")
    assert_params_after_adam(keep(new_params), keep(ref_params), grads_ref, LR, "params")
    assert int(state.opt_state.count) == int(adam.count) == 1
    assert_leaves_close(keep(port_tree(model, state.opt_state.mu)), keep(dict(flat(adam.mu))), GRAD_RTOL, "mu")
    assert_leaves_close(keep(port_tree(model, state.opt_state.nu)), keep(dict(flat(adam.nu))), 2 * GRAD_RTOL,
                        "nu")
    ours = dict(flat(flax_from_model(model)["batch_stats"]))
    for k, v in flat(jstats):
        np.testing.assert_allclose(ours[k], v, rtol=1e-4, atol=1e-5, err_msg=k)


def test_confidence_step_learns():
    """Regression (``tests/test_confidence_train.py``): training-mode logits
    must be alive. The head's batch norm takes its statistics over the
    batch's B pooled rows; over one complex's single row it would output
    zero (and relu'(0) = 0 would stop every gradient behind it), freezing
    training at chance (BCE = ln 2)."""
    rng = np.random.RandomState(0)
    data = synthetic_complex(rng, n_lig=10, n_rec=24, n_bonds=2)
    tc = conf.ConfidenceTrainConfig(rmsd_classification_cutoff=(2.0,), lr=1e-3)
    cfg = training_model_config(ScoreModelConfig(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=0,
                                                 confidence_mode=True, num_confidence_outputs=1))
    model = build_model(cfg)
    model.reset_parameters(torch.Generator().manual_seed(7))
    B = 4
    poses = np.stack([np.asarray(data.lig_pos) + (0 if i % 2 == 0 else rng.randn(3) * 8 + 20)
                      for i in range(B)]).astype(np.float32)
    labels = torch.tensor([1.0, 0.0] * (B // 2))
    batch = to_device(stack_padded([data] * B), "cpu")
    state = conf.create_confidence_train_state(model, tc)
    step = conf.make_confidence_train_step(model, tc)
    losses = []
    for i in range(40):
        state, m = step(state, batch, torch.from_numpy(poses), labels, torch.Generator().manual_seed(i))
        losses.append(float(m["loss"]))
    assert not np.allclose(losses[0], np.log(2.0), atol=1e-4) or losses[-1] < losses[0] - 0.05, \
        f"loss frozen at chance: {losses[:3]}"
    assert losses[-1] < 0.55, f"no learning: {losses[0]:.3f}->{losses[-1]:.3f}"


def test_head_dropout_keeps_and_scales():
    """``confidence_dropout`` in training mode: the head's dropout keeps
    each element with probability 1 - p and scales it by 1 / (1 - p); its
    masks come from the generator the step passes (the same seed, the same
    masks) and it is the identity in evaluation mode."""
    p = 0.5
    cfg = ScoreModelConfig(ns=16, nv=2, num_conv_layers=2, confidence_mode=True, confidence_dropout=p)
    model = build_model(cfg)
    model.reset_parameters(torch.Generator().manual_seed(1))
    datas = _complexes(False, 4, 0, seed=9)
    batch = to_device(stack_padded(datas), "cpu")
    poses = torch.from_numpy(np.stack([_poses(d, 1, i)[0] for i, d in enumerate(datas)]))
    seen = []
    hook = model.confidence_predictor.drop.register_forward_hook(
        lambda _m, inp, out: seen.append((inp[0].detach(), out.detach())))

    def run(seed, train=True):
        model.train(train)
        model.set_generator(torch.Generator().manual_seed(seed))
        with torch.no_grad():
            return model(batch, poses, torch.zeros(4))

    a, b, c = run(5), run(5), run(6)
    ev = run(5, train=False)
    hook.remove()
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    x = torch.cat([s[0].flatten() for s in seen[:6]])
    y = torch.cat([s[1].flatten() for s in seen[:6]])
    live = x != 0
    kept = y[live] != 0
    frac = kept.float().mean().item()
    n = int(live.sum())
    assert abs(frac - (1 - p)) < 4 * np.sqrt(p * (1 - p) / n), (frac, n)
    torch.testing.assert_close(y[live][kept], x[live][kept] / (1 - p))
    torch.testing.assert_close(seen[-1][1], seen[-1][0])  # evaluation: identity
    assert ev.shape == a.shape
