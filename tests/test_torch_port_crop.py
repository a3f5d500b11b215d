"""The receptor crop of ``crop_beyond`` in the port against the JAX
package on the CPU, the cases of ``tests/test_crop.py``: the mask crop
equals the physical crop (coarse-grained score model and all-atom
confidence model), a huge cutoff changes nothing, pocket compaction equals
the mask crop and picks JAX's residues in JAX's order (``lax.top_k``'s
ties to the lower index, tied distances included), the host pre-crop and
its bucket, and the dock with ``crop_beyond``, with and without
``pocket_capacity``, against the JAX pipeline from its own draws.

Tolerances: model outputs 1e-4 against JAX and 2e-4 between the two crops
of one package (``tests/test_crop.py``'s); poses 1e-3 Angstrom, as the
dock tests; index sets and host arrays exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdock_tpu.data import complexes as jc
from diffdock_tpu.inference.pipeline import DockingPipeline as JDockingPipeline
from diffdock_tpu.inference.sampler import SamplerConfig as JSamplerConfig
from diffdock_tpu.models.old_models import OldAAScoreModel as JOldAA
from diffdock_tpu.models.score_model import CGScoreModel as JCGScoreModel
from diffdock_tpu_torch.data import complexes as pc
from diffdock_tpu_torch.inference.pipeline import DockingPipeline
from diffdock_tpu_torch.inference.sampler import SamplerConfig
from diffdock_tpu_torch.models.config import ScoreModelConfig
from diffdock_tpu_torch.models.old_models import OldAAScoreModel
from diffdock_tpu_torch.models.score_model import CGScoreModel
from diffdock_tpu_torch.ops import fused_tp3 as ft
from diffdock_tpu_torch.utils.convert import state_dict_from_flax
from tests.test_torch_port_confidence import _conf_kw, _perturbed, tables  # noqa: F401
from tests.test_torch_port_dock import _jax_noise, setup  # noqa: F401
from tests.test_torch_port_model import _init_params

T = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
KW = dict(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=1)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jnp(data):
    return jax.tree.map(jnp.asarray, data)


def _score_models(tables, seed=0, n_rec=24):
    js, jt, ps, pt = tables
    raw = pc.synthetic_complex(np.random.RandomState(seed), n_lig=8, n_rec=n_rec, n_bonds=2)
    jcfg = jc.ScoreModelConfig(**KW) if hasattr(jc, "ScoreModelConfig") else None
    from diffdock_tpu.models.config import ScoreModelConfig as JConfig

    jcfg = JConfig(**KW)
    jmodel, params = _init_params(jcfg, _jnp(raw), js, jt, seed)
    model = CGScoreModel(ScoreModelConfig(**KW))
    model.load_state_dict(state_dict_from_flax(params, ScoreModelConfig(**KW)), strict=True)
    return raw, jmodel, params, model.eval()


def _score(model, data, pos, tables, **kw):
    with torch.no_grad():
        out = model(pc.to_device(data, "cpu"), T(pos)[None], torch.tensor(0.5), tables[2], tables[3], **kw)
    return np.concatenate([out.tr.numpy(), out.rot.numpy(), out.tor.numpy()], -1)[0]


def _jscore(jmodel, params, data, pos, tables, **kw):
    out = jax.jit(lambda p, d, q, k: jmodel.apply(p, d, q, jnp.asarray(0.5), tables[0], tables[1], **k))(
        params, _jnp(data), jnp.asarray(pos), kw)
    return np.concatenate([np.asarray(out.tr), np.asarray(out.rot), np.asarray(out.tor)], -1)


def test_keep_mask_and_physical_crop_equal_jax():
    raw = pc.synthetic_complex(np.random.RandomState(0), n_lig=8, n_rec=24, n_bonds=2)
    args = (np.asarray(raw.rec_pos), np.asarray(raw.rec_mask), np.asarray(raw.lig_pos)[None],
            np.asarray(raw.lig_mask))
    keep = pc.rec_keep_mask(*args, 12.0)
    np.testing.assert_array_equal(keep, jc.rec_keep_mask(*args, 12.0))
    assert 0 < keep.sum() < raw.n_rec
    tkeep = pc.rec_keep_mask(*[T(a) for a in args], 12.0)
    np.testing.assert_array_equal(tkeep.numpy(), keep)
    for a, b in zip(pc.crop_complex(raw, keep), jc.crop_complex(raw, keep)):
        if a is not None:
            np.testing.assert_array_equal(a, b)
    for a, b in zip(pc.apply_rec_keep(pc.to_device(raw, "cpu"), tkeep), jc.apply_rec_keep(_jnp(raw), keep)):
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    aa = pc.synthetic_aa_complex(np.random.RandomState(2), n_lig=8, n_rec=20, n_bonds=2, atoms_per_res=3)
    akeep = pc.rec_keep_mask(np.asarray(aa.base.rec_pos), np.asarray(aa.base.rec_mask),
                             np.asarray(aa.base.lig_pos)[None], np.asarray(aa.base.lig_mask), 12.0)
    ours, ref = pc.crop_aa_complex(aa, akeep), jc.crop_aa_complex(aa, akeep)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_mask_crop_equals_physical_crop(tables):
    raw, jmodel, params, model = _score_models(tables)
    keep = pc.rec_keep_mask(np.asarray(raw.rec_pos), np.asarray(raw.rec_mask),
                            np.asarray(raw.lig_pos)[None], np.asarray(raw.lig_mask), 12.0)
    assert 0 < keep.sum() < raw.n_rec
    masked = _score(model, raw, raw.lig_pos, tables, rec_keep=T(keep))
    cropped = pc.pad_to(pc.crop_complex(raw, keep), raw.n_lig, raw.n_rec, raw.n_bonds)
    np.testing.assert_allclose(masked, _score(model, cropped, raw.lig_pos, tables), atol=2e-4)
    ref = _jscore(jmodel, params, raw, raw.lig_pos, tables, rec_keep=jnp.asarray(keep))
    np.testing.assert_allclose(masked, ref, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="rec_cache"):
        model(pc.to_device(raw, "cpu"), T(raw.lig_pos)[None], torch.tensor(0.5), tables[2], tables[3],
              rec_cache=model.embed_receptor(pc.to_device(raw, "cpu")), rec_keep=T(keep))


def test_huge_cutoff_is_noop(tables):
    raw, _, _, model = _score_models(tables, seed=1, n_rec=16)
    keep = pc.rec_keep_mask(T(raw.rec_pos), T(raw.rec_mask), T(raw.lig_pos)[None], T(raw.lig_mask), 1e6)
    assert bool(keep.all())
    np.testing.assert_allclose(_score(model, raw, raw.lig_pos, tables, rec_keep=keep),
                               _score(model, raw, raw.lig_pos, tables), atol=1e-5)


def test_aa_mask_crop_equals_physical_crop(tables):
    """The all-atom confidence model (the shipped architecture): its mask
    crop equals the physical crop and JAX's."""
    js, jt, ps, pt = tables
    from diffdock_tpu.models.config import ScoreModelConfig as JConfig

    kw = _conf_kw(True, 0, 2)
    raw = pc.synthetic_aa_complex(np.random.RandomState(2), n_lig=8, n_rec=20, n_bonds=2, atoms_per_res=3)
    jmodel = JOldAA(JConfig(**kw))
    params = _perturbed(jax.jit(jmodel.init)(jax.random.PRNGKey(2), _jnp(raw), jnp.asarray(raw.base.lig_pos),
                                             jnp.asarray(0.0), js, jt), 2)
    cfg = ScoreModelConfig(**kw)
    model = OldAAScoreModel(cfg)
    model.load_state_dict(state_dict_from_flax(params, cfg), strict=True)
    model.eval()
    b = raw.base
    keep = pc.rec_keep_mask(np.asarray(b.rec_pos), np.asarray(b.rec_mask), np.asarray(b.lig_pos)[None],
                            np.asarray(b.lig_mask), 12.0)
    assert 0 < keep.sum() < b.n_rec
    pos = T(b.lig_pos)[None]
    with torch.no_grad():
        masked = model(pc.to_device(raw, "cpu"), pos, 0.0, rec_keep=T(keep)).numpy()
        cropped = pc.pad_aa_to(pc.crop_aa_complex(raw, keep), b.n_lig, b.n_rec, b.n_bonds, raw.n_atoms)
        phys = model(pc.to_device(cropped, "cpu"), pos, 0.0).numpy()
    np.testing.assert_allclose(masked, phys, atol=2e-4)
    ref = jax.jit(lambda p, d: jmodel.apply(p, d, d.base.lig_pos, jnp.asarray(0.0), js, jt,
                                            rec_keep=jnp.asarray(keep)))(params, _jnp(raw))
    np.testing.assert_allclose(masked[0], np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_compact_receptor_equals_mask_crop(tables):
    raw, jmodel, params, model = _score_models(tables, seed=3)
    td = pc.to_device(raw, "cpu")
    idx, valid = pc.pocket_indices(td.rec_pos, td.rec_mask, td.lig_pos[None], td.lig_mask, 12.0, 16)
    jidx, jvalid = jc.pocket_indices(jnp.asarray(raw.rec_pos), jnp.asarray(raw.rec_mask),
                                     jnp.asarray(raw.lig_pos)[None], jnp.asarray(raw.lig_mask), 12.0, 16)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    keep = pc.rec_keep_mask(td.rec_pos, td.rec_mask, td.lig_pos[None], td.lig_mask, 12.0)
    assert 0 < int(keep.sum()) <= 16 and int(valid.sum()) == int(keep.sum())
    assert set(idx[valid].tolist()) == set(torch.nonzero(keep)[:, 0].tolist())
    pocket = pc.compact_receptor(td, idx, valid)
    jpocket = jc.compact_receptor(_jnp(raw), jidx, jvalid)
    for a, b in zip(pocket, jpocket):
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert pocket.rec_mask.shape[0] == 16
    masked = _score(model, raw, raw.lig_pos, tables, rec_keep=keep)
    with torch.no_grad():
        out = model(pocket, td.lig_pos[None], torch.tensor(0.5), tables[2], tables[3])
    np.testing.assert_allclose(np.concatenate([out.tr, out.rot, out.tor], -1)[0], masked, atol=2e-4)


@pytest.mark.parametrize("ties", [False, True])
def test_capacity_overflow_picks_jax_indices(ties):
    """More residues within the cutoff than the capacity: the nearest win,
    the same indices in the same order as ``lax.top_k``, also where
    distances tie exactly (integer coordinates) and among padding rows."""
    rng = np.random.RandomState(4)
    if ties:
        rec_pos = rng.randint(-2, 3, (40, 3)).astype(np.float32)
        lig_pos = np.zeros((3, 3), np.float32)
        lig_pos[1] = [1, 0, 0]
        rec_mask = np.ones(40, bool)
        rec_mask[[3, 17, 30]] = False
    else:
        raw = pc.synthetic_complex(rng, n_lig=8, n_rec=24, n_bonds=2)
        rec_pos, lig_pos, rec_mask = raw.rec_pos, raw.lig_pos, np.asarray(raw.rec_mask).copy()
    lig_mask = np.ones(lig_pos.shape[0], bool)
    lig_mask[-1] = False
    poses = np.stack([lig_pos, lig_pos + 1.0])
    for cap, cutoff in ((4, 1e9), (12, 3.0), (len(rec_pos), 2.0)):
        idx, valid = pc.pocket_indices(T(rec_pos), T(rec_mask), T(poses), T(lig_mask), cutoff, cap)
        jidx, jvalid = jc.pocket_indices(jnp.asarray(rec_pos), jnp.asarray(rec_mask), jnp.asarray(poses),
                                         jnp.asarray(lig_mask), cutoff, cap)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))


def _dock_pair(setup, crop_beyond, pocket_capacity, pre_crop_radius=None, confidence=False):
    js, jt, ps, pt, jcfg, cfg, params = setup
    # tr_sigma_max 5 A keeps the poses near the receptor, where the crop
    # keeps some residues and drops others
    from diffdock_tpu.diffusion.schedules import SigmaConfig as JSigma
    from diffdock_tpu_torch.diffusion.schedules import SigmaConfig

    jcfg = dataclasses.replace(jcfg, crop_beyond=crop_beyond, sigma=JSigma(tr_sigma_max=5.0))
    cfg = dataclasses.replace(cfg, crop_beyond=crop_beyond, sigma=SigmaConfig(tr_sigma_max=5.0))
    jdata = jc.synthetic_complex(np.random.RandomState(0), n_lig=10, n_rec=40, n_bonds=2)
    data = pc.synthetic_complex(np.random.RandomState(0), n_lig=10, n_rec=40, n_bonds=2)
    conf = {}
    jconf = {}
    if confidence:
        from diffdock_tpu.models.config import ScoreModelConfig as JConfig
        from diffdock_tpu.models.old_models import OldCGScoreModel as JOldCG

        ckw = _conf_kw(False, 0, 2, crop_beyond=8.0)
        jm = JOldCG(JConfig(**ckw))
        cparams = _perturbed(jax.jit(jm.init)(jax.random.PRNGKey(7), _jnp(jdata), jnp.asarray(jdata.lig_pos),
                                              jnp.asarray(0.0), js, jt), 7)
        jconf = dict(confidence_cfg=JConfig(**ckw), confidence_params=cparams)
        conf = dict(confidence_cfg=ScoreModelConfig(**ckw),
                    confidence_weights=state_dict_from_flax(cparams, ScoreModelConfig(**ckw)))
    steps = dict(inference_steps=3, actual_steps=3)
    jpipe = JDockingPipeline(jcfg, params, JSamplerConfig(**steps), so3_tables=js, torus_tables=jt,
                             pocket_capacity=pocket_capacity, pre_crop_radius=pre_crop_radius, **jconf)
    pipe = DockingPipeline(cfg, state_dict_from_flax(params, cfg), SamplerConfig(**steps), ps, pt,
                           device="cpu", pocket_capacity=pocket_capacity, pre_crop_radius=pre_crop_radius,
                           **conf)
    return jpipe, pipe, jdata, data


@pytest.mark.parametrize("pocket_capacity", [None, 16])
def test_dock_with_crop_matches_jax(setup, pocket_capacity):
    """crop_beyond 5 A (each step keeps 3 tr_sigma + 5 A), by mask or
    compacted to 16 residues, with a confidence model that crops at 8 A."""
    jpipe, pipe, jdata, data = _dock_pair(setup, 5.0, pocket_capacity, confidence=True)
    assert pipe.pre_crop_radius == jpipe.pre_crop_radius
    ref = jpipe.dock_complex(jdata, num_poses=2, seed=3)
    before = ft.counts.as_dict()
    res = pipe.dock_complex(data, num_poses=2, seed=3, noise=_jax_noise(3))
    after = ft.counts.as_dict()
    # no cache under the crop: per step 1 receptor layer, the layer-0
    # rec<-rec block, 2 ligand blocks, 3 + 1 and 3 joint blocks, center and
    # torsion heads; then the confidence model's 3 * 2 + 2 * 1 blocks
    assert after["fused_tp3_reference"] - before["fused_tp3_reference"] == 3 * 13 + 8
    np.testing.assert_allclose(res.poses, ref.poses, rtol=0, atol=1e-3)
    np.testing.assert_allclose(res.confidence, ref.confidence, rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(res.order, ref.order)
    # the crop changed the dock: without it the poses are elsewhere
    _, whole, _, _ = _dock_pair(setup, None, None)
    assert np.abs(whole.dock_complex(data, num_poses=2, seed=3, noise=_jax_noise(3)).poses - res.poses).max() > 1e-2


def test_pre_crop_and_bucket_equal_jax(setup):
    jpipe, pipe, jdata, data = _dock_pair(setup, 5.0, None, pre_crop_radius=9.0)
    jcrop, _ = jpipe._pre_crop_host(jdata, None)
    ours, _ = pipe.pre_crop(data)
    assert ours.n_rec == jcrop.n_rec < data.n_rec
    for a, b in zip(ours, jcrop):
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert pipe.dock_bucket(data)[0] == jc.bucket_sizes(jcrop.n_lig, jcrop.n_rec, jcrop.n_bonds)
    assert pipe.effective_pose_chunk(data, 5) == jpipe.effective_pose_chunk(jdata, 5)
    assert pipe.pre_crop(ours)[0] is ours  # a second crop changes nothing
    ref = jpipe.dock_complex(jdata, num_poses=2, seed=1)
    res = pipe.dock_complex(data, num_poses=2, seed=1, noise=_jax_noise(3))
    np.testing.assert_allclose(res.poses, ref.poses, rtol=0, atol=1e-3)
    # the default radius covers every step's crop, as in JAX
    _, dpipe, _, _ = _dock_pair(setup, 5.0, None)
    assert dpipe.pre_crop_radius == pytest.approx(3 * 5.0 * 1.4601642460337794 + 5.0 + 10.0)
