"""The port's training pieces vs the JAX package's, on the CPU.

Draws and targets (``SO3Tables.sample_vec``/``score_vec``, the torus
``score``/``sample``/``p``, ``interp``, ``apply_noise`` fed JAX's own
draws rebuilt from its key), the losses, the train branch of
``IrrepsBatchNorm`` against JAX's under ``vmap`` with a named batch axis,
and the batch sampler
(``bucketed_batches``, ``stack_batch``) against JAX's. Inputs come from
numpy seeds; tolerances are float32 and stated at each check. fused_tp3's
gradient is in ``test_torch_port_train_tp3.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdock_tpu.data import complexes as j_complexes
from diffdock_tpu.data import datasets as jds
from diffdock_tpu.data import loaders as j_loaders
from diffdock_tpu.diffusion import so3 as j_so3
from diffdock_tpu.diffusion import torus as j_torus
from diffdock_tpu.diffusion.schedules import SigmaConfig as JSigmaConfig
from diffdock_tpu.models.score_model import ScoreOutput as JScoreOutput
from diffdock_tpu.ops import batch_norm as j_bn
from diffdock_tpu.train import losses as j_losses
from diffdock_tpu.train.noise import apply_noise as j_apply_noise
from diffdock_tpu_torch.data import datasets as ds
from diffdock_tpu_torch.data.complexes import ComplexData, pad_to, synthetic_complex, to_device
from diffdock_tpu_torch.data.loaders import stack_batch
from diffdock_tpu_torch.diffusion.schedules import SigmaConfig
from diffdock_tpu_torch.diffusion.so3 import SO3Config, get_so3_tables, interp
from diffdock_tpu_torch.diffusion.torus import TorusConfig, get_torus_tables
from diffdock_tpu_torch.models.config import ScoreModelConfig
from diffdock_tpu_torch.models.score_model import CGScoreModel, ScoreOutput
from diffdock_tpu_torch.ops.batch_norm import IrrepsBatchNorm
from diffdock_tpu_torch.train import losses
from diffdock_tpu_torch.train.noise import NoiseDraws, apply_noise
from tests.test_torch_port_datasets import SYNTH

SO3_SMALL = dict(n_eps=64, x_n=256, l_max=512)
TORUS_SMALL = dict(x_n=256, sigma_n=128, mc_samples=2000)
SIGMA_L = dict(tr_sigma_max=19.0)  # the diffdock_l preset's sigma ranges
T = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
N = lambda a: np.asarray(a)  # noqa: E731


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tables():
    return (j_so3.get_so3_tables(j_so3.SO3Config(**SO3_SMALL)),
            j_torus.get_torus_tables(j_torus.TorusConfig(**TORUS_SMALL)),
            get_so3_tables(SO3Config(**SO3_SMALL), "cpu"),
            get_torus_tables(TorusConfig(**TORUS_SMALL), "cpu"))


def jax_noise_draws(key, n_bonds: int):
    """The draws ``diffdock_tpu.train.noise.apply_noise`` makes from ``key``:
    the 4-way split, the Beta(1, 1) time, the translation normal, the split inside
    ``SO3Tables.sample_vec`` (uniform, then the axis normal), the torsion
    normals; as numpy (t, tr, rot_u, rot_dir, tor) of one complex."""
    k_t, k_tr, k_rot, k_tor = jax.random.split(key, 4)
    k_u, k_dir = jax.random.split(k_rot)
    return (N(jax.random.beta(k_t, 1.0, 1.0)), N(jax.random.normal(k_tr, (3,))),
            N(jax.random.uniform(k_u, ())), N(jax.random.normal(k_dir, (3,))),
            N(jax.random.normal(k_tor, (n_bonds,))))


def draws_from_keys(keys, n_bonds: int) -> NoiseDraws:
    """NoiseDraws of a batch, complex b drawn from ``keys[b]`` as JAX does."""
    per = [jax_noise_draws(k, n_bonds) for k in keys]
    return NoiseDraws(*[T(np.stack([p[i] for p in per]).astype(np.float32)) for i in range(5)])


def synthetic_batch(seed: int, n: int = 3, lm_dim: int = 0, bucket=(24, 48, 4)):
    """n synthetic complexes of different sizes padded to one bucket and
    stacked (numpy), with random LM features when ``lm_dim``."""
    rng = np.random.RandomState(seed)
    members = []
    for i in range(n):
        d = synthetic_complex(rng, n_lig=14 + 3 * i, n_rec=30 + 5 * i, n_bonds=1 + i, lm_dim=lm_dim)
        d = d._replace(rec_lm=rng.randn(*d.rec_lm.shape).astype(np.float32))
        members.append((str(i), d))
    return stack_batch(members, bucket)[1]


def test_interp_matches_jnp_interp_with_clamping_and_flat_rows():
    rng = np.random.RandomState(0)
    xp = np.sort(rng.rand(5, 12), axis=1).astype(np.float32)
    xp[1, 3:7] = xp[1, 3]  # a flat run (ties) inside a row
    xp[2, :4] = xp[2, 0]  # ties at the start
    xp[3, -3:] = xp[3, -1]  # ties at the end
    fp = rng.randn(5, 12).astype(np.float32)
    x = np.concatenate([rng.rand(5) * 1.4 - 0.2, xp[1, 3:4], xp[2, :1], xp[3, -1:], [-5.0, 7.0]])
    x = x.astype(np.float32)
    rows = np.concatenate([np.arange(5), [1, 2, 3, 0, 4]])
    ref = np.stack([np.asarray(jnp.interp(x[i], xp[r], fp[r])) for i, r in enumerate(rows)])
    ours = interp(T(x), T(xp[rows]), T(fp[rows])).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)  # float32 rounding only
    # a shared knot vector
    ours1 = interp(T(x), T(xp[0]), T(fp[rows])).numpy()
    ref1 = np.stack([np.asarray(jnp.interp(x[i], xp[0], fp[r])) for i, r in enumerate(rows)])
    np.testing.assert_allclose(ours1, ref1, rtol=1e-6, atol=1e-6)


def test_so3_sample_and_score_match_jax(tables):
    js, _, ps, _ = tables
    rng = np.random.RandomState(1)
    eps = (10 ** rng.uniform(-2.5, 0.5, size=16)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref = js.sample_vec(key, jnp.asarray(eps))
    k_u, k_dir = jax.random.split(key)
    u = jax.random.uniform(k_u, eps.shape)
    direction = jax.random.normal(k_dir, eps.shape + (3,))
    ours = ps.sample_vec(T(eps), T(u), T(direction))
    np.testing.assert_allclose(ours.numpy(), N(ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ps.score_vec(T(eps), ours).numpy(),
                               N(js.score_vec(jnp.asarray(eps), ref)), rtol=1e-5, atol=1e-5)


def test_torus_score_sample_and_density_match_jax(tables):
    _, jt, _, pt = tables
    rng = np.random.RandomState(2)
    sigma = (10 ** rng.uniform(-1.5, 0.5, size=(4, 6))).astype(np.float32)
    key = jax.random.PRNGKey(5)
    x = jt.sample(key, jnp.asarray(sigma))
    ours = pt.sample(T(sigma), T(jax.random.normal(key, sigma.shape)))
    np.testing.assert_allclose(ours.numpy(), N(x), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(pt.score(T(N(x)), T(sigma)).numpy(), N(jt.score(x, jnp.asarray(sigma))))
    np.testing.assert_array_equal(pt.p(T(N(x)), T(sigma)).numpy(), N(jt.p(x, jnp.asarray(sigma))))


def test_apply_noise_matches_jax_on_its_own_key(tables):
    js, jt, ps, pt = tables
    batch = synthetic_batch(0)
    keys = jax.random.split(jax.random.PRNGKey(7), 3)
    jbatch = jax.tree.map(jnp.asarray, j_complexes.ComplexData(*batch))
    ref = jax.vmap(lambda d, k: j_apply_noise(k, d, JSigmaConfig(**SIGMA_L), js, jt))(jbatch, keys)
    ours = apply_noise(to_device(batch, "cpu"), draws_from_keys(keys, 4), SigmaConfig(**SIGMA_L),
                       ps, pt)
    np.testing.assert_allclose(ours.t.numpy(), N(ref.t), rtol=1e-6)
    # poses within 1e-5 A (float32 rounding of the rigid and torsion moves)
    np.testing.assert_allclose(ours.pos.numpy(), N(ref.pos), atol=1e-5)
    for name in ("tr_score", "rot_score", "tor_score"):
        a, b = getattr(ours, name).numpy(), N(getattr(ref, name))
        # scores within 1e-5 of their scale
        assert np.abs(a - b).max() <= 1e-5 * max(np.abs(b).max(), 1.0), name


def _random_parts(seed: int, B: int = 5, nb: int = 4):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    t = rng.rand(B).astype(np.float32)
    rot_mask = rng.rand(B, nb) > 0.3
    return (f(B, 3), f(B, 3), f(B, nb)), (f(B, 3), f(B, 3), f(B, nb)), t, rot_mask


def test_losses_match_jax(tables):
    js, jt, ps, pt = tables
    (ptr, prot, ptor), (str_, srot, stor), t, rot_mask = _random_parts(3)
    from diffdock_tpu.train.noise import NoisySample as JNoisySample
    from diffdock_tpu_torch.train.noise import NoisySample

    jsample = JNoisySample(pos=jnp.zeros((5, 2, 3)), t=jnp.asarray(t), tr_score=jnp.asarray(str_),
                           rot_score=jnp.asarray(srot), tor_score=jnp.asarray(stor))
    jparts = jax.vmap(lambda o, s, m: j_losses.per_complex_losses(
        o, s, m, JSigmaConfig(**SIGMA_L), js, jt))(
        JScoreOutput(jnp.asarray(ptr), jnp.asarray(prot), jnp.asarray(ptor)), jsample,
        jnp.asarray(rot_mask))
    parts = losses.per_complex_losses(
        ScoreOutput(T(ptr), T(prot), T(ptor)),
        NoisySample(torch.zeros(5, 2, 3), T(t), T(str_), T(srot), T(stor)), T(rot_mask),
        SigmaConfig(**SIGMA_L), ps, pt)
    for name in losses.LossParts._fields:
        np.testing.assert_allclose(getattr(parts, name).numpy(), N(getattr(jparts, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    jloss, jmetrics = j_losses.total_loss(jparts, 0.3, 0.5, 0.2)
    loss, metrics = losses.total_loss(parts, 0.3, 0.5, 0.2)
    assert set(metrics) == set(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(metrics[k].numpy(), N(jmetrics[k]), rtol=1e-5, err_msg=k)
    # sigma intervals: empty buckets NaN in both
    jm, m = j_losses.sigma_interval_metrics(jparts), losses.sigma_interval_metrics(parts)
    assert set(m) == set(jm)
    for k in m:
        np.testing.assert_allclose(m[k].numpy(), N(jm[k]), rtol=1e-5, equal_nan=True, err_msg=k)
    assert np.isnan(m["tr_loss_by_sigma"].numpy()).any()


def test_aux_sidechain_parts_match_jax():
    rng = np.random.RandomState(4)
    pred = rng.randn(20, 10).astype(np.float32)
    scv = rng.randn(20, 10).astype(np.float32)
    scv[rng.rand(20, 10) < 0.2] = np.nan  # undefined chis and vectors
    mask = rng.rand(20) > 0.25
    ref = j_losses.aux_sidechain_parts(jnp.asarray(pred), jnp.asarray(scv), jnp.asarray(mask))
    ours = losses.aux_sidechain_parts(T(pred), T(scv), T(mask))
    assert set(ours) == set(ref)
    for k in ours:
        np.testing.assert_allclose(ours[k].numpy(), N(ref[k]), rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("irreps", ["6x0e + 3x1o + 2x0o + 2x2e", "4x1o + 2x0o"])
def test_batch_norm_train_branch_matches_jax_vmap(irreps):
    """Statistics over every valid row of every complex (padded rows out);
    a complex with no valid row still counts one, as the JAX module's
    per-complex max(count, 1) under the psum does."""
    jbn = j_bn.IrrepsBatchNorm(irreps=j_bn.Irreps(irreps), axis_names=("batch",))
    rng = np.random.RandomState(6)
    x = rng.randn(4, 9, jbn.irreps.dim).astype(np.float32)
    mask = rng.rand(4, 9) > 0.3
    mask[2] = False  # a complex with no valid row
    v = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x[0]))
    v = jax.tree.map(lambda p: np.asarray(p) + 0.3 * np.abs(rng.randn(*p.shape)).astype(np.float32), v)
    out, mut = jax.vmap(lambda xi, mi: jbn.apply(v, xi, mi, train=True, mutable=["batch_stats"]),
                        axis_name="batch")(jnp.asarray(x), jnp.asarray(mask))
    ours = IrrepsBatchNorm(irreps)
    with torch.no_grad():
        ours.weight.copy_(T(v["params"]["weight"]))
        ours.bias.copy_(T(v["params"]["bias"]))
        ours.running_mean.copy_(T(v["batch_stats"]["mean"]))
        ours.running_var.copy_(T(v["batch_stats"]["var"]))
    ours.train()
    got = ours(T(x), T(mask))
    np.testing.assert_allclose(got.detach().numpy(), N(out), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours.running_mean.numpy(), N(mut["batch_stats"]["mean"][0]), atol=1e-5)
    np.testing.assert_allclose(ours.running_var.numpy(), N(mut["batch_stats"]["var"][0]), atol=1e-5)
    ours.eval()  # evaluation mode: the updated running statistics, no mask
    ref_eval = jbn.apply({"params": v["params"], "batch_stats": jax.tree.map(lambda a: a[0],
                                                                             mut["batch_stats"])},
                         jnp.asarray(x[0]), train=False)
    np.testing.assert_allclose(ours(T(x[:1]))[0].detach().numpy(), N(ref_eval), rtol=1e-5, atol=1e-5)


def test_joint_layer_normalizes_ligand_and_receptor_rows_together():
    """The joint layer's batch norm gets [lig_mask, rec_mask] along the
    receiver axis (``diffdock_tpu/models/tpconv.py:381-386``)."""
    cfg = ScoreModelConfig(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=1)
    model = CGScoreModel(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    batch = to_device(synthetic_batch(1), "cpu")
    seen = []
    layer = model.conv_layers[0]
    layer.bn.register_forward_hook(lambda m, inp, out: seen.append(inp[1]))
    model.train()
    model(batch, batch.lig_pos, torch.full((3,), 0.4), *_port_tables())
    want = torch.cat([batch.lig_mask, batch.rec_mask], dim=1)
    assert seen and torch.equal(seen[0].bool(), want)


def _port_tables():
    return get_so3_tables(SO3Config(**SO3_SMALL), "cpu"), get_torus_tables(TorusConfig(**TORUS_SMALL), "cpu")


BATCH_NAMES = ("syn131_l25r90", "syn128_l41r90", "syn044_l9r90", "syn046_l34r95",
               "syn091_l38r96", "syn035_l22r99", "syn001_l24r104", "syn132_l23r105")


@pytest.fixture(scope="module")
def shared_cache(tmp_path_factory):
    """One dataset cache of BATCH_NAMES (with ESM), featurized by the JAX
    package and served to both."""
    root = tmp_path_factory.mktemp("batching")
    split = root / "names.txt"
    split.write_text("\n".join(BATCH_NAMES) + "\n")
    esm = str(SYNTH / "_esm")
    jd = jds.ComplexDataset(jds.pdbbind_specs(str(SYNTH), str(split), esm_embeddings_dir=esm),
                            jds.DatasetConfig(cache_dir=str(root / "cache")))
    jd.preprocess(num_workers=0)
    ours = ds.ComplexDataset(ds.pdbbind_specs(str(SYNTH), str(split), esm_embeddings_dir=esm),
                             ds.DatasetConfig(cache_dir=str(root / "cache")))
    ours.preprocess(num_workers=0)
    return jd, ours


def _same_batch(a, b):
    (na, da), (nb, db) = a, b
    assert na == nb
    for f in ComplexData._fields:
        x, y = getattr(da, f), getattr(db, f)
        if x is None or y is None:
            assert x is None and y is None, f
        else:
            np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bucketed_batches_match_jax(shared_cache, seed):
    jd, ours = shared_cache
    ref = list(jd.bucketed_batches(3, shuffle_seed=seed))
    got = list(ours.bucketed_batches(3, shuffle_seed=seed))
    assert len(got) == len(ref) > 1
    for a, b in zip(got, ref):
        _same_batch(a, b)
    # a short last chunk of a bucket is kept, as JAX's drop_last=False keeps it
    assert [n for n, _ in got] == [n for n, _ in jd.bucketed_batches(3, shuffle_seed=seed, drop_last=False)]
    assert any(len(n) < 3 for n, _ in got)


def test_stack_batch_widens_bonded_neighbours_as_jax_does():
    """A hypervalent member (bonded width 6) and a small receptor (kNN
    width 7) widen every member of the batch."""
    rng = np.random.RandomState(11)
    members = []
    for i, (nl, nr) in enumerate(((12, 40), (15, 8), (10, 30))):
        d = synthetic_complex(rng, n_lig=nl, n_rec=nr, n_bonds=2)
        if i == 0:
            d = pad_to(d, nl, nr, 2, kb=6)  # bonded width 6
        members.append((f"c{i}", d))
    ours = stack_batch(members, (16, 48, 8))
    ref = j_loaders._stack([(n, j_complexes.ComplexData(*d)) for n, d in members], (16, 48, 8))
    assert ours[1].lig_bond_nbr.shape[-1] == 6
    _same_batch(ours, ref)


@pytest.fixture(scope="module")
def default_so3_rows():
    """E[score^2]^(1/2) rows of the port's and the JAX package's SO(3)
    tables at the default grid."""
    import warnings

    from diffdock_tpu_torch.diffusion import so3

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return (so3._generate_tables(so3.SO3Config())[3],
                j_so3._generate_tables(j_so3.SO3Config())[3])


def test_so3_score_norm_rows_are_finite_where_the_jax_table_is_not(default_so3_rows):
    """At the default grid the JAX package's E[score^2] is NaN in 143 rows
    (eps 0.10-0.35) and inf in 42 (eps 0.073-0.100): the series' density
    vanishes at two angles, where the score is 0/0 or x/0, so a training
    draw in the NaN rows gives a NaN loss. The port leaves those terms out:
    finite rows everywhere. In 87 finite rows (eps 0.030-0.072) JAX's value
    is 2.4 to 1e66 times the small-eps limit sqrt(3/pi)/eps, which the true
    value never exceeds: rounding noise in the tail of a narrow density,
    divided by noise. The port leaves the terms below the series' rounding
    out there (within 0.1 % of the limit, where JAX's rows around them lie).
    Every other row is bit-identical to JAX's."""
    ours, ref = default_so3_rows
    bad = ~np.isfinite(ref)
    eps = 10 ** np.linspace(np.log10(5e-4), np.log10(4.0), 2000)
    limit = np.sqrt(3.0 / np.pi) / eps
    with np.errstate(invalid="ignore"):
        noisy = np.isfinite(ref) & (ref > 1.1 * limit)
    assert np.isnan(ref).sum() == 143 and np.isinf(ref).sum() == 42 and np.isfinite(ours).all()
    assert noisy.sum() == 87 and eps[noisy].min() > 0.03 and eps[noisy].max() < 0.072
    np.testing.assert_array_equal(ours[~bad & ~noisy], ref[~bad & ~noisy])
    assert eps[bad].min() > 0.07 and eps[bad].max() < 0.35
    np.testing.assert_allclose(ours[noisy], limit[noisy], rtol=1e-3)
    # the repaired rows continue their neighbours smoothly
    i = np.flatnonzero(bad | noisy)
    assert np.all(np.abs(ours[i] - ours[i - 1]) < 0.05 * ours[i - 1])


@pytest.mark.parametrize("steps,actual,landed", [
    (20, 19, (0.4, 0.3, 0.2, 0.15, 0.1)),  # the dock's default recipe
    (8, 8, (0.125,)),  # the train CLI's validation dock (--inference_steps 8)
    (4, 4, ()),  # chip_smoke.py phase E's validation dock
])
def test_dock_schedules_on_repaired_so3_rows(default_so3_rows, steps, actual, landed):
    """The rows the dock's ``scale_by_sigma`` reads (``score_norm`` of the
    DiffDock-L rot sigma at each step) are JAX's own, except at the steps
    ``landed``: there JAX's row is NaN, so the JAX dock's rotation score is
    NaN and its NaN guard zeroes it, where the port's dock applies the
    repaired, finite score."""
    from diffdock_tpu_torch.diffusion import so3
    from diffdock_tpu_torch.diffusion.schedules import t_to_sigma
    from diffdock_tpu_torch.inference.sampler import SamplerConfig
    from diffdock_tpu_torch.models.config import PRESETS

    ours, ref = default_so3_rows
    sc = SamplerConfig(inference_steps=steps, actual_steps=actual)
    t = torch.tensor(sc.schedule()[: sc.num_steps], dtype=torch.float32)
    _, rot_sigma, _ = t_to_sigma(t, t, t, PRESETS["diffdock_l"].sigma)
    rows = so3.SO3Tables(so3.SO3Config(), *[None] * 4)._eps_idx(rot_sigma).numpy()
    same = ours[rows] == ref[rows]
    assert np.isnan(ref[rows][~same]).all() and np.isfinite(ours[rows]).all()
    np.testing.assert_allclose(t.numpy()[~same], landed, atol=1e-6)