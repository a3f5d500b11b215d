"""The PyTorch port's CGScoreModel vs the JAX package on the CPU.

Flax parameters from ``CGScoreModel.init`` (perturbed so biases and
batch-norm statistics are not at their trivial values) go through
``state_dict_from_flax``; the same numpy complex goes through both models.
Tolerances are float32: 1e-4 relative on outputs that pass through ~10
layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdock_tpu.data import complexes as j_complexes
from diffdock_tpu.diffusion.so3 import SO3Config as JSO3Config, get_so3_tables as j_so3
from diffdock_tpu.diffusion.torus import TorusConfig as JTorusConfig, get_torus_tables as j_torus
from diffdock_tpu.models.config import ScoreModelConfig as JScoreModelConfig
from diffdock_tpu.models.score_model import CGScoreModel as JCGScoreModel
from diffdock_tpu_torch.data.complexes import bucket_sizes, pad_to, synthetic_complex, to_device
from diffdock_tpu_torch.diffusion.so3 import SO3Config, get_so3_tables
from diffdock_tpu_torch.diffusion.torus import TorusConfig, get_torus_tables
from diffdock_tpu_torch.models.config import ConfigError, ScoreModelConfig
from diffdock_tpu_torch.models.score_model import CGScoreModel
from diffdock_tpu_torch.utils.convert import state_dict_from_flax

SO3_SMALL = dict(n_eps=64, x_n=256, l_max=512)
TORUS_SMALL = dict(x_n=256, sigma_n=128, mc_samples=2000)
T = lambda a: torch.from_numpy(np.array(a))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tables():
    return (j_so3(JSO3Config(**SO3_SMALL)), j_torus(JTorusConfig(**TORUS_SMALL)),
            get_so3_tables(SO3Config(**SO3_SMALL), "cpu"), get_torus_tables(TorusConfig(**TORUS_SMALL), "cpu"))


def _init_params(jcfg, data, js, jt, seed):
    model = JCGScoreModel(jcfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), data, jnp.asarray(data.lig_pos),
                                 jnp.asarray(0.5), js, jt)
    rng = np.random.RandomState(seed)
    # perturb everything (biases, batch-norm statistics) off its init value;
    # variances stay positive
    return model, jax.tree_util.tree_map_with_path(
        lambda path, p: np.asarray(p) + (
            0.1 * np.abs(rng.randn(*p.shape)) if "var" in jax.tree_util.keystr(path)
            else 0.1 * rng.randn(*p.shape)).astype(np.float32),
        params,
    )


def test_synthetic_complex_and_padding_are_the_same_arrays():
    for kw in (dict(n_lig=10, n_rec=24, n_bonds=2), dict(n_lig=17, n_rec=70, n_bonds=5, lm_dim=3)):
        ours = synthetic_complex(np.random.RandomState(7), **kw)
        ref = j_complexes.synthetic_complex(np.random.RandomState(7), **kw)
        sizes = bucket_sizes(ours.n_lig, ours.n_rec, ours.n_bonds)
        assert sizes == j_complexes.bucket_sizes(ref.n_lig, ref.n_rec, ref.n_bonds)
        for a, b in zip(pad_to(ours, *sizes), j_complexes.pad_to(ref, *sizes)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("lm_dim,layers", [(0, (2, 1)), (6, (3, 2))])
def test_score_model_forward_matches_jax(tables, lm_dim, layers):
    js, jt, ps, pt = tables
    n_conv, n_emb = layers
    kw = dict(ns=8, nv=2, num_conv_layers=n_conv, num_prot_emb_layers=n_emb, lm_embedding_dim=lm_dim,
              dynamic_max_cross=lm_dim > 0)
    jcfg, cfg = JScoreModelConfig(**kw), ScoreModelConfig(**kw)
    data = synthetic_complex(np.random.RandomState(0), n_lig=10, n_rec=24, n_bonds=3, lm_dim=lm_dim)
    data = pad_to(data, 16, 32, 4)  # padded atoms, residues and bond slots
    jdata = j_complexes.ComplexData(*[None if a is None else jnp.asarray(a) for a in data])
    jmodel, params = _init_params(jcfg, jdata, js, jt, seed=lm_dim)

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
        out_nocache = model(tdata, T(poses), torch.tensor(t), ps, pt)

    # jitted: eager flax applies compile op by op and take much longer
    jcache = jax.jit(lambda p: jmodel.apply(p, jdata, method="embed_receptor"))(params)
    np.testing.assert_allclose(cache.node_attr.numpy(), np.asarray(jcache.node_attr), rtol=1e-4, atol=1e-4)
    if step is not None:
        jstep = jax.jit(lambda p, c: jmodel.apply(p, jdata, jnp.asarray(t), c, method="step_cache"))(
            params, jcache)
        np.testing.assert_allclose(step[0][0].numpy(), np.asarray(jstep[0]), rtol=1e-4, atol=1e-4)
    ref = jax.jit(jax.vmap(lambda p, q: jmodel.apply(p, jdata, q, jnp.asarray(t), js, jt),
                           in_axes=(None, 0)))(params, jnp.asarray(poses))
    for ours in (out, out_nocache):
        for name in ("tr", "rot", "tor"):
            np.testing.assert_allclose(getattr(ours, name).numpy(), np.asarray(getattr(ref, name)),
                                       rtol=1e-4, atol=1e-4, err_msg=name)
    assert np.all(out.tor[:, 3:].numpy() == 0.0)  # padded bond slot


def test_score_model_per_class_oracle_matches_merged_path(tables, monkeypatch):
    """The per-class branch of ``_tp_message_reduced`` stays the numeric
    oracle of the merged one, through a whole forward."""
    from diffdock_tpu_torch.models import tpconv

    _, _, ps, pt = tables
    cfg = ScoreModelConfig(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=1)
    data = to_device(synthetic_complex(np.random.RandomState(3), n_lig=9, n_rec=20, n_bonds=2), "cpu")
    model = CGScoreModel(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.eval()
    poses = data.lig_pos[None].repeat(2, 1, 1)
    with torch.no_grad():
        merged = model(data, poses, torch.tensor(0.4), ps, pt)
        orig = tpconv._tp_message_reduced
        monkeypatch.setattr(tpconv, "_tp_message_reduced",
                            lambda tp, fc, blk, contraction=None, dtype="float32":
                            orig(tp, fc, blk, merged=False, dtype=dtype))
        per_class = model(data, poses, torch.tensor(0.4), ps, pt)
    for a, b in zip(merged, per_class):
        if a is None:  # ScoreOutput.sidechain without the sidechain head
            assert b is None
            continue
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)


def test_unported_configurations_are_refused():
    # all_atoms is the all-atom model's (models/aa_model.py); confidence mode
    # is ported (tests/test_torch_port_confidence_head.py). The coarse-grained
    # class builds what JAX's class builds from the same config: the
    # depthwise variant (tests/test_torch_port_variants.py), and its own
    # architecture for old_architecture, which models/factory.py sends to the
    # old family (tests/test_torch_port_old_score.py). float16 stays refused,
    # as by the JAX CLIs' compute_dtype choices.
    for kw in (dict(all_atoms=True), dict(compute_dtype="float16")):
        with pytest.raises(ConfigError):
            CGScoreModel(ScoreModelConfig(**kw))
    for kw in (dict(old_architecture=True), dict(depthwise_convolution=True)):
        assert hasattr(CGScoreModel(ScoreModelConfig(**kw)), "conv_layers")
    # bfloat16 is ported (tests/test_torch_port_bf16.py): the conv layers take
    # it, the score heads stay float32 as in the JAX model
    bf = CGScoreModel(ScoreModelConfig(compute_dtype="bfloat16"))
    assert {m.dtype for m in (*bf.rec_emb_layers, *bf.lig_emb_layers, *bf.conv_layers)} == {"bfloat16"}
    assert bf.final_conv.dtype == bf.tor_bond_conv.dtype == "float32"
    assert not hasattr(CGScoreModel(ScoreModelConfig(confidence_mode=True)), "final_conv")
