"""The Fourier time embedding of the port against the JAX package.

Its frequencies are ``jax.random.normal(PRNGKey(0), (dim // 2,))`` times the
scale; the port draws them in numpy (``utils/threefry.py``: Threefry-2x32
as JAX applies it with ``jax_threefry_partitionable``, JAX's uniform
transform and XLA's float32 ``ErfInv`` with its CPU ``log1p``). They are
held to JAX's bits exactly, and so are the intermediate bits, uniforms and
XLA's ``log1p``. The embedding itself, sin and cos of those frequencies
times 2 pi t, differs only in the last bit of the two libraries' sine and
cosine of arguments up to a few 1e5: within 1e-6 absolute. A score model
with ``embedding_type="fourier"`` then matches JAX's at the model tests'
1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdock_tpu.diffusion.time_embed import get_timestep_embedding as j_embedding
from diffdock_tpu.models.config import ScoreModelConfig as JScoreModelConfig
from diffdock_tpu.models.factory import build_model as j_build_model
from diffdock_tpu_torch.data.complexes import pad_to, synthetic_complex, to_device
from diffdock_tpu_torch.diffusion.time_embed import fourier_frequencies, get_timestep_embedding
from diffdock_tpu_torch.models.config import ScoreModelConfig
from diffdock_tpu_torch.models.factory import build_model
from diffdock_tpu_torch.utils import threefry
from diffdock_tpu_torch.utils.convert import state_dict_from_flax
from tests.test_torch_port_confidence import _perturbed, tables  # noqa: F401


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


SEEDS_SIZES = ((0, 16), (0, 32), (0, 64), (0, 100_003), (1, 4096), (2 ** 31 - 1, 333))
LOG1P_X = np.concatenate([-np.random.RandomState(0).rand(100_000) ** 2, np.linspace(-0.999999, 0.999, 20_001),
                          [0.0, -1e-30, 1e-8, -0.41421356, -0.4142135]]).astype(np.float32)

# JAX's draws at its default compiler settings, in a process of its own:
# tests/conftest.py compiles at XLA optimization level 0, where the CPU
# code leaves log1p's and erf_inv's multiply-adds unfused and their last
# bits differ (1330 of 1e5 log1p values, 4204 of 1e5 normals; none of the
# first 64 normals of key 0, the frequencies a model draws)
_DEFAULT_JAX = """
import sys, numpy as np, jax, jax.numpy as jnp
jax.config.update("jax_platforms", "cpu")
x = np.load(sys.argv[1])
out = {"log1p": np.asarray(jax.jit(jnp.log1p)(jnp.asarray(x)))}
lo = np.nextafter(np.float32(-1), np.float32(0), dtype=np.float32)
u = np.clip(x, lo, 1.0)
out["erfinv"] = np.asarray(jax.jit(jax.lax.erf_inv)(jnp.asarray(u)))
for seed, n in %r:
    key = jax.random.PRNGKey(seed)
    out[f"bits_{seed}_{n}"] = np.asarray(jax.random.bits(key, (n,), jnp.uint32))
    out[f"uniform_{seed}_{n}"] = np.asarray(jax.random.uniform(key, (n,), jnp.float32, lo, 1.0))
    out[f"normal_{seed}_{n}"] = np.asarray(jax.random.normal(key, (n,)))
np.savez(sys.argv[2], **out)
""" % (SEEDS_SIZES,)


@pytest.fixture(scope="module")
def jax_default(tmp_path_factory):
    import os
    import subprocess
    import sys

    d = tmp_path_factory.mktemp("jax_default")
    np.save(d / "x.npy", LOG1P_X)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    subprocess.run([sys.executable, "-c", _DEFAULT_JAX, str(d / "x.npy"), str(d / "out.npz")],
                   env=env, check=True, timeout=300)
    return dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("seed,n", SEEDS_SIZES)
def test_numpy_draws_equal_jax_bit_for_bit(jax_default, seed, n):
    np.testing.assert_array_equal(threefry.random_bits(seed, n), jax_default[f"bits_{seed}_{n}"])
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    np.testing.assert_array_equal(_bits(threefry.uniform(seed, n, lo, 1.0)),
                                  _bits(jax_default[f"uniform_{seed}_{n}"]))
    np.testing.assert_array_equal(_bits(threefry.normal(seed, n)), _bits(jax_default[f"normal_{seed}_{n}"]))
    if n <= 64:
        # the frequencies' sizes: equal at this process's settings too
        np.testing.assert_array_equal(_bits(threefry.normal(seed, n)),
                                      _bits(jax.random.normal(jax.random.PRNGKey(seed), (n,))))


def test_xla_log1p_and_erfinv_equal_jax_bit_for_bit(jax_default):
    np.testing.assert_array_equal(_bits(threefry.log1p_f32(LOG1P_X)), _bits(jax_default["log1p"]))
    u = np.clip(LOG1P_X, np.nextafter(np.float32(-1), np.float32(0)), 1.0)
    np.testing.assert_array_equal(_bits(threefry.erfinv_f32(u)), _bits(jax_default["erfinv"]))
    with pytest.raises(ValueError):
        threefry.random_bits(2 ** 31, 4)


@pytest.mark.parametrize("dim,scale", [(32, 1000.0), (64, 10000.0), (16, 1.0), (33, 30.0)])
def test_fourier_embedding_matches_jax(dim, scale):
    w = jax.random.normal(jax.random.PRNGKey(0), (dim // 2,)) * scale
    np.testing.assert_array_equal(_bits(fourier_frequencies(dim, scale)), _bits(w))
    t = np.concatenate([[0.0, 1.0], np.random.RandomState(1).rand(30)]).astype(np.float32)
    ref = np.asarray(jax.jit(j_embedding("fourier", dim, scale))(jnp.asarray(t)))
    got = get_timestep_embedding("fourier", dim, scale)(torch.from_numpy(t)).numpy()
    assert got.shape == ref.shape == (t.size, 2 * (dim // 2))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="embedding_type"):
        get_timestep_embedding("gaussian", dim, scale)


def test_score_model_with_fourier_embedding_matches_jax(tables):
    js, jt, ps, pt = tables
    kw = dict(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=1, embedding_type="fourier",
              embedding_scale=10.0)
    data = pad_to(synthetic_complex(np.random.RandomState(0), n_lig=10, n_rec=20, n_bonds=3), 16, 32, 4)
    jdata = jax.tree.map(jnp.asarray, data)
    jmodel = j_build_model(JScoreModelConfig(**kw))
    params = _perturbed(jax.jit(jmodel.init)(jax.random.PRNGKey(4), jdata, jnp.asarray(data.lig_pos),
                                             jnp.asarray(0.5), js, jt), 4)
    poses = (data.lig_pos[None] + np.random.RandomState(1).randn(2, 16, 3) * 0.5).astype(np.float32)
    ref = jax.jit(jax.vmap(lambda p, q: jmodel.apply(p, jdata, q, jnp.asarray(0.7), js, jt),
                           in_axes=(None, 0)))(params, jnp.asarray(poses))
    cfg = ScoreModelConfig(**kw)
    model = build_model(cfg)
    model.load_state_dict(state_dict_from_flax(params, cfg), strict=True)
    model.eval()
    with torch.no_grad():
        out = model(to_device(data, "cpu"), torch.from_numpy(poses), torch.tensor(0.7), ps, pt)
    for name in ("tr", "rot", "tor"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
