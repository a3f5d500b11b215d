"""The DiffDock v1.0 family in score mode, and its remaining options, in the
port against the JAX package on the CPU.

``OldCGScoreModel`` (the v1.0 score model) and ``OldAAScoreModel`` give
tr, rot and tor scores from flax parameters (perturbed off their init
values) converted by ``state_dict_from_flax``, on the same numpy
complexes: float32 within the model tests' 1e-4, bfloat16 under the gates
of ``tests/test_torch_port_bf16.py`` (5e-3 of scale at the largest element,
0.4 of JAX's own bf16-vs-f32 gap in RMS). ``use_old_atom_encoder=False``
(the new encoder, the receptor's LM and sigma tail fused as one block) and
``affinity_prediction`` (one extra output column) in confidence mode
likewise. The v1.0 dock, ranked by the old all-atom confidence model with
its affinity column, runs through both pipelines from JAX's own draws:
poses within 1e-3 A, with the float64 JAX dock as the arbiter of the
float32 gap as in ``tests/test_torch_port_dock.py``.
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
from diffdock_tpu.models.factory import build_model as j_build_model
from diffdock_tpu_torch.data.complexes import (
    bucket_sizes,
    pad_aa_to,
    synthetic_aa_complex,
    synthetic_complex,
    to_device,
)
from diffdock_tpu_torch.inference.pipeline import DockingPipeline
from diffdock_tpu_torch.inference.sampler import SamplerConfig
from diffdock_tpu_torch.models.config import ConfigError, ScoreModelConfig
from diffdock_tpu_torch.models.factory import build_model
from diffdock_tpu_torch.models.old_models import (
    OldAAScoreModel,
    OldCGScoreModel,
    confidence_launches,
)
from diffdock_tpu_torch.ops import fused_tp3 as ft
from diffdock_tpu_torch.utils.convert import state_dict_from_flax
from tests.test_torch_port_bf16 import MODEL_GAP_SHARE, MODEL_RTOL, _gates
from tests.test_torch_port_confidence import _perturbed, tables  # noqa: F401
from tests.test_torch_port_dock import _jax_noise, _to_f64

T = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _old_kw(all_atoms=False, lm_dim=0, layers=2, **extra):
    return dict(ns=8, nv=2, num_conv_layers=layers, old_architecture=True, all_atoms=all_atoms,
                lm_embedding_dim=lm_dim, **extra)


def _complex(all_atoms, lm_dim, seed=0):
    aa = pad_aa_to(synthetic_aa_complex(np.random.RandomState(seed), n_lig=10, n_rec=12, n_bonds=3,
                                        atoms_per_res=3, lm_dim=lm_dim), 16, 32, 4, 64)
    return aa if all_atoms else aa.base


def _params(kw, jdata, js, jt, seed):
    base = jdata.base if kw.get("all_atoms") else jdata
    v = jax.jit(j_build_model(JScoreModelConfig(**kw)).init)(
        jax.random.PRNGKey(seed), jdata, jnp.asarray(base.lig_pos), jnp.asarray(0.5), js, jt)
    return _perturbed(v, seed)


def _outputs(tables, kw, data, poses, t, dtypes=("float32",)):
    """(JAX, port) outputs by dtype of the model ``kw`` with the same
    perturbed parameters, the port's fused_tp3 plain launches per forward,
    the model, and a function giving the JAX model's float64 outputs (the
    same parameters, complex, poses and tables, widened)."""
    js, jt, ps, pt = tables
    jdata = jax.tree.map(jnp.asarray, data)
    params = _params(kw, jdata, js, jt, seed=kw["num_conv_layers"])
    ref, ours, launches = {}, {}, {}
    for dtype in dtypes:
        jmodel = j_build_model(JScoreModelConfig(**kw, compute_dtype=dtype))
        ref[dtype] = jax.jit(jax.vmap(lambda p, q: jmodel.apply(p, jdata, q, jnp.asarray(t), js, jt),
                                      in_axes=(None, 0)))(params, jnp.asarray(poses))
        cfg = ScoreModelConfig(**kw, compute_dtype=dtype)
        model = build_model(cfg)
        model.load_state_dict(state_dict_from_flax(params, cfg), strict=True)
        model.eval()
        before = ft.counts.as_dict()["fused_tp3_reference"]
        with torch.no_grad():
            ours[dtype] = model(to_device(data, "cpu"), T(poses), torch.tensor(t), ps, pt)
        launches[dtype] = ft.counts.as_dict()["fused_tp3_reference"] - before

    def ref64():
        jmodel = j_build_model(JScoreModelConfig(**kw))
        with jax.enable_x64(True):
            return jax.jit(jax.vmap(lambda p, d, q, a, b: jmodel.apply(p, d, q, jnp.asarray(t, jnp.float64), a, b),
                                    in_axes=(None, None, 0, None, None)))(
                _to_f64(params), _to_f64(jdata), jnp.asarray(poses, jnp.float64), _to_f64(js), _to_f64(jt))
    return ref, ours, launches, model, ref64


# nudges of the poses (Angstrom, about ten float32 ulps at these
# coordinates): float32 evaluations at neighbouring inputs
NUDGE, N_NUDGES = 1e-6, 4


def _close(ours, ref, ref64, nudged, name=""):
    """The port's float32 outputs within the float32 model tolerance (1e-4
    of scale) of JAX's. Where the random-weight model amplifies float32
    rounding past that (the heads normalize and combine vectors of small
    norm; JAX's own result at one AA input moves by 8e-4 between XLA
    optimization levels), JAX's float64 outputs arbitrate: the port's
    error from them within twice the float32 error seen at that input (JAX's
    float32 outputs, and the port's at N_NUDGES poses nudged by NUDGE), plus
    that tolerance. ``ref64`` and ``nudged`` (the port's outputs at the
    nudged poses) are computed only then."""
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    tol = 1e-4 * max(np.abs(ref).max(), 1.0)
    assert ours.shape == ref.shape
    if np.abs(ours - ref).max() <= tol:
        return
    exact = np.asarray(ref64(), np.float64)
    err = np.abs(ours - exact).max()
    envelope = max([np.abs(ref - exact).max()] + [np.abs(np.asarray(n, np.float64) - exact).max()
                                                  for n in nudged()])
    assert err <= 2 * envelope + tol, f"{name}: {err:.3e} from float64 > 2 x {envelope:.3e} + {tol:.1e}"


def _nudged(model, data, poses, t, tables, field=None):
    """The port's float32 outputs (or their ``field``) at N_NUDGES nudged
    copies of ``poses``."""
    _, _, ps, pt = tables
    out = []
    for k in range(N_NUDGES):
        p = poses + NUDGE * np.random.RandomState(10 + k).randn(*poses.shape)
        with torch.no_grad():
            o = model(to_device(data, "cpu"), T(p), torch.tensor(t), ps, pt)
        out.append((getattr(o, field) if field else o).numpy())
    return out


@pytest.mark.parametrize("all_atoms,lm_dim,layers,old_encoder,dynamic", [
    (False, 0, 2, True, False), (False, 6, 3, True, True), (False, 6, 3, False, False),
    (True, 6, 3, True, True), (True, 0, 2, False, False)])
def test_old_score_model_matches_jax(tables, all_atoms, lm_dim, layers, old_encoder, dynamic):
    kw = _old_kw(all_atoms, lm_dim, layers, use_old_atom_encoder=old_encoder, dynamic_max_cross=dynamic)
    data = _complex(all_atoms, lm_dim)
    base = data.base if all_atoms else data
    poses = (np.asarray(base.lig_pos)[None] + np.random.RandomState(1).randn(3, 16, 3) * 0.5)
    poses = poses.astype(np.float32)
    ref, ours, launches, model, ref64 = _outputs(tables, kw, data, poses, 0.6)
    assert isinstance(model, OldAAScoreModel if all_atoms else OldCGScoreModel)
    assert not hasattr(model, "confidence_predictor") and hasattr(model, "final_conv")
    # the conv stack as in confidence mode, then final_conv and tor_bond_conv
    assert launches["float32"] == confidence_launches(model.cfg) + 2
    for name in ("tr", "rot", "tor"):
        _close(getattr(ours["float32"], name).numpy(), getattr(ref["float32"], name),
               lambda: getattr(ref64(), name), lambda: _nudged(model, data, poses, 0.6, tables, name), name)
    assert np.all(ours["float32"].tor[:, 3:].numpy() == 0.0)  # padded bond slot
    assert ours["float32"].sidechain is None


def test_old_score_model_in_bf16_matches_jax(tables):
    """The v1.0 score model in bfloat16: every old conv in bfloat16,
    ``final_conv`` and ``tor_bond_conv`` in float32, as in the JAX model."""
    kw = _old_kw(False, 6, 3)
    data = _complex(False, 6)
    poses = (data.lig_pos[None] + np.random.RandomState(1).randn(8, 16, 3) * 0.5).astype(np.float32)
    ref, ours, _, model, ref64 = _outputs(tables, kw, data, poses, 0.6, ("float32", "bfloat16"))
    assert {m.dtype for m in (*model.lig_conv_layers, *model.rec_conv_layers)} == {"bfloat16"}
    assert model.final_conv.dtype == model.tor_bond_conv.dtype == "float32"
    for name in ("tr", "rot", "tor"):
        _close(getattr(ours["float32"], name).numpy(), getattr(ref["float32"], name),
               lambda: getattr(ref64(), name), None, name)
        _gates(getattr(ours["bfloat16"], name).numpy(), getattr(ref["bfloat16"], name),
               getattr(ref["float32"], name), MODEL_RTOL, name, "rms", MODEL_GAP_SHARE)


@pytest.mark.parametrize("all_atoms,old_encoder", [(False, False), (True, False), (True, True)])
def test_old_confidence_affinity_column_and_new_encoder_match_jax(tables, all_atoms, old_encoder):
    """Confidence mode with ``affinity_prediction`` (the old layout's one
    extra column) and either encoder."""
    kw = _old_kw(all_atoms, 6, 3, confidence_mode=True, affinity_prediction=True,
                 use_old_atom_encoder=old_encoder)
    data = _complex(all_atoms, 6)
    base = data.base if all_atoms else data
    poses = (np.asarray(base.lig_pos)[None] + np.random.RandomState(2).randn(3, 16, 3) * 2.0)
    poses = poses.astype(np.float32)
    ref, ours, _, model, ref64 = _outputs(tables, kw, data, poses, 0.0)
    assert ours["float32"].shape == ref["float32"].shape == (3, 2)
    _close(ours["float32"].numpy(), ref["float32"], ref64, lambda: _nudged(model, data, poses, 0.0, tables))
    enc = type(model.rec_node_embedding).__name__
    assert enc == ("OldAtomEncoder" if old_encoder else "AtomEncoder")


def test_old_family_refuses_what_jax_refuses():
    """``odd_parity`` stays refused on the v1.0 family, as the JAX package
    refuses it (models/old_models.py:72-83); the pipeline's pose generator
    is a coarse-grained score model (inference/pipeline.py:340)."""
    for extra in (dict(), dict(confidence_mode=True), dict(all_atoms=True, confidence_mode=True)):
        with pytest.raises(ConfigError, match="odd_parity"):
            build_model(ScoreModelConfig(**_old_kw(**extra), odd_parity=True))
    with pytest.raises(ConfigError, match="pipeline.py:340"):
        DockingPipeline(ScoreModelConfig(**_old_kw(all_atoms=True)), 0, device="cpu")
    with pytest.raises(ConfigError, match="no scores"):
        DockingPipeline(ScoreModelConfig(**_old_kw(confidence_mode=True)), 0, device="cpu")


# ---------------------------------------------------------------------
# the v1.0 dock through both pipelines
# ---------------------------------------------------------------------
SCORE_KW = _old_kw(False, 0, 3, dynamic_max_cross=True)
CONF_KW = _old_kw(True, 0, 2, confidence_mode=True, affinity_prediction=True)
STEPS = dict(inference_steps=3, actual_steps=3)
HEAD_SCALE = 0.02


@pytest.fixture(scope="module")
def dock_setup(tables):
    js, jt, ps, pt = tables
    out = {}
    for name, kw, seed in (("score", SCORE_KW, 2), ("confidence", CONF_KW, 3)):
        aa = j_complexes.synthetic_aa_complex(np.random.RandomState(9), n_lig=8, n_rec=12, n_bonds=2,
                                              atoms_per_res=3)
        jdata = jax.tree.map(jnp.asarray, aa if kw["all_atoms"] else aa.base)
        base = jdata.base if kw["all_atoms"] else jdata
        v = jax.jit(j_build_model(JScoreModelConfig(**kw)).init)(
            jax.random.PRNGKey(seed), jdata, base.lig_pos, jnp.asarray(0.5), js, jt)
        # biases and statistics perturbed, weights as initialized; the score
        # model's tr and rot heads scaled by HEAD_SCALE: at random weights
        # their O(1) outputs, times tr_g^2 dt / tr_sigma, throw the poses
        # hundreds of Angstrom in the first step, where a trained model's
        # scores keep them near the receptor (unscaled, both float32 docks of
        # the arbiter test lie 1-3e-3 A from the float64 one: medians 1.7e-3 A
        # for the port and for JAX in one run)
        v = jax.tree.map(np.asarray, _perturbed(v, seed, weights=False))
        for head in ("tr_final_layer", "rot_final_layer"):
            if head in v["params"]:
                last = v["params"][head]["Dense_1"]
                last.update(kernel=last["kernel"] * HEAD_SCALE, bias=last["bias"] * HEAD_SCALE)
        out[name] = (JScoreModelConfig(**kw), ScoreModelConfig(**kw), v)
    return out


def _pipes(tables, dock_setup):
    js, jt, ps, pt = tables
    (jcfg, cfg, params), (jccfg, ccfg, cparams) = dock_setup["score"], dock_setup["confidence"]
    jpipe = JDockingPipeline(jcfg, params, JSamplerConfig(**STEPS), confidence_cfg=jccfg,
                             confidence_params=cparams, so3_tables=js, torus_tables=jt)
    pipe = DockingPipeline(cfg, state_dict_from_flax(params, cfg), SamplerConfig(**STEPS), ps, pt,
                           device="cpu", confidence_cfg=ccfg,
                           confidence_weights=state_dict_from_flax(cparams, ccfg))
    return jpipe, pipe


def test_old_score_dock_matches_jax_with_injected_noise(tables, dock_setup):
    """The v1.0 dock (no receptor cache: the receptor embedded at every
    step) ranked by the old all-atom confidence model, with its affinity
    column, against the JAX pipeline from JAX's own draws."""
    jpipe, pipe = _pipes(tables, dock_setup)
    spec = dict(n_lig=10, n_rec=24, n_bonds=2, atoms_per_res=3)
    aa = synthetic_aa_complex(np.random.RandomState(0), **spec)
    jaa = j_complexes.synthetic_aa_complex(np.random.RandomState(0), **spec)
    P, seed = 3, 5
    ref = jpipe.dock_complex(jaa.base, num_poses=P, seed=seed, aa_data=jaa)
    before = ft.counts.as_dict()
    res = pipe.dock_complex(aa.base, num_poses=P, seed=seed, noise=_jax_noise(3), aa_data=aa)
    after = ft.counts.as_dict()
    nb = bucket_sizes(aa.base.n_lig, aa.base.n_rec, aa.base.n_bonds)[2]
    assert nb > 0 and after["fused_tp3"] == before["fused_tp3"]
    # per step the old conv stack and the two heads; then the confidence model
    per_step = confidence_launches(dock_setup["score"][1]) + 2
    assert after["fused_tp3_reference"] - before["fused_tp3_reference"] == \
        3 * per_step + confidence_launches(dock_setup["confidence"][1])
    np.testing.assert_allclose(res.poses, np.asarray(ref.poses), rtol=0, atol=1e-3)
    np.testing.assert_allclose(res.confidence, np.asarray(ref.confidence), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(res.order, np.asarray(ref.order))
    assert res.affinity == pytest.approx(float(ref.affinity), rel=1e-4, abs=1e-4)


def test_old_score_dock_gap_is_float32_rounding_against_float64_jax(tables, dock_setup, monkeypatch):
    """The v1.0 score-only dock over 6 seeds: the port's float32 poses lie
    no farther from the float64 JAX dock (same parameters, the float32
    draws widened) than JAX's own float32 dock, beyond the scatter of
    float32 rounding, and within 1e-3 A of it at the median."""
    js, jt, ps, pt = tables
    jcfg, cfg, params = dock_setup["score"]
    spec = dict(n_lig=6, n_rec=10, n_bonds=1)
    data = synthetic_complex(np.random.RandomState(4), **spec)
    jdata = j_complexes.synthetic_complex(np.random.RandomState(4), **spec)
    P, seeds = 3, range(6)
    jax32 = JDockingPipeline(jcfg, params, JSamplerConfig(**STEPS), so3_tables=js, torus_tables=jt)
    pipe = DockingPipeline(cfg, state_dict_from_flax(params, cfg), SamplerConfig(**STEPS), ps, pt,
                           device="cpu")
    ref32 = [np.asarray(jax32.dock_complex(jdata, num_poses=P, seed=s).poses, np.float64) for s in seeds]
    port = [np.asarray(pipe.dock_complex(data, num_poses=P, seed=s, noise=_jax_noise(3)).poses, np.float64)
            for s in seeds]
    normal, uniform = jax.random.normal, jax.random.uniform
    with jax.enable_x64(True):
        monkeypatch.setattr(jax.random, "normal", lambda k, shape=(), dtype=None: normal(
            k, shape, jnp.float32).astype(jnp.float64))
        monkeypatch.setattr(jax.random, "uniform", lambda k, shape=(), dtype=None, minval=0.0,
                            maxval=1.0: uniform(k, shape, jnp.float32, minval, maxval).astype(jnp.float64))
        jax64 = JDockingPipeline(jcfg, _to_f64(params), JSamplerConfig(**STEPS), so3_tables=_to_f64(js),
                                 torus_tables=_to_f64(jt))
        jd64 = type(jdata)(*[_to_f64(a) for a in jdata])
        ref64 = [np.asarray(jax64.dock_complex(jd64, num_poses=P, seed=s).poses) for s in seeds]
        monkeypatch.undo()
    assert ref64[0].dtype == np.float64
    err_port = np.array([np.abs(a - b).max() for a, b in zip(port, ref64)])
    err_jax = np.array([np.abs(a - b).max() for a, b in zip(ref32, ref64)])
    assert np.median(err_port) <= 1e-3
    assert np.median(err_port) <= max(2 * np.median(err_jax), 1e-4)
