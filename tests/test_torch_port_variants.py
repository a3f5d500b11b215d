"""The per-edge and depthwise convolutions of the port against the JAX
package on the CPU.

``DepthwiseTensorProduct`` (its sorted ``irreps_mid``, weight layout and
products), the conv layers with ``factored=False`` or ``depthwise=True``
(the per-edge message, the mean over every block's valid edges, the
depthwise layer's ``linear_2`` before the batch norm), and the coarse-
grained and all-atom models built with ``factored_tp=False`` or
``depthwise_convolution`` in both modes: flax parameters (perturbed off
their init values) converted by ``state_dict_from_flax``, the same numpy
inputs. Tolerances: 1e-5 of scale for one layer and 1e-4 for whole
models in float32 (float32 reordering); a bfloat16 per-edge layer (its edge
MLP in bfloat16, as in JAX) within 1e-3 of scale, the message tests' bound
in ``tests/test_torch_port_bf16.py``. Neither path runs a kernel: their
products are plain PyTorch, as JAX leaves them to XLA.
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
from diffdock_tpu.models.tpconv import NeighborBlock as JNeighborBlock
from diffdock_tpu.models.tpconv import TPConvLayer as JTPConvLayer
from diffdock_tpu.ops.tensor_product import DepthwiseTensorProduct as JDepthwiseTensorProduct
from diffdock_tpu_torch.data.complexes import pad_aa_to, pad_to, synthetic_aa_complex, synthetic_complex, to_device
from diffdock_tpu_torch.inference.pipeline import DockingPipeline
from diffdock_tpu_torch.inference.sampler import SamplerConfig
from diffdock_tpu_torch.models.config import ScoreModelConfig
from diffdock_tpu_torch.models.factory import build_model
from diffdock_tpu_torch.models.tpconv import NeighborBlock, TPConvLayer
from diffdock_tpu_torch.ops import fused_tp3 as ft
from diffdock_tpu_torch.ops.tensor_product import DepthwiseTensorProduct
from diffdock_tpu_torch.utils.convert import state_dict_from_flax
from tests.test_torch_port_confidence import _perturbed, tables  # noqa: F401
from tests.test_torch_port_dock import _jax_noise

T = lambda a: torch.from_numpy(np.array(a))
IN_IR = "6x0e + 3x1o + 3x1e + 2x0o"
SH_IR = "1x0e + 1x1o + 1x2e"
OUT_IR = "6x0e + 3x1o + 3x1e + 6x0o"


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("irreps", [(IN_IR, SH_IR, OUT_IR), ("4x0e + 2x1o", "1x0e + 1x1o", "4x0e + 2x1o + 1x1e"),
                                    ("5x0e", "1x0e + 1x1o + 1x2e", "5x0e + 5x1o + 5x2e")])
def test_depthwise_tensor_product_matches_jax(irreps):
    ours, ref = DepthwiseTensorProduct(*irreps), JDepthwiseTensorProduct(*irreps)
    assert str(ours.irreps_mid) == str(ref.irreps_mid)
    assert ours.weight_numel == ref.weight_numel
    assert [(i, j, str(ir)) for i, j, ir, _ in ours.paths] == [(i, j, str(ir)) for i, j, ir, _ in ref.paths]
    rng = np.random.RandomState(0)
    x1 = rng.randn(5, 7, ours.irreps_in1.dim).astype(np.float32)
    x2 = rng.randn(5, 7, ours.irreps_in2.dim).astype(np.float32)
    w = rng.randn(5, 7, ours.weight_numel).astype(np.float32)
    got = ours(T(x1), T(x2), T(w)).numpy()
    want = np.asarray(ref(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(w)))
    assert got.shape == want.shape == (5, 7, ours.irreps_mid.dim)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def _blocks(rng, R=12, K=(6, 9), S=15, E=10, with_weight=True):
    """Two dense edge groups into R receivers from S senders, numpy."""
    out = []
    for k in K:
        out.append(dict(
            nbr_idx=rng.randint(0, S, (R, k)).astype(np.int64),
            nbr_mask=rng.rand(R, k) < 0.7,
            edge_attr=rng.randn(R, k, E).astype(np.float32),
            edge_sh=rng.randn(R, k, 9).astype(np.float32),
            edge_weight=rng.rand(R, k).astype(np.float32) if with_weight else None,
        ))
    return out


@pytest.mark.parametrize("factored,depthwise,dtype", [
    (False, False, "float32"), (True, True, "float32"), (False, True, "float32"), (False, False, "bfloat16")])
def test_conv_layer_variants_match_jax(factored, depthwise, dtype):
    """One ``TPConvLayer`` over two blocks with edge weights, residual and
    batch norm in evaluation mode (perturbed statistics)."""
    rng = np.random.RandomState(1)
    blocks = _blocks(rng)
    sender = rng.randn(15, 26).astype(np.float32)  # IN_IR: 6 + 9 + 9 + 2
    recv = rng.randn(12, 26).astype(np.float32)
    kw = dict(in_irreps=IN_IR, sh_irreps=SH_IR, out_irreps=OUT_IR, n_edge_features=10, residual=True,
              batch_norm=True, factored=factored, depthwise=depthwise, dtype=dtype)
    jlayer = JTPConvLayer(**kw)
    jblocks = [JNeighborBlock(sender_attr=jnp.asarray(sender), **{k: None if v is None else jnp.asarray(v)
                                                               for k, v in b.items()}) for b in blocks]
    variables = jlayer.init(jax.random.PRNGKey(0), jnp.asarray(recv), jblocks)
    variables = jax.tree.map(np.asarray, _perturbed(variables, 1))
    ref = np.asarray(jax.jit(lambda v: jlayer.apply(v, jnp.asarray(recv), jblocks))(variables))

    layer = TPConvLayer(IN_IR, SH_IR, OUT_IR, n_edge_features=10, residual=True, batch_norm=True,
                        factored=factored, depthwise=depthwise, dtype=dtype)
    assert layer.merged == (factored and not depthwise)
    layer.load_state_dict(state_dict_from_flax(variables, None), strict=True)
    layer.eval()
    tblocks = [NeighborBlock(sender_attr=T(sender)[None], **{k: None if v is None else T(v)[None]
                                                            for k, v in b.items()}) for b in blocks]
    before = ft.counts.as_dict()
    with torch.no_grad():
        got = layer(T(recv)[None], tblocks)[0].numpy()
    after = ft.counts.as_dict()
    launched = sum(after[k] - before[k] for k in after)
    assert launched == (2 if layer.merged else 0)
    tol = (1e-5 if dtype == "float32" else 1e-3) * max(np.abs(ref).max(), 1.0)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol, np.abs(got - ref).max()


def _model_outputs(tables, kw, data, t, poses):
    """JAX and port outputs of the model ``kw`` with the same perturbed
    parameters; the port's receptor cache and step cache."""
    js, jt, ps, pt = tables
    jdata = jax.tree.map(jnp.asarray, data)
    base = data.base if kw.get("all_atoms") else data
    jmodel = j_build_model(JScoreModelConfig(**kw))
    params = _perturbed(jax.jit(jmodel.init)(jax.random.PRNGKey(3), jdata, jnp.asarray(base.lig_pos),
                                             jnp.asarray(0.5), js, jt), 3)
    ref = jax.jit(jax.vmap(lambda p, q: jmodel.apply(p, jdata, q, jnp.asarray(t), js, jt),
                           in_axes=(None, 0)))(params, jnp.asarray(poses))
    jstep = None
    if not kw.get("all_atoms") and not kw.get("confidence_mode"):
        jcache = jax.jit(lambda p: jmodel.apply(p, jdata, method="embed_receptor"))(params)
        jstep = jmodel.apply(params, jdata, jnp.asarray(t), jcache, method="step_cache")
    cfg = ScoreModelConfig(**kw)
    model = build_model(cfg)
    model.load_state_dict(state_dict_from_flax(params, cfg), strict=True)
    model.eval()
    tdata = to_device(data, "cpu")
    with torch.no_grad():
        cache = model.embed_receptor(tdata)
        step = None if kw.get("all_atoms") else model.step_cache(tdata, torch.tensor(t), cache)
        out = model(tdata, T(poses.astype(np.float32)), torch.tensor(t), ps, pt, rec_cache=cache,
                    **({} if kw.get("all_atoms") else dict(step_cache=step)))
    return ref, out, jstep, step


@pytest.mark.parametrize("variant", [dict(factored_tp=False), dict(depthwise_convolution=True),
                                     dict(depthwise_convolution=True, differentiate_convolutions=False)])
def test_cg_score_model_variants_match_jax(tables, variant):
    kw = dict(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=1, lm_embedding_dim=4, **variant)
    data = pad_to(synthetic_complex(np.random.RandomState(0), n_lig=10, n_rec=20, n_bonds=3, lm_dim=4), 16, 32, 4)
    poses = data.lig_pos[None] + np.random.RandomState(1).randn(2, 16, 3) * 0.5
    ref, out, jstep, step = _model_outputs(tables, kw, data, 0.6, poses)
    # no per-step receptor precompute where the JAX model gives none
    assert jstep is None and step is None
    for name in ("tr", "rot", "tor"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("variant", [dict(depthwise_convolution=True), dict(factored_tp=False, confidence_mode=True)])
def test_aa_model_variants_match_jax(tables, variant):
    kw = dict(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=1, all_atoms=True, **variant)
    aa = pad_aa_to(synthetic_aa_complex(np.random.RandomState(0), n_lig=10, n_rec=12, n_bonds=2,
                                        atoms_per_res=3), 16, 32, 4, 64)
    t = 0.0 if variant.get("confidence_mode") else 0.6
    poses = np.asarray(aa.base.lig_pos)[None] + np.random.RandomState(1).randn(2, 16, 3) * 0.5
    ref, out, _, _ = _model_outputs(tables, kw, aa, t, poses)
    pairs = ([(out, ref)] if variant.get("confidence_mode")
             else [(getattr(out, n), getattr(ref, n)) for n in ("tr", "rot", "tor")])
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)


def test_step_cache_follows_the_jax_model():
    """``step_cache`` is None exactly where the JAX model's is: one joint
    layer, or convs that are not factored; a factored model gives one."""
    for kw, none in ((dict(num_conv_layers=1), True), (dict(factored_tp=False), True),
                     (dict(depthwise_convolution=True), True), (dict(), False)):
        cfg = ScoreModelConfig(ns=4, nv=2, num_prot_emb_layers=1, **{"num_conv_layers": 2, **kw})
        data = to_device(synthetic_complex(np.random.RandomState(0), n_lig=5, n_rec=8, n_bonds=1), "cpu")
        model = build_model(cfg)
        model.reset_parameters(torch.Generator().manual_seed(0))
        with torch.no_grad():
            step = model.step_cache(data, torch.tensor(0.5), model.embed_receptor(data))
        assert (step is None) == none, kw


def test_depthwise_dock_matches_jax_with_injected_noise(tables):
    """A score-only dock of the depthwise model through both pipelines
    from JAX's own draws: its convs launch nothing, its heads' merged
    contractions (factored, as in JAX) run the plain version."""
    js, jt, ps, pt = tables
    kw = dict(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=1, depthwise_convolution=True)
    jcfg, cfg = JScoreModelConfig(**kw), ScoreModelConfig(**kw)
    jdata = j_complexes.synthetic_complex(np.random.RandomState(0), n_lig=10, n_rec=24, n_bonds=2)
    params = jax.jit(j_build_model(jcfg).init)(jax.random.PRNGKey(2), jdata, jnp.asarray(jdata.lig_pos),
                                              jnp.asarray(0.5), js, jt)
    params = jax.tree.map(np.asarray, _perturbed(params, 2, weights=False))
    steps = dict(inference_steps=3, actual_steps=3)
    ref = JDockingPipeline(jcfg, params, JSamplerConfig(**steps), so3_tables=js,
                           torus_tables=jt).dock_complex(jdata, num_poses=2, seed=3)
    pipe = DockingPipeline(cfg, state_dict_from_flax(params, cfg), SamplerConfig(**steps), ps, pt, device="cpu")
    data = synthetic_complex(np.random.RandomState(0), n_lig=10, n_rec=24, n_bonds=2)
    before = ft.counts.as_dict()
    res = pipe.dock_complex(data, num_poses=2, seed=3, noise=_jax_noise(3))
    after = ft.counts.as_dict()
    assert after["fused_tp3_reference"] - before["fused_tp3_reference"] == 3 * 2  # final_conv, tor_bond_conv
    assert after["fused_tp3"] == before["fused_tp3"]
    np.testing.assert_allclose(res.poses, np.asarray(ref.poses), rtol=0, atol=1e-3)
