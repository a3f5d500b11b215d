"""The port's bfloat16 compute mode against the JAX package's
``compute_dtype="bfloat16"`` on the CPU.

The JAX model path runs ``models/tpconv.py:_tp_message_reduced`` (its XLA
einsums; the gen-3 Pallas kernel is reached only by its own tests). In
bfloat16 it casts the mask, edge weights, MLP input, senders and harmonics
to bfloat16, runs the edge MLP in bfloat16 (flax ``Dense(dtype=bf16)``:
the hidden activations ``h`` are bfloat16), builds the coupling in bfloat16
arithmetic, sums ``P = h_aug . coupled`` in float32 and rounds it to
bfloat16, rounds the weights as ``bf16(f32(bf16(T)) / sqrt(fan))`` and sums
the weight product in float32. The port places every cast where JAX does.

Two gates hold each comparison: the port within a stated share of the
output's scale, and within a fifth of JAX's own gap between its bfloat16
and float32 results on the same inputs, which a port that quietly computes
in float32 fails. The measured worst cases are in ``CHANGES.md``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdock_tpu.data import complexes as j_complexes
from diffdock_tpu.inference.pipeline import DockingPipeline as JDockingPipeline
from diffdock_tpu.inference.sampler import SamplerConfig as JSamplerConfig
from diffdock_tpu.models.config import ScoreModelConfig as JScoreModelConfig
from diffdock_tpu.models.encoders import FCBlock as JFCBlock
from diffdock_tpu.models.factory import build_model as j_build_model
from diffdock_tpu.models.score_model import CGScoreModel as JCGScoreModel
from diffdock_tpu.models.tpconv import NeighborBlock as JBlock
from diffdock_tpu.models.tpconv import _tp_message_reduced as j_reduced
from diffdock_tpu.ops import pallas_tpconv3 as j_tp3
from diffdock_tpu.ops import tensor_product as j_tp
from diffdock_tpu_torch.data.complexes import pad_aa_to, pad_to, synthetic_aa_complex
from diffdock_tpu_torch.data.complexes import synthetic_complex, to_device
from diffdock_tpu_torch.inference.pipeline import DockingPipeline
from diffdock_tpu_torch.inference.sampler import SamplerConfig
from diffdock_tpu_torch.models.aa_model import AAScoreModel
from diffdock_tpu_torch.models.config import ScoreModelConfig
from diffdock_tpu_torch.models.encoders import FCBlock
from diffdock_tpu_torch.models.old_models import OldAAScoreModel, build_confidence_model
from diffdock_tpu_torch.models.score_model import CGScoreModel
from diffdock_tpu_torch.models.tpconv import NeighborBlock, _tp_message_reduced
from diffdock_tpu_torch.ops import fused_tp3 as ft
from diffdock_tpu_torch.ops.tensor_product import FullyConnectedTensorProduct
from diffdock_tpu_torch.utils.convert import state_dict_from_flax
from tests.test_torch_port_confidence import _perturbed, tables  # noqa: F401
from tests.test_torch_port_dock import _jax_noise

IN_IR = "8x0e + 4x1o + 4x1e + 4x0o"
SH_IR = "1x0e + 1x1o + 1x2e"
OUT_IR = "8x0e + 4x1o + 4x1e + 4x0o"
BF16 = torch.bfloat16
T = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))
# |port - JAX bf16| <= MESSAGE_RTOL * max(max|JAX bf16|, 1): both round at the
# same places and differ only in the order of float32 sums (a rounding to
# bfloat16 near a tie may go the other way); JAX's own bf16-vs-f32 gap is
# about 5e-3 of scale on these inputs
MESSAGE_RTOL = 1e-3
GAP_SHARE = 0.2
# the models: the two packages' float32 edge features differ in the last
# bits (the Gaussian distance smearing turns a 1e-7 distance difference
# into ~1e-6 of the feature), and the casts to bfloat16 turn ~0.3 % of those
# into one-ulp differences, which the layers carry to the outputs. JAX's own
# bfloat16 score model, jitted at XLA's default optimization level and at
# the level tests/conftest.py sets, differs by 0.2 of its bf16-vs-f32 gap
# (tor). So the models are held to 5e-3 of scale at the largest element and
# to 0.4 of the gap in RMS: a port that computes in float32 sits at 1.0
MODEL_RTOL = 5e-3
MODEL_GAP_SHARE = 0.4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gates(ours, ref_bf16, ref_f32, rtol, name="", norm="max", share=GAP_SHARE):
    """The scale gate (largest element within ``rtol`` of the scale) and the
    gap gate (the error within ``share`` of JAX's bf16-vs-f32 gap, both as
    the largest element, ``norm="max"``, or the root mean square,
    ``"rms"``); returns (error / scale, error / gap)."""
    ours, ref_bf16, ref_f32 = (np.asarray(a, dtype=np.float64) for a in (ours, ref_bf16, ref_f32))
    scale = max(np.abs(ref_bf16).max(), 1.0)
    size = (lambda d: np.abs(d).max()) if norm == "max" else (lambda d: np.sqrt(np.mean(d * d)))
    err, gap = size(ours - ref_bf16), size(ref_bf16 - ref_f32)
    assert gap > 0, f"{name}: JAX's bfloat16 and float32 results are equal"
    assert np.abs(ours - ref_bf16).max() <= rtol * scale, f"{name}: {np.abs(ours - ref_bf16).max() / scale:.3e} of scale > {rtol}"
    assert err <= share * gap, f"{name}: {err:.3e} > {share} x gap {gap:.3e} ({norm})"
    return np.abs(ours - ref_bf16).max() / scale, err / gap


@pytest.mark.parametrize("irreps", [(IN_IR, SH_IR, OUT_IR),
                                    ("5x0e + 3x1o", "1x0e + 1x1o", "2x1e + 3x0o + 4x1o")])
def test_coupled_class_merged_in_bf16_matches_jax(irreps):
    """bfloat16 in, bfloat16 out, one rounding per op as in JAX: equal but
    for the matmul's float32 sum order (one bfloat16 ulp at a tie)."""
    tp, jtp = FullyConnectedTensorProduct(*irreps), j_tp.FullyConnectedTensorProduct(*irreps)
    rng = np.random.RandomState(0)
    x1 = rng.randn(40, 6, tp.irreps_in1.dim).astype(np.float32)
    x2 = rng.randn(40, 6, tp.irreps_in2.dim).astype(np.float32)
    for k, *_ in tp.live_classes():
        ours = tp.coupled_class_merged(k, T(x1).to(BF16), T(x2).to(BF16))
        ref = jtp.coupled_class_merged(k, jnp.asarray(x1, jnp.bfloat16), jnp.asarray(x2, jnp.bfloat16))
        assert ours.dtype == BF16 and ref.dtype == jnp.bfloat16
        ref = np.asarray(ref.astype(jnp.float32))
        diff = np.abs(ours.float().numpy() - ref)
        # one ulp of bfloat16 (2^-7 relative) at most, and almost never
        assert np.all(diff <= 2.0 ** -7 * np.abs(ref) + 1e-30)
        assert (diff > 0).mean() < 0.01


def _message_inputs(tp, seed=4, R=64, K=24, S=80, E=48):
    rng = np.random.RandomState(seed)
    return dict(sender=rng.randn(S, tp.irreps_in1.dim).astype(np.float32),
                idx=rng.randint(0, S, size=(R, K)).astype(np.int32),
                mask=rng.rand(R, K) > 0.3,
                eattr=rng.randn(R, K, E).astype(np.float32),
                esh=rng.randn(R, K, tp.irreps_in2.dim).astype(np.float32),
                ew=rng.rand(R, K).astype(np.float32))


def _fc_pair(E, H, out_dim, dtype, seed=5):
    jfc = JFCBlock(hidden_dim=H, out_dim=out_dim, dtype=dtype)
    params = jfc.init(jax.random.PRNGKey(seed), jnp.zeros((1, E)))
    rng = np.random.RandomState(seed)
    params = jax.tree.map(lambda p: np.asarray(p) + 0.2 * rng.randn(*p.shape).astype(np.float32), params)
    fc = FCBlock(E, H, out_dim)
    p = params["params"]
    with torch.no_grad():
        fc.layers[0].weight.copy_(T(p["Dense_0"]["kernel"]).T)
        fc.layers[0].bias.copy_(T(p["Dense_0"]["bias"]))
        fc.out_kernel.copy_(T(p["out_kernel"]))
        fc.out_bias.copy_(T(p["out_bias"]))
    return jfc, params, fc


@pytest.mark.parametrize("with_weight", [False, True])
def test_tp_message_reduced_in_bf16_matches_jax(with_weight):
    """The merged message at R=64, K=24, H=48: within 1e-3 of scale of JAX's
    bfloat16 message and within a fifth of JAX's bfloat16-vs-float32 gap
    (measured: 2e-7 of scale against a gap of 5e-3)."""
    tp, jtp = FullyConnectedTensorProduct(IN_IR, SH_IR, OUT_IR), j_tp.FullyConnectedTensorProduct(IN_IR, SH_IR, OUT_IR)
    a = _message_inputs(tp)
    ew = a["ew"] if with_weight else None
    E, H = a["eattr"].shape[-1], 48
    jblk = JBlock(jnp.asarray(a["sender"]), jnp.asarray(a["idx"]), jnp.asarray(a["mask"]),
                  jnp.asarray(a["eattr"]), jnp.asarray(a["esh"]), None if ew is None else jnp.asarray(ew))
    blk = NeighborBlock(T(a["sender"])[None], torch.from_numpy(a["idx"]).long()[None],
                        torch.from_numpy(a["mask"])[None], T(a["eattr"])[None], T(a["esh"])[None],
                        None if ew is None else T(ew)[None])
    out = {}
    for dtype in ("float32", "bfloat16"):
        jfc, params, fc = _fc_pair(E, H, tp.weight_numel, dtype)
        out["jax", dtype], jcnt = jax.jit(lambda p: jfc.apply(
            p, method=lambda m: j_reduced(jtp, m, jblk, False, dtype, merged=True)))(params)
        with torch.no_grad():
            s, c = _tp_message_reduced(tp, fc, blk, dtype=dtype)
        assert s.dtype == c.dtype == torch.float32
        out["port", dtype] = s[0].numpy()
        np.testing.assert_array_equal(c[0].numpy(), np.asarray(jcnt))
    np.testing.assert_allclose(out["port", "float32"], out["jax", "float32"], rtol=1e-5, atol=2e-4)
    _gates(out["port", "bfloat16"], out["jax", "bfloat16"], out["jax", "float32"], MESSAGE_RTOL, "message")


def test_tp_message_reduced_per_class_oracle_in_bf16():
    """The per-class branch rounds as JAX's per-class branch does, run op by
    op (under ``jax.jit`` XLA drops that branch's rounding of P to bfloat16
    before its f32-accumulated dot, 2e-3 of scale here; the merged branch,
    the one the models run, gives the same bits either way), and stays the
    merged one's oracle in bfloat16 (within 2e-3 of scale: the weights
    round at other places, ``bf16(T)`` with the 1/sqrt(fan) applied after
    the product; 1.0e-3 measured)."""
    tp = FullyConnectedTensorProduct(IN_IR, SH_IR, OUT_IR)
    jtp = j_tp.FullyConnectedTensorProduct(IN_IR, SH_IR, OUT_IR)
    a = _message_inputs(tp, seed=6, R=20, K=10)
    jfc, params, fc = _fc_pair(a["eattr"].shape[-1], 24, tp.weight_numel, "bfloat16", seed=7)
    jblk = JBlock(*[jnp.asarray(a[k]) for k in ("sender", "idx", "mask", "eattr", "esh", "ew")])
    blk = NeighborBlock(T(a["sender"])[None], torch.from_numpy(a["idx"]).long()[None],
                        torch.from_numpy(a["mask"])[None], T(a["eattr"])[None], T(a["esh"])[None],
                        T(a["ew"])[None])
    ref = np.asarray(jfc.apply(
        params, method=lambda m: j_reduced(jtp, m, jblk, False, "bfloat16", merged=False))[0])
    with torch.no_grad():
        per_class = _tp_message_reduced(tp, fc, blk, merged=False, dtype="bfloat16")[0][0].numpy()
        merged = _tp_message_reduced(tp, fc, blk, merged=True, dtype="bfloat16")[0][0].numpy()
    scale = max(np.abs(ref).max(), 1.0)
    assert np.abs(per_class - ref).max() <= MESSAGE_RTOL * scale
    assert np.abs(per_class - merged).max() <= 2 * MESSAGE_RTOL * scale


def _tp3_args(tp, n, k, h_dim, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, k, tp.irreps_in1.dim).astype(np.float32)
    sh = rng.randn(n, k, tp.irreps_in2.dim).astype(np.float32)
    mw = (rng.rand(n, k) > 0.3).astype(np.float32)
    h = rng.randn(n, k, h_dim).astype(np.float32) * mw[..., None]
    wk = (rng.randn(h_dim, tp.weight_numel) * 0.1).astype(np.float32)
    wb = (rng.randn(tp.weight_numel) * 0.1).astype(np.float32)
    return x, sh, h, mw, wk, wb


@pytest.mark.parametrize("n,k", [(16, 8), (37, 8)])
def test_fused_tp3_bf16_plain_matches_pallas_interpret(n, k):
    """The bfloat16 plain version against the TPU kernel in interpret mode
    with bfloat16 operands (``h`` rounded to bfloat16 first, as the model
    path gives it). The Pallas wrapper rounds the weights once,
    ``bf16(T / sqrt(fan))``, where the model path rounds them twice: with
    weights already on the bfloat16 grid both round alike and agree within
    1e-3 of scale (P's rounding near ties); with raw weights the extra
    rounding moves the output by up to 1e-2 of scale."""
    jtp = j_tp.FullyConnectedTensorProduct(IN_IR, SH_IR, OUT_IR)
    tp = FullyConnectedTensorProduct(IN_IR, SH_IR, OUT_IR)
    x, sh, h, mw, wk, wb = _tp3_args(tp, n, k, h_dim=24)
    on_grid = lambda w: np.asarray(jnp.asarray(w, jnp.bfloat16).astype(jnp.float32))
    for weights, rtol in (((on_grid(wk), on_grid(wb)), 1e-3), ((wk, wb), 1e-2)):
        jargs = [jnp.asarray(v, jnp.bfloat16) for v in (x, sh, h, mw)] + [jnp.asarray(w) for w in weights]
        pallas = np.asarray(j_tp3._forward_pallas(jtp, *jargs, block_rows=16, interpret=True))
        before = ft.counts["fused_tp3_reference"]
        ours = ft.fused_tp3_reference(tp, *[T(v).to(BF16) for v in (x, sh, h, mw)], *map(T, weights))
        assert ft.counts["fused_tp3_reference"] == before + 1
        assert ours.dtype == torch.float32 and ours.shape == pallas.shape
        scale = max(np.abs(pallas).max(), 1.0)
        assert np.abs(ours.numpy() - pallas).max() <= rtol * scale


def test_fused_tp3_prepare_rounds_like_the_model_path():
    """``prepare`` in bfloat16: h, mw, coupled and the packed weights
    bfloat16, the weights bf16(f32(bf16(T)) / sqrt(fan)), the bias the
    same as row H; the packed weights are these blocks gathered into the
    bfloat16 kernel's layout."""
    tp = FullyConnectedTensorProduct(IN_IR, SH_IR, OUT_IR)
    x, sh, h, mw, wk, wb = _tp3_args(tp, 5, 4, h_dim=6, seed=2)
    classes, h_k, coupled, weights, table, mw_k = ft.prepare(
        tp, *[T(v).to(BF16) for v in (x, sh, h, mw)], T(wk), T(wb))
    assert h_k.dtype == coupled.dtype == weights.dtype == mw_k.dtype == BF16
    blocks = []
    for _k, offset, fan, _d3, mul in classes:
        T0 = T(wk)[:, offset: offset + fan * mul].reshape(6, fan, mul)
        want = (T0.to(BF16).float() * np.float32(1 / np.sqrt(fan))).to(BF16)
        b0 = T(wb)[offset: offset + fan * mul].reshape(1, fan, mul)
        bias = (b0.to(BF16).float() * np.float32(1 / np.sqrt(fan))).to(BF16)
        blocks.append(torch.cat([want, bias]))
    flat = torch.cat([b.reshape(-1) for b in blocks] + [blocks[0].new_zeros(1)])
    idx = ft._bf16_weight_index(table, 6, ft.bf16_plan(table, 5, 4, 6))
    assert torch.equal(weights, flat[torch.from_numpy(idx)])
    assert table.shape == (len(classes), 6)


def test_fused_tp3_refuses_bf16_gradients_and_mixed_operands():
    tp = FullyConnectedTensorProduct("4x0e + 2x1o", "1x0e + 1x1o", "4x0e + 2x1o")
    args = [T(v) for v in _tp3_args(tp, 3, 2, h_dim=4)]
    bf = [a.to(BF16) for a in args[:4]] + [args[4].requires_grad_(), args[5]]
    with pytest.raises(TypeError, match="gradient"):
        ft.fused_tp3(tp, *bf)
    with torch.no_grad():  # no gradient wanted: the plain version runs
        assert ft.fused_tp3(tp, *bf).dtype == torch.float32
    # the float32 route still trains
    out = ft.fused_tp3(tp, *args)
    out.sum().backward()
    assert args[4].grad is not None
    # launch takes the bfloat16 kernel's operands, all bfloat16, only
    # (checked before it looks at the device; the float32 kernel's call is
    # forward_f32)
    with pytest.raises(TypeError, match="bfloat16 kernel's operands"):
        ft.launch(torch.zeros(2, 3, 4, dtype=BF16, device="meta"),
                  torch.zeros(2, 3, 5, device="meta"), torch.zeros(20, dtype=BF16, device="meta"),
                  np.array([[0, 5, 1, 1, 0, 0]], np.int64))


def _score_pair(tables, lm_dim=0):
    """JAX and port score models (2 + 2 layers, ns 8, nv 4) with the same
    perturbed parameters, in both dtypes, on one padded complex."""
    js, jt, _, _ = tables
    kw = dict(ns=8, nv=4, num_conv_layers=2, num_prot_emb_layers=2, lm_embedding_dim=lm_dim)
    data = pad_to(synthetic_complex(np.random.RandomState(0), n_lig=10, n_rec=24, n_bonds=3,
                                    lm_dim=lm_dim), 16, 32, 4)
    jdata = j_complexes.ComplexData(*[None if a is None else jnp.asarray(a) for a in data])
    params = jax.jit(JCGScoreModel(JScoreModelConfig(**kw)).init)(
        jax.random.PRNGKey(0), jdata, jnp.asarray(data.lig_pos), jnp.asarray(0.5), js, jt)
    params = _perturbed(params, 0)
    out = {}
    for dtype in ("float32", "bfloat16"):
        jcfg, cfg = JScoreModelConfig(**kw, compute_dtype=dtype), ScoreModelConfig(**kw, compute_dtype=dtype)
        model = CGScoreModel(cfg)
        model.load_state_dict(state_dict_from_flax(params, cfg), strict=True)
        out[dtype] = (JCGScoreModel(jcfg), model.eval())
    return params, data, jdata, out


def test_score_model_in_bf16_matches_jax(tables, monkeypatch):
    """tr, rot and tor scores of the bfloat16 score model against JAX's, over
    8 poses, under MODEL_RTOL and MODEL_GAP_SHARE; ``final_conv`` and
    ``tor_bond_conv`` run in float32 (JAX builds them without a dtype),
    every other conv in bfloat16."""
    js, jt, ps, pt = tables
    params, data, jdata, models = _score_pair(tables)
    poses = (data.lig_pos[None] + np.random.RandomState(1).randn(8, 16, 3) * 0.5).astype(np.float32)
    t = 0.6
    seen = []
    plain = ft.fused_tp3_reference
    monkeypatch.setattr(ft, "fused_tp3_reference", lambda tp, *a: seen.append((tp, a[2].dtype)) or plain(tp, *a))
    ref, ours = {}, {}
    for dtype, (jmodel, model) in models.items():
        ref[dtype] = jax.jit(jax.vmap(lambda p, q: jmodel.apply(p, jdata, q, jnp.asarray(t), js, jt),
                                      in_axes=(None, 0)))(params, jnp.asarray(poses))
        seen.clear()
        with torch.no_grad():
            ours[dtype] = model(to_device(data, "cpu"), torch.from_numpy(poses), torch.tensor(t), ps, pt)
        heads = {id(model.final_conv.tp), id(model.tor_bond_conv.tp)}
        assert {d for tp, d in seen if id(tp) in heads} == {torch.float32}
        assert {d for tp, d in seen if id(tp) not in heads} == {getattr(torch, dtype)}
    for name in ("tr", "rot", "tor"):
        np.testing.assert_allclose(getattr(ours["float32"], name).numpy(), np.asarray(getattr(ref["float32"], name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
        _gates(getattr(ours["bfloat16"], name).numpy(), getattr(ref["bfloat16"], name),
               getattr(ref["float32"], name), MODEL_RTOL, name, "rms", MODEL_GAP_SHARE)
    assert models["bfloat16"][1].final_conv.dtype == "float32"
    assert models["bfloat16"][1].conv_layers[0].dtype == "bfloat16"


def _conf_outputs(tables, kw, data, n_poses=3):
    """(JAX outputs, port outputs) per dtype of the confidence model ``kw``
    with the same perturbed parameters, on ``n_poses`` poses."""
    js, jt, _, _ = tables
    jdata = jax.tree.map(jnp.asarray, data)
    base = data.base
    params = _perturbed(jax.jit(j_build_model(JScoreModelConfig(**kw)).init)(
        jax.random.PRNGKey(1), jdata, jnp.asarray(base.lig_pos), jnp.asarray(0.0), js, jt), 1)
    poses = (np.asarray(base.lig_pos)[None] + np.random.RandomState(1).randn(
        n_poses, *np.asarray(base.lig_pos).shape) * 2.0).astype(np.float32)
    ref, ours = {}, {}
    for dtype in ("float32", "bfloat16"):
        jmodel = j_build_model(JScoreModelConfig(**kw, compute_dtype=dtype))
        ref[dtype] = np.asarray(jax.jit(jax.vmap(lambda p, q: jmodel.apply(p, jdata, q, jnp.asarray(0.0), js, jt),
                                                 in_axes=(None, 0)))(params, jnp.asarray(poses)))
        cfg = ScoreModelConfig(**kw, compute_dtype=dtype)
        model = build_confidence_model(cfg)
        model.load_state_dict(state_dict_from_flax(params, cfg), strict=True)
        with torch.no_grad():
            tdata = to_device(data, "cpu")
            out = model(tdata, torch.from_numpy(poses), 0.0) if isinstance(model, OldAAScoreModel) else \
                model(tdata, torch.from_numpy(poses), 0.0, rec_cache=model.embed_receptor(tdata))
        ours[dtype] = out.numpy()
    return ref, ours, model


def test_old_aa_confidence_model_in_bf16_matches_jax(tables):
    """The shipped confidence model's family (old all-atom, 3 layers, LM
    features) in bfloat16: every ``_old_conv`` takes the compute dtype."""
    kw = dict(ns=8, nv=2, num_conv_layers=3, confidence_mode=True, old_architecture=True,
              all_atoms=True, lm_embedding_dim=6)
    aa = pad_aa_to(synthetic_aa_complex(np.random.RandomState(0), n_lig=10, n_rec=12, n_bonds=2,
                                        atoms_per_res=3, lm_dim=6), 16, 32, 4, 64)
    ref, ours, model = _conf_outputs(tables, kw, aa)
    assert isinstance(model, OldAAScoreModel)
    assert {m.dtype for m in model.conv_layers} == {"bfloat16"}
    np.testing.assert_allclose(ours["float32"], ref["float32"], rtol=1e-4, atol=1e-4)
    _gates(ours["bfloat16"], ref["bfloat16"], ref["float32"], MODEL_RTOL, "old all-atom confidence", "rms",
           MODEL_GAP_SHARE)


def test_aa_model_in_bf16_matches_jax(tables):
    """JAX's ``AAScoreModel`` builds its ``MultiTPConvLayer``s with
    ``**self._conv_common()``, which carries ``compute_dtype``: in bfloat16
    it computes in bfloat16 (its outputs differ from float32's), and so does
    the port."""
    kw = dict(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=1, confidence_mode=True,
              all_atoms=True)
    aa = pad_aa_to(synthetic_aa_complex(np.random.RandomState(5), n_lig=10, n_rec=12, n_bonds=1,
                                        atoms_per_res=3), 16, 32, 4, 96, ka=8, ar=4)
    ref, ours, model = _conf_outputs(tables, kw, aa)
    assert isinstance(model, AAScoreModel)
    assert {m.dtype for m in model.conv_layers} | {m.dtype for m in model.rec_emb_layers} == {"bfloat16"}
    assert not np.array_equal(ref["float32"], ref["bfloat16"])
    np.testing.assert_allclose(ours["float32"], ref["float32"], rtol=1e-4, atol=1e-4)
    _gates(ours["bfloat16"], ref["bfloat16"], ref["float32"], MODEL_RTOL, "all-atom confidence", "rms",
           MODEL_GAP_SHARE)


def test_two_step_dock_in_bf16_matches_jax(tables):
    """A 2-step dock of a synthetic complex with the JAX pipeline's own draws
    injected: the port's bfloat16 poses against JAX's bfloat16 dock, much
    closer to it than JAX's float32 dock is."""
    js, jt, ps, pt = tables
    kw = dict(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=1)
    jcfg, cfg = JScoreModelConfig(**kw), ScoreModelConfig(**kw)
    jdata = j_complexes.synthetic_complex(np.random.RandomState(0), n_lig=10, n_rec=24, n_bonds=2)
    params = _perturbed(jax.jit(JCGScoreModel(jcfg).init)(
        jax.random.PRNGKey(2), jdata, jnp.asarray(jdata.lig_pos), jnp.asarray(0.5), js, jt), 2)
    data = synthetic_complex(np.random.RandomState(0), n_lig=10, n_rec=24, n_bonds=2)
    P, seed, steps = 3, 3, 2
    poses = {}
    for dtype in ("float32", "bfloat16"):
        jpipe = JDockingPipeline(dataclasses.replace(jcfg, compute_dtype=dtype), params,
                                 JSamplerConfig(inference_steps=steps, actual_steps=steps),
                                 so3_tables=js, torus_tables=jt)
        poses["jax", dtype] = jpipe.dock_complex(jdata, num_poses=P, seed=seed).poses
    bcfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    pipe = DockingPipeline(bcfg, state_dict_from_flax(params, bcfg),
                           SamplerConfig(inference_steps=steps, actual_steps=steps), ps, pt, device="cpu")
    res = pipe.dock_complex(data, num_poses=P, seed=seed, noise=_jax_noise(steps))
    assert res.poses.shape == (P, 10, 3) and np.isfinite(res.poses).all()
    # the sampler carries the models' one-ulp differences into the poses,
    # which move ~200 A here: within 2e-3 of the poses' scale at the largest
    # coordinate, and 0.4 of JAX's bf16-vs-f32 gap in RMS
    _gates(res.poses, poses["jax", "bfloat16"], poses["jax", "float32"], 2e-3, "dock", "rms",
           MODEL_GAP_SHARE)
