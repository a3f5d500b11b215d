"""Equivariant ops of the PyTorch port against the JAX package on the CPU.

Inputs are made with numpy from a seed and go through the JAX function and
its port counterpart. Tolerances are float32: both sides compute the same
arithmetic, in orders that may differ, so 1e-5 relative (2e-4 absolute on
outputs of order 1-10 that sum tens to hundreds of products).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdock_tpu.models.encoders import FCBlock as JFCBlock
from diffdock_tpu.models.tpconv import NeighborBlock as JBlock
from diffdock_tpu.models.tpconv import _tp_message_reduced as j_reduced
from diffdock_tpu.ops import batch_norm as j_bn
from diffdock_tpu.ops import linear as j_linear
from diffdock_tpu.ops import pallas_tpconv3 as j_tp3
from diffdock_tpu.ops import segment as j_segment
from diffdock_tpu.ops import spherical as j_sph
from diffdock_tpu.ops import tensor_product as j_tp
from diffdock_tpu.ops.wigner import real_wigner_3j as j_w3j
from diffdock_tpu_torch.models.encoders import FCBlock
from diffdock_tpu_torch.models.tpconv import NeighborBlock, _tp_message_reduced
from diffdock_tpu_torch.ops import fused_tp3 as ft
from diffdock_tpu_torch.ops.batch_norm import IrrepsBatchNorm
from diffdock_tpu_torch.ops.linear import IrrepsLinear
from diffdock_tpu_torch.ops.segment import masked_mean_pool, multi_group_mean
from diffdock_tpu_torch.ops.spherical import irrep1_to_vector, spherical_harmonics
from diffdock_tpu_torch.ops.tensor_product import FullTensorProduct, FullyConnectedTensorProduct
from diffdock_tpu_torch.ops.wigner import real_wigner_3j

IN_IR = "8x0e + 4x1o + 4x1e + 4x0o"
SH_IR = "1x0e + 1x1o + 1x2e"
OUT_IR = "8x0e + 4x1o + 4x1e + 4x0o"
T = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(a, b, rtol=1e-5, atol=2e-4):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def test_wigner_is_the_same_table():
    for ls in [(1, 1, 2), (2, 2, 2), (1, 2, 3), (2, 2, 4), (0, 2, 2)]:
        np.testing.assert_array_equal(real_wigner_3j(*ls), j_w3j(*ls))


@pytest.mark.parametrize("lmax", [0, 1, 2])
def test_spherical_harmonics(lmax):
    vec = np.random.RandomState(lmax).randn(7, 5, 3).astype(np.float32)
    vec[0, 0] = 0.0  # padded edge
    close(spherical_harmonics(T(vec), lmax), j_sph.spherical_harmonics(jnp.asarray(vec), lmax),
          rtol=1e-6, atol=1e-6)
    u = np.random.RandomState(9).randn(4, 3).astype(np.float32)
    close(irrep1_to_vector(T(u)), j_sph.irrep1_to_vector(jnp.asarray(u)), rtol=0, atol=0)


@pytest.mark.parametrize("irreps", [(IN_IR, SH_IR, OUT_IR),
                                    ("6x0e", SH_IR, "6x0e + 2x1o"),
                                    ("5x0e + 3x1o", "1x0e + 1x1o", "2x1e + 3x0o + 4x1o")])
def test_tp_coupling_and_weighted_product(irreps):
    tp, jtp = FullyConnectedTensorProduct(*irreps), j_tp.FullyConnectedTensorProduct(*irreps)
    assert tp.weight_numel == jtp.weight_numel and tp.weight_slices() == jtp.weight_slices()
    rng = np.random.RandomState(0)
    x1 = rng.randn(6, tp.irreps_in1.dim).astype(np.float32)
    x2 = rng.randn(6, tp.irreps_in2.dim).astype(np.float32)
    w = rng.randn(6, tp.weight_numel).astype(np.float32)
    for k, *_ in tp.live_classes():
        close(tp.coupled_class(k, T(x1), T(x2)), jtp.coupled_class(k, jnp.asarray(x1), jnp.asarray(x2)))
        close(tp.coupled_class_merged(k, T(x1), T(x2)),
              jtp.coupled_class_merged(k, jnp.asarray(x1), jnp.asarray(x2)))
    close(tp(T(x1), T(x2), T(w)), jtp(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(w)))
    t = rng.randn(3, 4, 2).astype(np.float32)
    close(tp.expand_weight_identity(T(t), 3), jtp.expand_weight_identity(jnp.asarray(t), 3), 0, 0)
    close(tp.expand_bias_identity(T(t[0]), 5), jtp.expand_bias_identity(jnp.asarray(t[0]), 5), 0, 0)


def test_full_tensor_product_broadcasts_like_jax():
    ftp, jftp = FullTensorProduct(SH_IR, "2e"), j_tp.FullTensorProduct(SH_IR, "2e")
    assert str(ftp.irreps_out) == str(jftp.irreps_out)
    rng = np.random.RandomState(1)
    a = rng.randn(2, 3, 5, 9).astype(np.float32)
    b = rng.randn(2, 3, 1, 5).astype(np.float32)
    close(ftp(T(a), T(b)), jftp(jnp.asarray(a), jnp.asarray(b)))


def _tp3_inputs(tp, n, k, h_dim, seed=0):
    """The inputs of ``tests/test_pallas_tp3.py``, as numpy."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, k, tp.irreps_in1.dim).astype(np.float32)
    sh = rng.randn(n, k, tp.irreps_in2.dim).astype(np.float32)
    mw = (rng.rand(n, k) > 0.3).astype(np.float32)
    h = rng.randn(n, k, h_dim).astype(np.float32) * mw[..., None]
    wk = (rng.randn(h_dim, tp.weight_numel) * 0.1).astype(np.float32)
    wb = (rng.randn(tp.weight_numel) * 0.1).astype(np.float32)
    return x, sh, h, mw, wk, wb


@pytest.mark.parametrize("n,k", [(16, 8), (37, 8)])
def test_fused_tp3_reference_matches_pallas_interpret_and_xla(n, k):
    jtp = j_tp.FullyConnectedTensorProduct(IN_IR, SH_IR, OUT_IR)
    tp = FullyConnectedTensorProduct(IN_IR, SH_IR, OUT_IR)
    args = _tp3_inputs(tp, n, k, h_dim=24)
    jargs = [jnp.asarray(a) for a in args]
    pallas = j_tp3._forward_pallas(jtp, *jargs, block_rows=16, interpret=True)
    xla = j_tp3._forward_xla(jtp, *jargs)
    before = ft.counts["fused_tp3_reference"]
    ours = ft.fused_tp3_reference(tp, *[T(a) for a in args])
    assert ft.counts["fused_tp3_reference"] == before + 1
    assert ours.shape == pallas.shape == (n, tp.irreps_out.dim)
    close(ours, pallas, rtol=2e-4, atol=2e-4)
    close(ours, xla, rtol=2e-4, atol=2e-4)


def test_fused_tp3_on_cpu_runs_the_plain_version_and_keeps_empty_classes_zero():
    # '3x2e' has no path from these inputs: an empty class the wrapper zero-fills
    tp = FullyConnectedTensorProduct("4x0e + 2x1o", "1x0e + 1x1o", "4x0e + 3x2o + 2x1o")
    jtp = j_tp.FullyConnectedTensorProduct("4x0e + 2x1o", "1x0e + 1x1o", "4x0e + 3x2o + 2x1o")
    assert len(tp.live_classes()) == 2
    args = _tp3_inputs(tp, 9, 5, h_dim=6, seed=3)
    before = ft.counts.as_dict()
    out = ft.fused_tp3(tp, *[T(a) for a in args])
    after = ft.counts.as_dict()
    assert after["fused_tp3"] == before["fused_tp3"]
    assert after["fused_tp3_reference"] == before["fused_tp3_reference"] + 1
    ref = j_tp3._forward_xla(jtp, *[jnp.asarray(a) for a in args])
    close(out, ref, rtol=2e-4, atol=2e-4)
    assert np.all(out[:, 4:19].numpy() == 0.0)


def test_fused_tp3_launch_refuses_cpu_operands():
    """The float32 kernel's entry raises on a CPU tensor (before any build);
    it never falls back to the plain version. ``launch`` and ``prepare``
    take the bfloat16 kernel's operands only."""
    tp = FullyConnectedTensorProduct(IN_IR, SH_IR, OUT_IR)
    args = [T(a) for a in _tp3_inputs(tp, 4, 3, h_dim=5)]
    with pytest.raises(ValueError, match="CUDA"):
        ft.forward_f32(tp, *args)
    with pytest.raises(TypeError, match="forward_f32"):
        ft.prepare(tp, *args)
    with pytest.raises(TypeError, match="forward_f32"):
        ft.launch(torch.zeros(2, 3, 4), torch.zeros(2, 3, 5), torch.zeros(20),
                  np.array([[0, 5, 1, 1, 0, 0]], np.int64))


def test_class_table_matches_the_packed_weights():
    tp = FullyConnectedTensorProduct(IN_IR, SH_IR, OUT_IR)
    classes = tp.live_classes()
    table = ft.class_table(classes, 25)
    blocks = ft.class_weights(tp, classes, torch.zeros(24, tp.weight_numel), torch.zeros(tp.weight_numel))
    assert [tuple(b.shape) for b in blocks] == [(25, fan, mul) for _k, _o, fan, _d, mul in classes]
    assert table[:, 5].tolist() == np.cumsum([0] + [b.numel() for b in blocks[:-1]]).tolist()
    assert int((table[:, 3] * table[:, 2]).sum()) == tp.irreps_out.dim


def _jax_fc(h_dim, out_dim, in_dim, seed):
    fc = JFCBlock(hidden_dim=h_dim, out_dim=out_dim)
    params = fc.init(jax.random.PRNGKey(seed), jnp.zeros((1, in_dim)))
    rng = np.random.RandomState(seed)
    params = jax.tree.map(lambda p: np.asarray(p) + 0.2 * rng.randn(*p.shape).astype(np.float32), params)
    return fc, params


def _torch_fc(params, in_dim, h_dim, out_dim):
    fc = FCBlock(in_dim, h_dim, out_dim)
    p = params["params"]
    with torch.no_grad():
        fc.layers[0].weight.copy_(T(p["Dense_0"]["kernel"]).T)
        fc.layers[0].bias.copy_(T(p["Dense_0"]["bias"]))
        fc.out_kernel.copy_(T(p["out_kernel"]))
        fc.out_bias.copy_(T(p["out_bias"]))
    return fc


@pytest.mark.parametrize("merged", [True, False])
@pytest.mark.parametrize("with_weight", [False, True])
def test_tp_message_reduced_matches_jax(merged, with_weight):
    tp = FullyConnectedTensorProduct(IN_IR, SH_IR, OUT_IR)
    jtp = j_tp.FullyConnectedTensorProduct(IN_IR, SH_IR, OUT_IR)
    R, K, S, E, H = 7, 6, 9, 10, 12
    rng = np.random.RandomState(4)
    sender = rng.randn(S, tp.irreps_in1.dim).astype(np.float32)
    idx = rng.randint(0, S, size=(R, K)).astype(np.int32)
    mask = rng.rand(R, K) > 0.3
    eattr = rng.randn(R, K, E).astype(np.float32)
    esh = rng.randn(R, K, tp.irreps_in2.dim).astype(np.float32)
    ew = rng.rand(R, K).astype(np.float32) if with_weight else None

    jfc, params = _jax_fc(H, tp.weight_numel, E, seed=5)
    jblk = JBlock(jnp.asarray(sender), jnp.asarray(idx), jnp.asarray(mask), jnp.asarray(eattr),
                  jnp.asarray(esh), None if ew is None else jnp.asarray(ew))
    jsum, jcnt = jfc.apply(params, method=lambda m: j_reduced(jtp, m, jblk, False, merged=merged))

    fc = _torch_fc(params, E, H, tp.weight_numel)
    blk = NeighborBlock(T(sender)[None], torch.from_numpy(idx).long()[None],
                        torch.from_numpy(mask)[None], T(eattr)[None], T(esh)[None],
                        None if ew is None else T(ew)[None])
    with torch.no_grad():
        s, c = _tp_message_reduced(tp, fc, blk, merged=merged)
    close(s[0], jsum)
    close(c[0], jcnt, rtol=0, atol=0)


def test_irreps_batch_norm_eval_matches_jax():
    irreps = "6x0e + 3x1o + 2x0o + 2x2e"
    bn = j_bn.IrrepsBatchNorm(irreps=j_bn.Irreps(irreps))
    x = np.random.RandomState(6).randn(11, bn.irreps.dim).astype(np.float32)
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.RandomState(7)
    v = jax.tree.map(lambda p: np.asarray(p) + 0.3 * np.abs(rng.randn(*p.shape)).astype(np.float32), v)
    ref = bn.apply(v, jnp.asarray(x), train=False)
    ours = IrrepsBatchNorm(irreps)
    with torch.no_grad():
        ours.weight.copy_(T(v["params"]["weight"]))
        ours.bias.copy_(T(v["params"]["bias"]))
        ours.running_mean.copy_(T(v["batch_stats"]["mean"]))
        ours.running_var.copy_(T(v["batch_stats"]["var"]))
        close(ours(T(x)), ref, rtol=1e-6, atol=1e-6)


def test_irreps_linear_matches_jax():
    ir_in, ir_out = "4x0e + 3x1o + 2x1o", "5x0e + 2x1o + 3x2e"
    lin = j_linear.IrrepsLinear(irreps_in=ir_in, irreps_out=ir_out)
    x = np.random.RandomState(8).randn(6, 4 + 9 + 6).astype(np.float32)
    v = lin.init(jax.random.PRNGKey(1), jnp.asarray(x))
    ours = IrrepsLinear(ir_in, ir_out)
    with torch.no_grad():
        for name, p in v["params"].items():
            getattr(ours, name).copy_(T(p))
        close(ours(T(x)), lin.apply(v, jnp.asarray(x)), rtol=1e-6, atol=1e-6)


def test_masked_reductions_match_jax():
    rng = np.random.RandomState(10)
    parts = [rng.randn(5, k, 4).astype(np.float32) for k in (3, 6)]
    masks = [rng.rand(5, k) > 0.4 for k in (3, 6)]
    close(multi_group_mean([T(p) for p in parts], [torch.from_numpy(m) for m in masks]),
          j_segment.multi_group_mean([jnp.asarray(p) for p in parts], [jnp.asarray(m) for m in masks]),
          rtol=1e-6, atol=1e-6)
    close(masked_mean_pool(T(parts[0]), torch.from_numpy(masks[0])),
          j_segment.masked_mean_pool(jnp.asarray(parts[0]), jnp.asarray(masks[0])),
          rtol=1e-6, atol=1e-6)
