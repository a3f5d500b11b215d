"""fused_tp3's gradient on the CPU: the autograd Function against
``jax.vjp`` of the JAX package's ``make_fused_tp_messages(tp,
interpret=True)`` (the gen-3 Pallas kernel in interpret mode forward, the
VJP of its einsum path backward) for all six inputs, at the TPs of the
score model's three block types and at a TP with an empty output class;
and the Function's own backward with an injected forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdock_tpu.ops import tensor_product as j_tp
from diffdock_tpu.ops.pallas_tpconv3 import make_fused_tp_messages
from diffdock_tpu_torch.models.config import ScoreModelConfig
from diffdock_tpu_torch.models.score_model import CGScoreModel
from diffdock_tpu_torch.ops import fused_tp3 as ft
from diffdock_tpu_torch.ops.tensor_product import FullyConnectedTensorProduct

T = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
N = lambda a: np.asarray(a)  # noqa: E731


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tp_inputs(tp_dims, n, k, h_dim, seed):
    d1, d2, wn = tp_dims
    rng = np.random.RandomState(seed)
    x = rng.randn(n, k, d1).astype(np.float32)
    sh = rng.randn(n, k, d2).astype(np.float32)
    mw = (rng.rand(n, k) > 0.3).astype(np.float32) * rng.uniform(0.5, 1.0, (n, k)).astype(np.float32)
    h = rng.randn(n, k, h_dim).astype(np.float32) * mw[..., None]
    wk = (rng.randn(h_dim, wn) * 0.1).astype(np.float32)
    wb = (rng.randn(wn) * 0.1).astype(np.float32)
    return x, sh, h, mw, wk, wb


def _score_model_tps():
    """The TPs of the three score-model block types of a small
    DiffDock-L-like model (receptor embedding, joint conv, torsion head),
    and a TP with an empty output class (1e: no path reaches it)."""
    cfg = ScoreModelConfig(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=1,
                           reduce_pseudoscalars=True)
    m = CGScoreModel(cfg)
    tps = {"rec_emb": m.rec_emb_layers[0].tp, "joint conv": m.conv_layers[0].tp,
           "torsion": m.tor_bond_conv.tp}
    tps["empty class"] = FullyConnectedTensorProduct("8x0e", "1x0e + 1x1o + 1x2e",
                                                     "8x0e + 2x1o + 2x1e")
    return tps


@pytest.mark.parametrize("block", ["rec_emb", "joint conv", "torsion", "empty class"])
def test_fused_tp3_gradients_match_jax_vjp(block):
    tp = _score_model_tps()[block]
    irr = (str(tp.irreps_in1), str(tp.irreps_in2), str(tp.irreps_out))
    jtp = j_tp.FullyConnectedTensorProduct(*irr)
    args = _tp_inputs((tp.irreps_in1.dim, tp.irreps_in2.dim, tp.weight_numel), 9, 5, 12, seed=8)
    g = np.random.RandomState(9).randn(9, tp.irreps_out.dim).astype(np.float32)
    f = make_fused_tp_messages(jtp, interpret=True)
    ref_out, vjp = jax.vjp(f, *[jnp.asarray(a) for a in args])
    ref_grads = vjp(jnp.asarray(g))

    ft.counts.reset()
    leaves = [T(a).requires_grad_(True) for a in args]
    out = ft.fused_tp3(tp, *leaves)
    grads = torch.autograd.grad(out, leaves, T(g))
    np.testing.assert_allclose(out.detach().numpy(), N(ref_out), rtol=1e-4, atol=1e-4)
    for name, a, b in zip(("x_nbr", "edge_sh", "h", "mw", "out_kernel", "out_bias"), grads, ref_grads):
        # float32 sums over K * (H+1) terms in different orders
        scale = max(np.abs(N(b)).max(), 1.0)
        assert np.abs(a.numpy() - N(b)).max() <= 1e-4 * scale, name
    assert ft.counts["fused_tp3_vjp"] == 1 and ft.counts["fused_tp3_reference"] == 1


def test_fused_tp3_function_backward_with_an_injected_forward():
    """The autograd Function's own backward, with a stand-in forward (as
    the kernel would be on the card): gradients are the plain version's,
    counted under ``fused_tp3_vjp``, and nothing is saved or counted when
    no gradient is wanted."""
    tp = _score_model_tps()["joint conv"]
    args = [T(a) for a in _tp_inputs((tp.irreps_in1.dim, tp.irreps_in2.dim, tp.weight_numel),
                                     6, 4, 10, seed=10)]
    calls = []

    def forward(tp_, *a):
        calls.append(1)
        return ft._plain(tp_, *a)

    ft.counts.reset()
    leaves = [a.clone().requires_grad_(i in (2, 4)) for i, a in enumerate(args)]
    out = ft.PlainVJP.apply(tp, forward, ft._vjp_plain, "fused_tp3_vjp", *leaves)
    g_h, g_k = torch.autograd.grad(out.square().sum(), [leaves[2], leaves[4]])
    ref = [a.clone().requires_grad_(i in (2, 4)) for i, a in enumerate(args)]
    r_h, r_k = torch.autograd.grad(ft._plain(tp, *ref).square().sum(), [ref[2], ref[4]])
    torch.testing.assert_close(g_h, r_h, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(g_k, r_k, rtol=1e-5, atol=1e-6)
    assert calls == [1] and ft.counts.as_dict() == {
        "fused_tp3": 0, "fused_tp3_bf16": 0, "fused_tp3_reference": 0, "fused_tp3_vjp": 1}
    with torch.inference_mode():
        out = ft.fused_tp3(tp, *leaves)
    assert out.grad_fn is None and ft.counts["fused_tp3_vjp"] == 1


def test_a_tp_used_under_inference_mode_first_still_differentiates():
    """The TP's cached constants (CG matrices) are made as normal tensors
    even inside ``torch.inference_mode`` (a dock), so a training forward
    through the same layers can save them for backward."""
    tp = _score_model_tps()["rec_emb"]
    args = [T(a) for a in _tp_inputs((tp.irreps_in1.dim, tp.irreps_in2.dim, tp.weight_numel),
                                     5, 4, 8, seed=12)]
    with torch.inference_mode():
        ft.fused_tp3(tp, *args)
    leaves = [a.clone().requires_grad_(True) for a in args]
    grads = torch.autograd.grad(ft.fused_tp3(tp, *leaves).sum(), leaves)
    assert all(torch.isfinite(g).all() for g in grads)
