"""The bfloat16 modes of the port's gen-2 and gen-1 factored TP contractions
against the JAX Pallas kernels on the CPU.

Both TPU kernels take bfloat16 operands when ``x_nbr`` is bfloat16
(``pallas_tpconv2.py:_forward_pallas`` at :219, ``pallas_tpconv.py``'s
casts to ``xp.dtype`` at :140-198). On CPU tensors the port's wrappers run
``factored_tp_bf16_reference``; it is held here against the Pallas
functions run EAGERLY in interpret mode (under ``jax.jit`` XLA:CPU refuses
their bfloat16 dots: ``DotThunk::Execute: BF16 x BF16 = F32``), on the
irreps of ``tests/test_torch_port_factored_tp.py`` with receiver counts
that leave padding rows, and on gen 1's mixed case (bfloat16 ``x_nbr``,
float32 ``edge_sh``, ``h`` and ``mw``, which gen 1 leaves in their dtype
where gen 2 casts them).

The gates are those of the message in ``tests/test_torch_port_bf16.py``:
the port within 1e-3 of the output's scale (both round at the same places
and differ in the order of float32 sums, so a rounding near a tie may go
the other way) and within 0.2 of JAX's own bfloat16-vs-float32 gap in RMS,
which a port that computes in float32 fails. The CPU walk of the bfloat16
kernel's blocking, ``tests/test_torch_port_tp21_bf16_tiles.py``, is held to
the same plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdock_tpu.ops import pallas_tpconv as j_gen1
from diffdock_tpu.ops import pallas_tpconv2 as j_gen2
from diffdock_tpu.ops.tensor_product import FullyConnectedTensorProduct as JTP
from diffdock_tpu_torch.ops import factored_tp1 as f1
from diffdock_tpu_torch.ops import factored_tp2 as f2
from diffdock_tpu_torch.ops.tensor_product import FullyConnectedTensorProduct
from tests.test_torch_port_factored_tp import IRREPS, SH, _inputs

BF16 = torch.bfloat16
# classes of one path and d3 = 1, whose chain gen 1 ends in float32: the
# 16x0e class of a DiffDock ladder's first layer (one-term chains) and the
# 2x0o class of IRREPS[1] (three-term chains)
CHAIN_F32 = [("16x0e", "16x0e + 4x1o"), IRREPS[1]]
MESSAGE_RTOL = 1e-3
GAP_SHARE = 0.2


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tps(irreps):
    return FullyConnectedTensorProduct(irreps[0], SH, irreps[1]), JTP(irreps[0], SH, irreps[1])


def _gates(ours, ref, ref_f32):
    """(error / scale, RMS error / RMS gap), asserting both gates."""
    ours, ref, ref_f32 = (np.asarray(a, np.float64) for a in (ours, ref, ref_f32))
    scale = max(np.abs(ref).max(), 1.0)
    rms = lambda d: np.sqrt(np.mean(d * d))  # noqa: E731
    err, gap = np.abs(ours - ref).max() / scale, rms(ref - ref_f32)
    assert gap > 0
    assert err <= MESSAGE_RTOL, f"{err:.3e} of scale > {MESSAGE_RTOL}"
    assert rms(ours - ref) <= GAP_SHARE * gap, f"{rms(ours - ref):.3e} > {GAP_SHARE} x gap {gap:.3e}"
    return err, rms(ours - ref) / gap


def _jax(fn, jtp, arrays, bf16_mask):
    """``fn`` eagerly on ``arrays``, each cast to bfloat16 where the mask says."""
    args = [jnp.asarray(a, jnp.bfloat16) if m else jnp.asarray(a) for a, m in zip(arrays, bf16_mask)]
    return np.asarray(fn(jtp, *args))


def _gen2(jtp, *args):
    return j_gen2._forward_pallas(jtp, *args, block_rows=16, interpret=True)


def _gen1(jtp, *args):
    return j_gen1.factored_tp_messages_pallas(jtp, *args, block_rows=16, interpret=True)


ALL_BF16 = (True, True, True, True, False, False)
MIXED = (True, False, False, False, False, False)


@pytest.mark.parametrize("irreps", IRREPS)
@pytest.mark.parametrize("n,k", [(16, 8), (37, 5)])
def test_factored_tp2_bf16_matches_jax_gen2_kernel(irreps, n, k):
    tp, jtp = _tps(irreps)
    args = _inputs(tp, n, k, h_dim=24)
    ref = _jax(_gen2, jtp, args, ALL_BF16)
    ref_f32 = _jax(_gen2, jtp, args, (False,) * 6)
    before = f2.counts.as_dict()
    # float32 h, sh, mw and weights: gen 2 casts them itself
    out = f2.factored_tp2(tp, torch.from_numpy(args[0]).to(BF16), *map(torch.from_numpy, args[1:]))
    after = f2.counts.as_dict()
    assert after["factored_tp_reference"] == before["factored_tp_reference"] + 1
    assert after["factored_tp2_bf16"] == before["factored_tp2_bf16"]
    assert out.dtype == torch.float32 and out.shape == ref.shape
    _gates(out.numpy(), ref, ref_f32)


@pytest.mark.parametrize("irreps", IRREPS)
@pytest.mark.parametrize("n,k", [(16, 8), (37, 5)])
@pytest.mark.parametrize("mixed", [False, True])
def test_factored_tp1_bf16_matches_jax_gen1_kernel(irreps, n, k, mixed):
    """All-bfloat16 operands, and gen 1's mixed case: a bfloat16 x_nbr with
    float32 edge_sh, h and mw, which gen 1 leaves in float32 (its CG
    weights and P then take float32 products before their rounding)."""
    tp, jtp = _tps(irreps)
    args = _inputs(tp, n, k, h_dim=24, seed=1)
    mask = MIXED if mixed else ALL_BF16
    ref = _jax(_gen1, jtp, args, mask)
    ref_f32 = _jax(_gen1, jtp, args, (False,) * 6)
    t_args = [torch.from_numpy(a).to(BF16) if m else torch.from_numpy(a) for a, m in zip(args, mask)]
    before = f1.counts.as_dict()
    out = f1.factored_tp1(tp, *t_args)
    assert f1.counts.as_dict() == before  # a CPU tensor never launches
    _gates(out.numpy(), ref, ref_f32)


def test_the_modes_differ_where_the_jax_kernels_differ():
    """Gen 2's and gen 1's all-bfloat16 results agree (JAX: to 1.2e-7, a
    float32 ulp); gen 1's mixed case does not round like gen 2 fed the
    same arrays (gen 2 casts them), by about the bf16-vs-f32 gap, in both
    packages alike."""
    tp, jtp = _tps(IRREPS[0])
    args = _inputs(tp, 16, 8, h_dim=24)
    t = [torch.from_numpy(a) for a in args]
    g2 = f2.factored_tp_bf16_reference(tp, t[0].to(BF16), *t[1:], gen=2)
    g1 = f2.factored_tp_bf16_reference(tp, *[a.to(BF16) for a in t[:4]], *t[4:], gen=1)
    mixed = f2.factored_tp_bf16_reference(tp, t[0].to(BF16), *t[1:], gen=1)
    scale = max(g2.abs().max().item(), 1.0)
    assert (g2 - g1).abs().max().item() <= 1e-6 * scale
    j_mixed, j_g2 = _jax(_gen1, jtp, args, MIXED), _jax(_gen2, jtp, args, MIXED)
    assert np.abs(j_mixed - j_g2).max() > 1e-3 * scale
    assert (mixed - g2).abs().max().item() > 1e-3 * scale
    np.testing.assert_allclose(mixed.numpy(), j_mixed, atol=MESSAGE_RTOL * scale, rtol=0)


def test_coupling_chain_rounds_each_operation():
    """The JAX kernels in interpret mode round each product and each
    partial sum of the coupling's chain to bfloat16: a plain version whose
    chain is summed in float32 and rounded once misses them by ~4e-3 of
    scale (over the 1e-3 gate); the per-operation chain meets them."""
    tp, jtp = _tps(IRREPS[0])
    args = _inputs(tp, 16, 8, h_dim=24)
    ref = _jax(_gen2, jtp, args, ALL_BF16)
    scale = max(np.abs(ref).max(), 1.0)
    x = torch.from_numpy(args[0]).to(BF16)
    rest = [torch.from_numpy(a) for a in args[1:]]
    ours = f2.factored_tp_bf16_reference(tp, x, *rest)
    assert np.abs(ours.numpy() - ref).max() <= 1e-5 * scale

    merged = tp.coupled_class_merged

    def once(k, x1, x2, float_last=False):
        # the CG weights as the kernels round them, the chain in float32
        ek = tp.irreps_out[k]
        d3 = ek.ir.dim
        segs = []
        for p in tp.paths[k]:
            e1 = tp.irreps_in1[p.i]
            a = x1[..., tp._sl1[p.i]].float().reshape(x1.shape[:-1] + (e1.mul, e1.ir.dim))
            sh = x2[..., tp._sl2[p.j]].float()
            cgm = torch.from_numpy(p.cg.transpose(1, 0, 2).reshape(sh.shape[-1], -1)).to(BF16).float()
            W = (sh @ cgm).to(BF16).float()
            C = sum(a[..., :, i, None] * W[..., None, i * d3:(i + 1) * d3] for i in range(e1.ir.dim))
            segs.append(C.to(BF16).reshape(C.shape[:-2] + (e1.mul * d3,)))
        return torch.cat(segs, dim=-1)

    tp.coupled_class_merged = once
    try:
        rounded_once = f2.factored_tp_bf16_reference(tp, x, *rest)
    finally:
        tp.coupled_class_merged = merged
    assert np.abs(rounded_once.numpy() - ref).max() > MESSAGE_RTOL * scale


@pytest.mark.parametrize("irreps", CHAIN_F32)
def test_gen1_ends_a_lone_chain_in_float32(irreps):
    """Gen 1's Pallas body, where a class has one path and d3 = 1, hands
    the coupling's chain to P with no concatenation between, and XLA then
    leaves the chain's last step in float32: the plain version does so and
    meets the JAX kernel at the message gates; rounding that step too (as
    gen 2's body does) misses it by more than 1e-3 of scale."""
    tp, jtp = _tps(irreps)
    args = _inputs(tp, 37, 5, h_dim=24, seed=3)
    ref = _jax(_gen1, jtp, args, ALL_BF16)
    ref_f32 = _jax(_gen1, jtp, args, (False,) * 6)
    t_args = [torch.from_numpy(a).to(BF16) if m else torch.from_numpy(a) for a, m in zip(args, ALL_BF16)]
    _gates(f2.factored_tp_bf16_reference(tp, *t_args, gen=1).numpy(), ref, ref_f32)
    merged = tp.coupled_class_merged
    tp.coupled_class_merged = lambda k, x1, x2, float_last=False: merged(k, x1, x2)
    try:
        rounded = f2.factored_tp_bf16_reference(tp, *t_args, gen=1).numpy()
    finally:
        tp.coupled_class_merged = merged
    assert np.abs(rounded - ref).max() > MESSAGE_RTOL * max(np.abs(ref).max(), 1.0)


def test_gen1_prepare_widens_a_mixed_hidden_pair():
    """Gen 1's bfloat16 mode keeps h and mw in their dtypes, as JAX does
    (float32 products where either is float32): prepare hands a float32 or
    mixed pair to the kernel as three bfloat16 parts of each, whose sum is
    the float32 value exactly, and a bfloat16 pair of any H as it is."""
    tp, _ = _tps(IRREPS[0])
    x, sh, h, mw, wk, wb = (torch.from_numpy(a) for a in _inputs(tp, 5, 3, h_dim=7, seed=4))
    xb = x.to(BF16)
    for hh, mm in ((h.to(BF16), mw), (h, mw.to(BF16)), (h, mw)):  # H = 7: odd
        _xs, h1, mw1, *_, call = f1.prepare(tp, xb, sh, hh, mm, wk, wb)
        assert call.parts == 3 and h1.dtype == mw1.dtype == BF16
        assert torch.equal(sum(h1[..., 8 * q: 8 * q + 7].float() for q in range(3)), hh.float())
        assert torch.equal(mw1.float().sum(1), mm.float())
    _xs, h1, mw1, *_, call = f1.prepare(tp, xb, sh, h.to(BF16), mw.to(BF16), wk, wb)
    assert call.parts == 1 and torch.equal(h1, h.to(BF16))


def test_prepare_casts_as_each_tpu_wrapper():
    """Gen 2 casts every operand to bfloat16 once (sh, h and mw; the CG
    matrix and the weights with the bias as row H, unscaled); gen 1 casts
    x, the CG matrix and T and b, and keeps sh, h and mw in their dtypes
    (a float32 sh goes to the kernel as three bfloat16 parts, exactly)."""
    tp, _ = _tps(IRREPS[0])
    x, sh, h, mw, wk, wb = (torch.from_numpy(a) for a in _inputs(tp, 5, 3, h_dim=6, seed=2))
    xb = x.to(BF16)
    xs, h2, mw2, cg, weights, _geo, call = f2.prepare(tp, xb, sh, h, mw, wk, wb)
    assert all(t.dtype == BF16 for t in (xs, h2, mw2, cg, weights)) and call.parts == 1
    assert not call.sh_f32 and torch.equal(h2, h.to(BF16)) and torch.equal(mw2[:, 0], mw.to(BF16))
    assert torch.equal(xs[..., :call.J], sh.to(BF16))
    assert torch.equal(xs[..., f2.BF16_MAX_J:f2.BF16_MAX_J + call.F], xb)
    slices = call.slices
    plan = f2.bf16_plan(slices, 5, 3, 6, call.F, call.J, False, False)
    packed = f2.bf16_weight_index(slices, plan)
    flat = torch.cat([b for off, fan, mul in tp.weight_slices()
                      for b in (wk[:, off:off + fan * mul].reshape(-1), wb[off:off + fan * mul])]
                     + [wb.new_zeros(1)])
    assert torch.equal(weights, flat.to(BF16)[torch.from_numpy(packed)])
    xs1, h1, mw1, cg1, w1, _g, call1 = f1.prepare(tp, xb, sh, h, mw, wk, wb)
    assert xs1.dtype == cg1.dtype == w1.dtype == BF16 and call1.sh_f32
    parts = [xs1[..., q * f2.BF16_MAX_J:q * f2.BF16_MAX_J + call1.J].float() for q in range(3)]
    assert torch.equal(parts[0] + parts[1] + parts[2], sh)
    assert call1.parts == 3


def test_bf16_mode_refuses_gradients_and_unknown_dtypes():
    tp, _ = _tps(IRREPS[0])
    args = [torch.from_numpy(a) for a in _inputs(tp, 3, 2, h_dim=4)]
    bf = [args[0].to(BF16)] + args[1:4] + [args[4].requires_grad_(), args[5]]
    with pytest.raises(TypeError, match="gradient"):
        f2.factored_tp2(tp, *bf)
    with torch.no_grad():
        assert f2.factored_tp2(tp, *bf).dtype == torch.float32
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        f2.launch(torch.zeros(2, 3, 4, dtype=torch.float16), *[None] * 8)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        f1.launch(torch.zeros(2, 3, 4, dtype=torch.float16), *[None] * 9)
    with pytest.raises(TypeError, match="bfloat16"):
        f2.factored_tp_bf16_reference(tp, *args)
