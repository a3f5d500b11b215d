"""The port's gen-2 and gen-1 factored TP contractions vs the JAX package on the CPU.

On CPU tensors ``factored_tp2`` and ``factored_tp1`` run the plain version
(``factored_tp_reference``, the port of ``pallas_tpconv2.py:_forward_xla``);
they are held against the JAX Pallas kernels run in interpret mode, on the
irreps of ``tests/test_pallas_tp2.py`` and on a small DiffDock-L ladder
layer, with receiver counts that leave padding rows in the JAX kernels'
row blocks. The host-side packing the CUDA kernels read (CG matrices,
packed neighbour features, class tables) is held against the JAX
package's own. Float32 throughout: 2e-4 on outputs of magnitude ~1-10, the
JAX gen-2 test's own tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdock_tpu.ops import pallas_tpconv as j_gen1
from diffdock_tpu.ops import pallas_tpconv2 as j_gen2
from diffdock_tpu.ops.tensor_product import FullyConnectedTensorProduct as JTP
from diffdock_tpu_torch.ops import factored_tp1 as f1
from diffdock_tpu_torch.ops import factored_tp2 as f2
from diffdock_tpu_torch.ops.irreps import get_irrep_seq
from diffdock_tpu_torch.ops.tensor_product import FullyConnectedTensorProduct

SH = "1x0e + 1x1o + 1x2e"
PALLAS_TP2 = ("8x0e + 4x1o + 4x1e + 4x0o", "8x0e + 4x1o + 4x1e + 4x0o")
# a layer >= 1 of a small DiffDock-L ladder (reduce_pseudoscalars): no
# output class without a path
LADDER_L = tuple(get_irrep_seq(8, 2, False, True)[2:4])
IRREPS = [PALLAS_TP2, LADDER_L]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(tp, n, k, h_dim, seed=0):
    rng = np.random.RandomState(seed)
    mw = (rng.rand(n, k) > 0.3).astype(np.float32)
    x = rng.randn(n, k, tp.irreps_in1.dim).astype(np.float32)
    sh = rng.randn(n, k, tp.irreps_in2.dim).astype(np.float32)
    h = rng.randn(n, k, h_dim).astype(np.float32) * mw[..., None]
    wk = (rng.randn(h_dim, tp.weight_numel) * 0.1).astype(np.float32)
    wb = (rng.randn(tp.weight_numel) * 0.1).astype(np.float32)
    return x, sh, h, mw, wk, wb


def _tps(irreps):
    return FullyConnectedTensorProduct(irreps[0], SH, irreps[1]), JTP(irreps[0], SH, irreps[1])


@pytest.mark.parametrize("irreps", IRREPS)
@pytest.mark.parametrize("n,k", [(16, 8), (37, 5)])
def test_factored_tp2_matches_jax_gen2_kernel(irreps, n, k):
    tp, jtp = _tps(irreps)
    args = _inputs(tp, n, k, h_dim=24)
    ref = j_gen2.make_factored_tp_messages(jtp, interpret=True, block_rows=16)(
        *[jnp.asarray(a) for a in args])
    before = f2.counts.as_dict()
    out = f2.factored_tp2(tp, *[torch.from_numpy(a) for a in args])
    after = f2.counts.as_dict()
    # a CPU tensor runs the plain version, never the kernel
    assert after["factored_tp2"] == before["factored_tp2"]
    assert after["factored_tp_reference"] == before["factored_tp_reference"] + 1
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("irreps", IRREPS)
@pytest.mark.parametrize("n,k", [(16, 8), (37, 5)])
def test_factored_tp1_matches_jax_gen1_kernel(irreps, n, k):
    tp, jtp = _tps(irreps)
    args = _inputs(tp, n, k, h_dim=24, seed=1)
    ref = j_gen1.factored_tp_messages_pallas(jtp, *[jnp.asarray(a) for a in args],
                                             block_rows=16, interpret=True)
    before = f1.counts["factored_tp1"]
    out = f1.factored_tp1(tp, *[torch.from_numpy(a) for a in args])
    assert f1.counts["factored_tp1"] == before
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("irreps", IRREPS)
def test_factored_tp2_gradients_match_jax(irreps):
    """Gradients w.r.t. h and out_kernel through the autograd Function (its
    backward differentiates the plain version) vs ``jax.grad`` of
    ``_forward_xla``."""
    tp, jtp = _tps(irreps)
    args = _inputs(tp, 9, 6, h_dim=16, seed=2)
    g_ref = jax.grad(lambda *a: jnp.sum(j_gen2._forward_xla(jtp, *a) ** 2), argnums=(2, 4))(
        *[jnp.asarray(a) for a in args])
    t_args = [torch.from_numpy(a) for a in args]
    t_args[2].requires_grad_(True)
    t_args[4].requires_grad_(True)
    loss = (f2.factored_tp2(tp, *t_args) ** 2).sum()
    g_h, g_k = torch.autograd.grad(loss, [t_args[2], t_args[4]])
    np.testing.assert_allclose(g_h.numpy(), np.asarray(g_ref[0]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(g_k.numpy(), np.asarray(g_ref[1]), rtol=1e-4, atol=1e-4)


def test_both_packages_refuse_a_tp_with_an_empty_class():
    """Scalar inputs against harmonics up to l = 2 cannot reach ``1e``: that
    output class has no path (fan 0)."""
    tp, jtp = _tps(("8x0e", "8x0e + 2x1o + 2x1e"))
    assert tp.fan_in == [8, 8, 0]
    empty = 2
    args = _inputs(tp, 4, 3, h_dim=8, seed=3)
    jargs = [jnp.asarray(a) for a in args]
    with pytest.raises(ValueError, match="Need at least one array"):
        j_gen2._forward_xla(jtp, *jargs)
    with pytest.raises(ZeroDivisionError):
        j_gen2.make_factored_tp_messages(jtp, interpret=True)(*jargs)
    with pytest.raises(ZeroDivisionError):
        j_gen1.factored_tp_messages_pallas(jtp, *jargs, interpret=True)
    targs = [torch.from_numpy(a) for a in args]
    for fn in (f2.factored_tp2, f1.factored_tp1, f2.factored_tp_reference):
        with pytest.raises(ValueError, match=f"output class {empty} "):
            fn(tp, *targs)


@pytest.mark.parametrize("irreps", IRREPS)
def test_host_packing_matches_jax(irreps):
    """The CG matrices and packed neighbour features the CUDA kernels read
    are the JAX kernels' own."""
    tp, jtp = _tps(irreps)
    x = _inputs(tp, 3, 4, h_dim=4)[0]
    specs2, cg_full, xp2, out2 = f2.build_specs2(tp)
    jspecs2, jcg_full, jxp2, jout2 = j_gen2.build_specs2(jtp)
    np.testing.assert_array_equal(cg_full, jcg_full)
    assert (xp2, out2) == (jxp2, jout2)
    assert [(s.fan, s.d3, s.mul_out, [tuple(vars(p).values()) for p in s.paths]) for s in specs2] == \
        [(s.fan, s.d3, s.mul_out, [tuple(vars(p).values()) for p in s.paths]) for s in jspecs2]
    specs1, cg_all, xp1, _ = f1.build_specs(tp)
    jspecs1, jcg_all, jxp1, _ = j_gen1.build_specs(jtp)
    np.testing.assert_array_equal(cg_all, jcg_all)
    assert xp1 == jxp1
    assert [[tuple(vars(p).values()) for p in s.paths] for s in specs1] == \
        [[tuple(vars(p).values()) for p in s.paths] for s in jspecs1]
    packed = f2.pack_neighbors(tp, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(
        packed, np.asarray(j_gen2.pack_neighbors2(jspecs2, j_gen2._input_slices(jtp), jnp.asarray(x))))
    np.testing.assert_array_equal(packed, np.asarray(j_gen1.pack_neighbors(jtp, jspecs1, jnp.asarray(x))))


def test_kernel_tables_address_the_packed_operands():
    """The class and path tables handed to the CUDA kernels, walked the
    way the kernels walk them (numpy, one receiver at a time), rebuild the
    plain version's result from the packed operands."""
    tp, _ = _tps(LADDER_L)
    args = [torch.from_numpy(a) for a in _inputs(tp, 3, 5, h_dim=12, seed=4)]
    ref = f2.factored_tp_reference(tp, *args).numpy()
    xp, sh, h_aug, Ha, cg, w, cls2, paths2 = [a.numpy() if torch.is_tensor(a) else a
                                             for a in f2.prepare(tp, *args)]
    xp1, sh1, h1, mw1, cg1, t1, b1, cls1, paths1 = [a.numpy() if torch.is_tensor(a) else a
                                                   for a in f1.prepare(tp, *args)]
    He = h_aug.shape[2]
    for gen in (2, 1):
        out = np.zeros_like(ref)
        cls = cls2 if gen == 2 else cls1
        for r in range(ref.shape[0]):
            for row in cls:
                fan, d3, mul, o_off, col0, ncols, p0, n_paths = (int(v) for v in row[:8])
                paths = (paths2 if gen == 2 else paths1)[p0 : p0 + n_paths]
                if gen == 2:
                    wcg = sh[r] @ cg[:, col0 : col0 + ncols]
                    hid = h_aug[r, :, :Ha]
                    T = w[row[8] : row[8] + He * fan * mul].reshape(He, fan, mul)[:Ha]
                else:
                    wcg = np.zeros((sh1.shape[1], ncols), np.float32)
                    for p in paths:
                        cols = slice(p[4], p[4] + p[2] * d3)
                        wcg[:, cols] = sh1[r, :, p[5] : p[5] + p[6]] @ cg1[: p[6], col0 + cols.start : col0 + cols.stop]
                    hid = np.concatenate([h1[r], mw1[r][:, None]], axis=-1)
                    T = np.concatenate([t1[row[8] : row[8] + h1.shape[-1] * fan * mul].reshape(-1, fan, mul),
                                        b1[row[9] : row[9] + fan * mul].reshape(1, fan, mul)])
                C = np.zeros((wcg.shape[0], fan, d3), np.float32)
                for p in paths:
                    u_off, pm, d1, xs, pc = (int(v) for v in p[:5])
                    for i in range(d1):
                        x_i = (xp if gen == 2 else xp1)[r, :, xs + i * pm : xs + (i + 1) * pm]
                        C[:, u_off : u_off + pm] += x_i[:, :, None] * wcg[:, None, pc + i * d3 : pc + (i + 1) * d3]
                P = np.einsum("kh,kud->hud", hid, C)
                out[r, o_off : o_off + mul * d3] = (
                    np.einsum("hud,huw->wd", P, T).reshape(-1) / np.sqrt(fan))
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5, err_msg=f"gen {gen}")
