"""Diffusion tables, schedules and geometry of the PyTorch port vs the JAX package.

The SO(3) and torus tables are built by the same numpy code in both
packages, so they must be bit-identical; the lookups and the geometry run
in float32 on both sides (1e-5 relative, 1e-5 Angstrom-scale absolute).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdock_tpu.diffusion import schedules as j_sched
from diffdock_tpu.diffusion import so3 as j_so3
from diffdock_tpu.diffusion import time_embed as j_te
from diffdock_tpu.diffusion import torus as j_torus
from diffdock_tpu.geometry import kabsch as j_kabsch
from diffdock_tpu.geometry import rigid as j_rigid
from diffdock_tpu.geometry import rotations as j_rot
from diffdock_tpu.geometry import torsion as j_torsion
from diffdock_tpu_torch.diffusion import so3, torus
from diffdock_tpu_torch.diffusion.schedules import SigmaConfig, get_t_schedule, t_to_sigma
from diffdock_tpu_torch.diffusion.time_embed import get_timestep_embedding
from diffdock_tpu_torch.geometry.kabsch import kabsch_align
from diffdock_tpu_torch.geometry.rigid import modify_conformer
from diffdock_tpu_torch.geometry.rotations import axis_angle_to_matrix, random_rotation_matrix
from diffdock_tpu_torch.geometry.torsion import apply_torsion_updates

SO3_SMALL = dict(n_eps=64, x_n=256, l_max=512)
TORUS_SMALL = dict(x_n=256, sigma_n=128, mc_samples=2000)
T = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(a, b, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("cfg", [SO3_SMALL, dict(n_eps=40, x_n=128, l_max=300, min_eps=0.01)])
def test_so3_tables_are_bit_identical(cfg):
    ours = so3._generate_tables(so3.SO3Config(**cfg))
    ref = j_so3._generate_tables(j_so3.SO3Config(**cfg))
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cfg", [TORUS_SMALL, dict(x_n=100, sigma_n=60, mc_samples=500, mc_seed=3)])
def test_torus_tables_are_bit_identical(cfg):
    ours = torus._generate_tables(torus.TorusConfig(**cfg))
    ref = j_torus._generate_tables(j_torus.TorusConfig(**cfg))
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


def test_table_lookups_match_jax():
    ours_so3 = so3.get_so3_tables(so3.SO3Config(**SO3_SMALL), "cpu")
    ref_so3 = j_so3.get_so3_tables(j_so3.SO3Config(**SO3_SMALL))
    np.testing.assert_array_equal(ours_so3.exp_score_norms.numpy(), np.asarray(ref_so3.exp_score_norms))
    eps = np.geomspace(0.05, 1.6, 37).astype(np.float32)
    np.testing.assert_array_equal(ours_so3.score_norm(T(eps)).numpy(),
                                  np.asarray(ref_so3.score_norm(jnp.asarray(eps))))

    ours_t = torus.get_torus_tables(torus.TorusConfig(**TORUS_SMALL), "cpu")
    ref_t = j_torus.get_torus_tables(j_torus.TorusConfig(**TORUS_SMALL))
    sig = np.geomspace(0.04, 3.0, 41).astype(np.float32)
    np.testing.assert_array_equal(ours_t.score_norm(T(sig)).numpy(),
                                  np.asarray(ref_t.score_norm(jnp.asarray(sig))))


def test_schedule_sigmas_and_time_embedding():
    np.testing.assert_array_equal(get_t_schedule("expbeta", 20), j_sched.get_t_schedule("expbeta", 20))
    cfg, jcfg = SigmaConfig(tr_sigma_max=19.0), j_sched.SigmaConfig(tr_sigma_max=19.0)
    t = np.linspace(0.05, 1.0, 9).astype(np.float32)
    for a, b in zip(t_to_sigma(T(t), T(t), T(t), cfg), j_sched.t_to_sigma(jnp.asarray(t), jnp.asarray(t),
                                                                          jnp.asarray(t), jcfg)):
        close(a, b, rtol=1e-6, atol=0)
    emb, jemb = get_timestep_embedding("sinusoidal", 32, 1000.0), j_te.get_timestep_embedding(
        "sinusoidal", 32, 1000.0)
    close(emb(T(t)), jemb(jnp.asarray(t)), rtol=1e-5, atol=2e-5)


def test_rotations_match_jax():
    rng = np.random.RandomState(1)
    aa = rng.randn(8, 3).astype(np.float32)
    aa[0] = 1e-8  # small-angle branch
    close(axis_angle_to_matrix(T(aa)), j_rot.axis_angle_to_matrix(jnp.asarray(aa)), atol=1e-6)
    q = rng.randn(5, 4).astype(np.float32)
    close(random_rotation_matrix(T(q)),
          j_rot.quaternion_to_matrix(jnp.asarray(q / np.linalg.norm(q, axis=-1, keepdims=True))),
          atol=1e-6)


def test_kabsch_align_matches_jax():
    rng = np.random.RandomState(2)
    a = rng.randn(3, 9, 3).astype(np.float32) * 3
    b = a @ j_rot.axis_angle_to_matrix(jnp.asarray([0.3, -0.2, 0.9])).__array__().T + 1.5
    b = (b + 0.1 * rng.randn(*b.shape)).astype(np.float32)
    mask = np.ones((3, 9), bool)
    mask[:, -2:] = False
    ours = kabsch_align(T(a), T(b), torch.from_numpy(mask))
    ref = jax.vmap(j_kabsch.kabsch_align)(jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask))
    close(ours, ref, atol=2e-5)


def _chain(n_atoms, n_bonds, seed):
    """A random ligand chain with rotatable-bond data, like synthetic_complex."""
    rng = np.random.RandomState(seed)
    pos = np.cumsum(rng.randn(n_atoms, 3).astype(np.float32) * 0.8, axis=0)
    bonds = [(i, i + 1) for i in range(n_atoms - 1)]
    em, mr = j_torsion.rotatable_bond_mask(n_atoms, bonds)
    directed = [e for ij in bonds for e in (ij, ij[::-1])]
    rot = [directed[i] for i in np.flatnonzero(em)][:n_bonds]
    u = np.array([e[0] for e in rot], np.int32)
    v = np.array([e[1] for e in rot], np.int32)
    return pos, u, v, mr[:n_bonds], rng


def test_apply_torsion_updates_keeps_the_sequential_order():
    pos, u, v, mr, rng = _chain(11, 5, seed=3)
    ang = rng.uniform(-np.pi, np.pi, (4, len(u))).astype(np.float32)
    bond_mask = np.array([True, True, False, True, True])
    ours = apply_torsion_updates(T(pos).expand(4, 11, 3), torch.from_numpy(u).long(),
                                 torch.from_numpy(v).long(), torch.from_numpy(mr), T(ang),
                                 torch.from_numpy(bond_mask))
    ref = jax.vmap(lambda q: j_torsion.apply_torsion_updates(
        jnp.asarray(pos), jnp.asarray(u), jnp.asarray(v), jnp.asarray(mr), q, jnp.asarray(bond_mask)))(
        jnp.asarray(ang))
    close(ours, ref, atol=2e-5)


def test_modify_conformer_matches_jax():
    pos, u, v, mr, rng = _chain(12, 4, seed=4)
    pos = np.concatenate([pos, np.zeros((4, 3), np.float32)])  # padded atoms
    mr = np.pad(mr, ((0, 0), (0, 4)))
    amask = np.arange(16) < 12
    P = 3
    poses = (pos[None] + 0.3 * rng.randn(P, 16, 3)).astype(np.float32)
    tr, rot = (rng.randn(P, 3).astype(np.float32) for _ in range(2))
    tor = rng.uniform(-2, 2, (P, len(u))).astype(np.float32)
    bmask = np.ones(len(u), bool)
    ours = modify_conformer(T(poses), T(tr), T(rot), T(tor), torch.from_numpy(u).long(),
                            torch.from_numpy(v).long(), torch.from_numpy(mr), torch.from_numpy(bmask),
                            torch.from_numpy(amask))
    ref = jax.vmap(lambda p, a, b, q: j_rigid.modify_conformer(
        p, a, b, q, jnp.asarray(u), jnp.asarray(v), jnp.asarray(mr), jnp.asarray(bmask),
        atom_mask=jnp.asarray(amask)))(jnp.asarray(poses), jnp.asarray(tr), jnp.asarray(rot),
                                       jnp.asarray(tor))
    close(ours, ref, atol=5e-5)
    rigid = modify_conformer(T(poses), T(tr), T(rot), atom_mask=torch.from_numpy(amask))
    rref = jax.vmap(lambda p, a, b: j_rigid.modify_conformer(p, a, b, atom_mask=jnp.asarray(amask)))(
        jnp.asarray(poses), jnp.asarray(tr), jnp.asarray(rot))
    close(rigid, rref, atol=2e-5)
