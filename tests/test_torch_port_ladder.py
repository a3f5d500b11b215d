"""The port's cover ladder and the pipeline's ladder modes, anomaly guard,
``dock_batch`` and the evaluate CLI's retry, on the CPU.

The ladder's entries, ``cover_bucket``, ``pdbbind_like_sizes`` and the
bucket rungs (with the dense ones) must equal the JAX package's;
``fine_plan`` must give the JAX plan's buckets, with the pose count the
port's pipeline runs (the H100 cap, ``auto_pose_chunk``) in place of the
TPU's. The behaviour tests mirror ``tests/test_anomaly_guard.py``,
``tests/test_ladder.py`` and the retry tests of
``tests/test_evaluate_cli.py`` on the port's pipeline, with small models.
"""

import warnings

import numpy as np
import pytest
import torch

from diffdock_tpu.data import complexes as j_complexes
from diffdock_tpu.inference import ladder as jladder
from diffdock_tpu_torch.cli import evaluate
from diffdock_tpu_torch.data.complexes import bucket_sizes, synthetic_complex
from diffdock_tpu_torch.diffusion.so3 import SO3Config, get_so3_tables
from diffdock_tpu_torch.diffusion.torus import TorusConfig, get_torus_tables
from diffdock_tpu_torch.inference import ladder
from diffdock_tpu_torch.inference import pipeline as pipeline_mod
from diffdock_tpu_torch.inference.pipeline import DockingPipeline, auto_pose_chunk, resolve_anomaly_guard
from diffdock_tpu_torch.inference.sampler import SamplerConfig
from diffdock_tpu_torch.models.config import ConfigError, ScoreModelConfig
from diffdock_tpu_torch.parallel import mesh as mesh_mod
from tests.test_torch_port_confidence import SO3_SMALL, TORUS_SMALL

# a two-entry ladder: entry 0 covers the test complex, entry 1 is the
# fallback once entry 0 is quarantined (as in tests/test_anomaly_guard.py)
TINY_LADDER = ((8, 16, 4, 2), (16, 32, 4, 2))
CFG = dict(ns=8, nv=2, num_conv_layers=1, num_prot_emb_layers=0)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tables():
    return get_so3_tables(SO3Config(**SO3_SMALL), "cpu"), get_torus_tables(TorusConfig(**TORUS_SMALL), "cpu")


@pytest.fixture(scope="module")
def data():
    return synthetic_complex(np.random.RandomState(0), n_lig=6, n_rec=10, n_bonds=2)


def _pipeline(tables, guard=None, ladder_mode="cover", **kw):
    so3, torus = tables
    return DockingPipeline(ScoreModelConfig(**CFG), 0, SamplerConfig(inference_steps=2, actual_steps=2), so3, torus,
                           device="cpu", bucket_ladder=ladder_mode, anomaly_guard=guard, **kw)


def test_cover_ladder_and_cover_bucket_equal_jax():
    assert ladder.COVER_LADDER == jladder.COVER_LADDER
    rng = np.random.RandomState(0)
    excludes = [None, set(), {ladder.COVER_LADDER[0]}, set(ladder.COVER_LADDER)]
    excludes += [{e for e in ladder.COVER_LADDER if rng.rand() < 0.4} for _ in range(4)]
    for nl in range(1, 101, 3):
        for nr in range(20, 2400, 37):
            for nb in (0, 1, 7, 16, 17, 33):
                for ex in excludes:
                    assert ladder.cover_bucket(nl, nr, nb, exclude=ex) == \
                        jladder.cover_bucket(nl, nr, nb, exclude=ex), (nl, nr, nb, ex)


def test_pdbbind_like_sizes_equal_jax():
    for n, seed in ((150, 7), (40, 0), (1, 3)):
        assert ladder.pdbbind_like_sizes(n, seed) == jladder.pdbbind_like_sizes(n, seed)
    assert ladder.pdbbind_like_sizes() == jladder.pdbbind_like_sizes()


@pytest.mark.parametrize("dense", [False, True])
def test_bucket_sizes_equal_jax(dense):
    for nl in list(range(1, 300, 3)) + [1000]:
        for nr in list(range(1, 3300, 41)) + [5000]:
            for nb in (0, 1, 9, 130):
                assert bucket_sizes(nl, nr, nb, dense=dense) == \
                    j_complexes.bucket_sizes(nl, nr, nb, dense=dense), (nl, nr, nb)


@pytest.mark.parametrize("dense", [False, True])
def test_fine_plan_equals_jax_but_for_the_cards_pose_count(dense):
    plan = ladder.fine_plan(dense=dense)
    ref = jladder.fine_plan(dense=dense)
    assert {k[:3]: v for k, v in plan.items()} == {k[:3]: v for k, v in ref.items()}
    for nl, nr, nb, p in plan:
        assert p == min(40, auto_pose_chunk(nl, nr))
    assert sum(len(v) for v in plan.values()) == 150
    sizes = [(20, 100), (50, 2900)]
    assert {k[:3] for k in ladder.fine_plan(sizes, num_poses=8)} == {k[:3] for k in jladder.fine_plan(sizes)}
    assert all(k[3] <= 8 for k in ladder.fine_plan(sizes, num_poses=8))


def test_cost_model_is_the_cards():
    assert ladder.modeled_batch_seconds(32, 320, 40) == \
        ladder.COST_CHUNK_S + 40 * (ladder.COST_PER_AREA_S * 32 * 320 + ladder.COST_BASE_S)
    assert ladder.COST_CHUNK_S > 0 and ladder.COST_BASE_S > 0 and ladder.COST_PER_AREA_S > 0
    assert (ladder.COST_PER_AREA_S, ladder.COST_BASE_S) != (jladder.COST_PER_AREA_S, jladder.COST_BASE_S)
    assert not hasattr(ladder, "HBM_AREA_BOUND") and not hasattr(ladder, "fine_hbm_poses")


def test_first_fit_is_the_fastest_fit_under_the_cards_cost_model():
    """The entries keep the JAX package's order; under the H100 cost model
    too, the first entry that fits a complex is one of the fastest that fit
    it (40 poses per complex, each entry's pose count capped by the card)."""
    def complex_s(nl, nr, p):
        p = min(p, auto_pose_chunk(nl, nr))
        return -(-40 // p) * ladder.modeled_batch_seconds(nl, nr, p)

    times = [complex_s(nl, nr, p) for nl, nr, _, p in ladder.COVER_LADDER]
    assert times == sorted(times)
    for nl_c in range(8, 97, 8):
        for nr_c in range(90, 2305, 101):
            cov = ladder.cover_bucket(nl_c, nr_c, 1)
            if cov is None:
                continue
            fits = [complex_s(nl, nr, p) for nl, nr, nb, p in ladder.COVER_LADDER if nl_c <= nl and nr_c <= nr]
            assert complex_s(cov[0], cov[1], cov[3]) == min(fits)


def test_guard_default_resolution(monkeypatch, tables):
    monkeypatch.delenv("DIFFDOCK_TPU_ANOMALY_FACTOR", raising=False)
    assert resolve_anomaly_guard(None, "cover", "cuda") == 5.0
    assert resolve_anomaly_guard(None, "cover", torch.device("cuda", 0)) == 5.0
    assert resolve_anomaly_guard(None, "cover", "cpu") == 0.0
    assert resolve_anomaly_guard(None, "fine", "cuda") == 0.0
    assert resolve_anomaly_guard(2.5, "fine", "cpu") == 2.5
    assert _pipeline(tables).anomaly_guard == 0.0
    monkeypatch.setenv("DIFFDOCK_TPU_ANOMALY_FACTOR", "7")
    assert resolve_anomaly_guard(None, "fine", "cpu") == 7.0
    assert resolve_anomaly_guard(0.0, "cover", "cuda") == 0.0
    assert _pipeline(tables).anomaly_guard == 7.0


def test_guard_quarantines_and_reroutes(monkeypatch, tables, data):
    monkeypatch.setattr(ladder, "COVER_LADDER", TINY_LADDER)
    pipe = _pipeline(tables, guard=1e-9)  # any real chunk after an entry's first trips it
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        pipe.dock_complex(data, num_poses=2, seed=0)  # entry 0's first chunk: not judged
        assert not pipe._quarantined and not w
        res = pipe.dock_complex(data, num_poses=2, seed=0)
    # the tripping chunk's poses are kept (slow, not wrong)
    assert res.poses.shape == (2, data.n_lig, 3) and np.isfinite(res.poses).all()
    assert TINY_LADDER[0] in pipe._quarantined
    assert any("quarantined" in str(x.message) for x in w)
    # the next dock goes to entry 1
    assert pipe.dock_bucket(data) == (TINY_LADDER[1][:3], TINY_LADDER[1])
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        res2 = pipe.dock_complex(data, num_poses=2, seed=1)
        assert TINY_LADDER[1] not in pipe._quarantined
        pipe.dock_complex(data, num_poses=2, seed=1)
    assert res2.poses.shape == (2, data.n_lig, 3)
    assert TINY_LADDER[1] in pipe._quarantined
    # both quarantined: the fine ladder, unguarded
    assert pipe.dock_bucket(data) == (bucket_sizes(data.n_lig, data.n_rec, data.n_bonds), None)
    clock = _Clock(1.0)
    monkeypatch.setattr(pipeline_mod, "time", clock)
    res3 = pipe.dock_complex(data, num_poses=2, seed=2)
    assert res3.poses.shape == (2, data.n_lig, 3) and clock.t == 0.0


class _Clock:
    """A stand-in for the pipeline's ``time`` whose perf_counter advances by
    ``step`` seconds per call."""

    def __init__(self, step):
        self.t, self.step = 0.0, step

    def perf_counter(self):
        self.t += self.step
        return self.t


def test_guard_judges_the_chunk_time_against_the_cost_model(monkeypatch, tables, data):
    """With the default factor 5.0 and a monkeypatched clock: an entry's
    first chunk runs untimed; a later chunk that takes 4x its modeled time
    passes, one that takes 6x quarantines its entry (the warning names the
    ratio); with the guard off nothing is timed."""
    monkeypatch.setattr(ladder, "COVER_LADDER", TINY_LADDER)
    model_s = ladder.modeled_batch_seconds(8, 16, 2)
    for factor, tripped in ((4.0, False), (6.0, True)):
        pipe = _pipeline(tables, guard=5.0)
        clock = _Clock(factor * model_s)
        monkeypatch.setattr(pipeline_mod, "time", clock)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            pipe.dock_complex(data, num_poses=2, seed=0)
            assert clock.t == 0.0 and not pipe._quarantined
            pipe.dock_complex(data, num_poses=2, seed=0)
        assert clock.t == pytest.approx(2 * factor * model_s)  # two readings: one chunk timed
        assert (TINY_LADDER[0] in pipe._quarantined) == tripped
        assert [str(x.message).split(" its cost model")[0].split(", ")[-1] for x in w] == (["6x"] if tripped else [])
    off = _pipeline(tables, guard=0.0)
    clock = _Clock(1.0)
    monkeypatch.setattr(pipeline_mod, "time", clock)
    off.dock_complex(data, num_poses=2, seed=0)
    off.dock_complex(data, num_poses=2, seed=0)
    assert clock.t == 0.0 and not off._quarantined


class _ChunkClock:
    """A stand-in for the pipeline's ``time`` whose perf_counter advances by
    the next of ``chunk_s`` at each chunk's first reading."""

    def __init__(self, chunk_s):
        self.t, self.chunk_s, self.readings = 0.0, list(chunk_s), 0

    def perf_counter(self):
        if self.readings % 2 == 1:
            self.t += self.chunk_s.pop(0)
        self.readings += 1
        return self.t


def test_guard_spares_one_pose_chunks_and_each_entrys_first_chunk(monkeypatch, tables, data):
    """The eager dock is bound by the host's launches, so a one-pose chunk
    takes about as long as a full one: under the default factor a one-pose
    chunk that takes what the cost model gives the entry's ten-pose chunk
    is not quarantined. The first chunk of an entry, which pays the
    kernels' build, runs untimed, however long it takes; the entry a
    chunk falls back to after a quarantine starts untimed too."""
    monkeypatch.setattr(ladder, "COVER_LADDER", ((8, 16, 4, 10), (16, 32, 4, 10)))
    pipe = _pipeline(tables, guard=5.0)
    host_bound = ladder.modeled_batch_seconds(8, 16, 10)
    clock = _ChunkClock([host_bound] * 3 + [6 * ladder.modeled_batch_seconds(8, 16, 1)])
    monkeypatch.setattr(pipeline_mod, "time", clock)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        pipe.dock_complex(data, num_poses=3, seed=0, batch_size=1)  # 3 chunks of 1: the first untimed
        assert clock.readings == 4 and not pipe._quarantined and not w
        pipe.dock_complex(data, num_poses=1, seed=1)
        assert clock.readings == 6 and not pipe._quarantined
        pipe.dock_complex(data, num_poses=1, seed=2)  # 6x: quarantined
    assert pipe._quarantined == {ladder.COVER_LADDER[0]} and len(w) == 1
    pipe.dock_complex(data, num_poses=1, seed=3)  # entry 1's first chunk
    assert clock.readings == 8 and pipe._quarantined == {ladder.COVER_LADDER[0]}


def test_cover_chunks_and_the_cards_cap(monkeypatch, tables, data):
    """In a cover entry the default chunk is the entry's pose count, capped
    at auto_pose_chunk of its bucket; an explicit batch size is capped
    there; each chunk draws from seed * 100003 + c; an oversize complex
    falls back to the fine ladder."""
    monkeypatch.setattr(ladder, "COVER_LADDER", ((8, 16, 4, 3), (16, 32, 4, 2)))
    pipe = _pipeline(tables, guard=0.0)
    assert pipe.dock_bucket(data) == ((8, 16, 4), (8, 16, 4, 3))
    assert pipe.effective_pose_chunk(data, 7) == 3
    assert pipe.effective_pose_chunk(data, 7, batch_size=2) == 2
    assert pipe.effective_pose_chunk(data, 7, batch_size=5) == 3
    assert pipe.effective_pose_chunk(data, 2) == 2
    per_pose = pipeline_mod.score_bytes_per_pose(8, 16)
    monkeypatch.setattr(pipeline_mod, "SCORE_BUDGET_BYTES", 2.5 * per_pose)
    assert pipe.effective_pose_chunk(data, 7) == 2
    monkeypatch.undo()
    monkeypatch.setattr(ladder, "COVER_LADDER", ((8, 16, 4, 3),))
    calls = []

    def noise(num_poses, n_bonds, seed):
        calls.append((num_poses, n_bonds, seed))
        return pipe.draw_noise(num_poses, n_bonds, seed)

    res = pipe.dock_complex(data, num_poses=7, seed=5, noise=noise)
    assert calls == [(3, 4, 5 * 100003 + c) for c in range(3)]
    parts = [pipe.dock_complex(data, num_poses=3, seed=5 * 100003 + c) for c in range(3)]
    np.testing.assert_array_equal(res.poses, np.concatenate([r.poses for r in parts])[:7])
    big = synthetic_complex(np.random.RandomState(1), n_lig=12, n_rec=10, n_bonds=2)
    assert pipe.dock_bucket(big) == (bucket_sizes(12, 10, 2), None)
    assert pipe.effective_pose_chunk(big, 7) == 7


def test_fine_dense_docks_in_the_dense_bucket(tables):
    d = synthetic_complex(np.random.RandomState(2), n_lig=18, n_rec=200, n_bonds=2)
    dense = _pipeline(tables, ladder_mode="fine_dense")
    assert dense.dock_bucket(d) == ((20, 256, 8), None)
    assert _pipeline(tables, ladder_mode="fine").dock_bucket(d) == ((24, 320, 8), None)
    calls = []

    def noise(num_poses, n_bonds, seed):
        calls.append(n_bonds)
        return dense.draw_noise(num_poses, n_bonds, seed)

    res = dense.dock_complex(d, num_poses=2, seed=0, noise=noise)
    assert calls == [8] and res.poses.shape == (2, 18, 3) and np.isfinite(res.poses).all()
    with pytest.raises(ValueError, match="bucket_ladder"):
        _pipeline(tables, ladder_mode="coarse")


def test_dock_batch_equals_the_dock_complex_loop(tables, data):
    pipe = _pipeline(tables, ladder_mode="fine")
    other = synthetic_complex(np.random.RandomState(3), n_lig=9, n_rec=14, n_bonds=3)
    pocket = np.asarray(other.rec_pos)[2]
    res = pipe.dock_batch([data, other], num_poses=3, seed=4, pocket_centers=[None, pocket], batch_size=2)
    ref = [pipe.dock_complex(data, num_poses=3, seed=4, batch_size=2),
           pipe.dock_complex(other, num_poses=3, seed=5, pocket_center=pocket, batch_size=2)]
    for a, b in zip(res, ref):
        np.testing.assert_array_equal(a.poses, b.poses)
        np.testing.assert_array_equal(a.order, b.order)
    with pytest.raises(ValueError, match="pocket centers"):
        pipe.dock_batch([data], pocket_centers=[None, None])


def test_a_mesh_or_several_devices_raise(tables, tmp_path, monkeypatch):
    """The mesh is ported (ROADMAP queue 1 item 8; the multi-rank docks are
    in test_torch_port_parallel_dock.py): the pipeline takes one, and what
    the JAX CLI refuses is still refused: both sharding flags at once. A
    count that a ``torchrun`` group of another size cannot give is refused
    too."""
    pipe = _pipeline(tables, mesh=mesh_mod.Mesh(1, 0, "cpu", "gloo"))
    assert pipe.mesh_size == 1
    base = ["--data_dir", str(tmp_path), "--device", "cpu"]
    with pytest.raises(SystemExit, match="mutually exclusive"):
        evaluate.main(base + ["--pose_devices", "2", "--complex_devices", "2"])
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "2"), ("MASTER_ADDR", "localhost"), ("MASTER_PORT", "1")):
        monkeypatch.setenv(k, v)
    with pytest.raises(ConfigError, match="3 in a process group of 2"):
        evaluate.main(base + ["--complex_devices", "3"])
    with pytest.raises(ConfigError, match="1 in a process group of 2"):
        evaluate.main(base)


class _Result:
    def __init__(self, n, seed):
        self.poses = np.full((n, 3, 3), float(seed))
        self.confidence = np.arange(n, dtype=float) + seed
        self.order = np.argsort(-self.confidence)


def test_dock_with_retry_halves_pose_chunks():
    """A pipeline that fails above 2 poses in flight still returns every
    pose (tests/test_evaluate_cli.py's twin)."""
    calls = []

    class Fails:
        def effective_pose_chunk(self, data, num_poses, batch_size=None):
            return min(num_poses, batch_size or num_poses)

        def dock_complex(self, data, num_poses, seed, batch_size=None, **kw):
            in_flight = min(num_poses, batch_size or num_poses)
            calls.append(in_flight)
            if in_flight > 2:
                raise RuntimeError("CUDA out of memory")
            return _Result(num_poses, seed)

    result = evaluate.dock_with_retry(Fails(), None, 8, seed=0, max_retries=4)
    assert calls == [8, 4, 2] and result.poses.shape == (8, 3, 3)
    assert (np.diff(result.confidence[result.order]) <= 0).all()

    class AlwaysFails(Fails):
        def dock_complex(self, data, num_poses, seed, **kw):
            raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        evaluate.dock_with_retry(AlwaysFails(), None, 4, seed=0, max_retries=3)


def test_dock_with_retry_on_the_pipeline(monkeypatch, tables, data):
    """The real pipeline with an injected failure above 2 poses in flight:
    the retry halves from the cover entry's chunk (not from the request)
    and the result is the pipeline's own dock in chunks of 2."""
    monkeypatch.setattr(ladder, "COVER_LADDER", ((8, 16, 4, 4),))
    pipe = _pipeline(tables, guard=0.0)
    real = pipe._dock_program
    seen = []

    def flaky(data, bucket, num_poses, *a, **kw):
        seen.append(num_poses)
        if num_poses > 2:
            raise RuntimeError("CUDA out of memory")
        return real(data, bucket, num_poses, *a, **kw)

    monkeypatch.setattr(pipe, "_dock_program", flaky)
    res = evaluate.dock_with_retry(pipe, data, 6, seed=1, max_retries=3)
    assert seen == [4, 2, 2, 2]
    monkeypatch.setattr(pipe, "_dock_program", real)
    ref = pipe.dock_complex(data, num_poses=6, seed=1, batch_size=2)
    np.testing.assert_array_equal(res.poses, ref.poses)
