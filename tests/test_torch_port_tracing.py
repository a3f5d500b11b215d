"""The dock's record of spans and counts (``utils/profiling.py``) and the
program's profiler ranges, on the CPU.

Tiny docks (a DiffDock-L-shaped score model at ns 8, or the v1.0 one,
ranked by the v1.0 all-atom confidence model) of a synthetic complex, with
small diffusion tables: the record's span tree, parents and host times;
its counts against ``dock_bucket``; a chunked dock's pose batches; the
dock ids; the anomaly guard's quarantine; poses and confidences bit for
bit with and without a profiler; the ranges in a profiler's trace, nested
as the record nests them; no range opened without a profiler; the
per-step callback against forward hooks on the score model; which
spans take device events; and ``chip_smoke.follow_steps``, which holds a
plain dock to another dock step by step from that dock's own state.
"""

import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from diffdock_tpu_torch.data.chem import read_molecule_file, read_pdb_file
from diffdock_tpu_torch.data.complexes import synthetic_aa_complex
from diffdock_tpu_torch.diffusion.so3 import SO3Config, get_so3_tables
from diffdock_tpu_torch.diffusion.torus import TorusConfig, get_torus_tables
from diffdock_tpu_torch.inference.pipeline import DockingPipeline
from diffdock_tpu_torch.inference.sampler import SamplerConfig
from diffdock_tpu_torch.models.config import ScoreModelConfig
from diffdock_tpu_torch.utils import profiling

import chip_smoke

STEPS = 3
SAMPLER = SamplerConfig(inference_steps=4, actual_steps=STEPS)
SCORE = {"new": ScoreModelConfig(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=1),
         "v1": ScoreModelConfig(ns=8, nv=2, num_conv_layers=3, old_architecture=True)}
CONFIDENCE = ScoreModelConfig(ns=8, nv=2, num_conv_layers=2, confidence_mode=True,
                              old_architecture=True, all_atoms=True)
DOCK_CHILDREN = {"prep", "embed_receptor", "diffusion", "to_host", "confidence", "rank"}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tables():
    return (get_so3_tables(SO3Config(n_eps=64, x_n=256, l_max=512), "cpu"),
            get_torus_tables(TorusConfig(x_n=256, sigma_n=128, mc_samples=2000), "cpu"))


@pytest.fixture(scope="module")
def complex_():
    aa = synthetic_aa_complex(np.random.RandomState(0), n_lig=9, n_rec=20, n_bonds=2, atoms_per_res=3)
    return aa.base, aa


def pipeline(tables, score="new", **kw):
    so3, torus = tables
    return DockingPipeline(SCORE[score], 0, SAMPLER, so3, torus, device="cpu",
                           confidence_cfg=CONFIDENCE, confidence_weights=1, **kw)


def names(rec, idxs):
    return [rec.spans[i].name for i in idxs]


def children(rec, i):
    return [j for j, s in enumerate(rec.spans) if s.parent == i]


def test_the_span_tree_is_complete_and_nested(tables, complex_):
    data, aa = complex_
    rec = pipeline(tables).dock_complex(data, num_poses=3, seed=1, aa_data=aa).timings
    (dock,) = rec.find("dock")
    assert rec.spans[dock].parent == -1
    assert set(names(rec, children(rec, dock))) == DOCK_CHILDREN
    (diffusion,) = rec.find("diffusion")
    steps = rec.find("step")
    assert len(steps) == STEPS and children(rec, diffusion) == steps
    for i in steps:
        assert names(rec, children(rec, i)) == ["score", "update"]
    assert len(rec.find("confidence")) == len(rec.find("rank")) == 1
    (conf,) = rec.find("confidence")
    assert set(names(rec, children(rec, conf))) == {"confidence_chunk"}
    # each pre-crop call is a child of a prep span: the dock's, its bucket's
    # (twice) and the confidence input's
    crops = rec.find("pre_crop")
    assert len(crops) == 4 and all(rec.spans[rec.spans[i].parent].name == "prep" for i in crops)
    for i, s in enumerate(rec.spans):
        assert 0 <= s.start_ns <= s.end_ns
        assert s.start_event is None and s.end_event is None
        if s.parent >= 0:
            p = rec.spans[s.parent]
            assert s.parent < i and p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    # siblings follow one another on the host clock
    for parent in (dock, diffusion):
        kids = children(rec, parent)
        assert all(rec.spans[a].end_ns <= rec.spans[b].start_ns for a, b in zip(kids, kids[1:]))
    assert rec.device_ms(dock) is None and rec.lead_ms(dock) is None
    assert rec.host_seconds("step") == pytest.approx(sum(rec.host_ms(i) for i in steps) / 1e3)


def test_the_counts_match_the_bucket(tables, complex_):
    data, aa = complex_
    pipe = pipeline(tables)
    rec = pipe.dock_complex(data, num_poses=3, seed=1, aa_data=aa).timings
    (nl, nr, _), _ = pipe.dock_bucket(data)
    assert rec.counts == {"pose_batches": 1, "pair_real": 3 * data.n_lig * data.n_rec,
                          "pair_slots": 3 * nl * nr, "score_forwards": STEPS, "confidence_chunks": 1}


def test_a_chunked_dock_has_a_pose_batch_per_chunk(tables, complex_):
    data, aa = complex_
    pipe = pipeline(tables, confidence_chunk=1)
    res = pipe.dock_complex(data, num_poses=5, seed=1, aa_data=aa, batch_size=2)
    rec = res.timings
    (dock,) = rec.find("dock")
    batches = rec.find("pose_batch")
    assert len(batches) == 3 and all(rec.spans[i].parent == dock for i in batches)
    assert names(rec, children(rec, dock)) == ["prep", "pose_batch", "pose_batch", "pose_batch", "rank"]
    for b in batches:
        assert set(names(rec, children(rec, b))) == DOCK_CHILDREN
    (nl, nr, _), _ = pipe.dock_bucket(data)
    c = rec.counts
    assert c["pose_batches"] == 3 and c["score_forwards"] == STEPS * c["pose_batches"]
    # every chunk runs 2 poses, the last one's surplus pose dropped afterwards
    assert c["pair_real"] == 6 * data.n_lig * data.n_rec and c["pair_slots"] == 6 * nl * nr
    assert c["confidence_chunks"] == 6 and len(rec.find("confidence_chunk")) == 6
    assert res.poses.shape[0] == 5


def test_dock_ids_are_unique_and_increase_and_a_file_dock_adds_its_spans(tables, tmp_path):
    synth = Path(__file__).resolve().parent.parent / "data/e2e_synth/syn001_l24r104/syn001_l24r104"
    mol, protein = read_molecule_file(f"{synth}_ligand.sdf"), read_pdb_file(f"{synth}_protein_processed.pdb")
    pipe = pipeline(tables)
    results = [pipe.dock_mol_protein(mol, protein, str(tmp_path / str(i)), num_poses=2, seed=i)
               for i in range(3)]
    assert [r.timings.dock_id for r in results] == [0, 1, 2]
    rec = results[-1].timings
    top = [s.name for s in rec.spans if s.parent == -1]
    assert top == ["featurize", "dock", "write"]
    assert rec.host_seconds("featurize") > 0 and rec.host_seconds("write") > 0
    # a pickled record keeps its host times
    back = pickle.loads(pickle.dumps(results[-1])).timings
    assert [(s.name, s.parent, s.start_ns, s.end_ns) for s in back.spans] == \
        [(s.name, s.parent, s.start_ns, s.end_ns) for s in rec.spans]
    assert back.counts == rec.counts and back.dock_id == 2
    assert profiling._records == {}  # no record is left open


def test_the_anomaly_guards_quarantine_is_counted_in_the_dock_that_tripped_it(tables, complex_):
    data, aa = complex_
    pipe = pipeline(tables, bucket_ladder="cover", anomaly_guard=1e-9)
    first = pipe.dock_complex(data, num_poses=2, seed=1, aa_data=aa).timings
    with pytest.warns(RuntimeWarning, match="quarantined"):
        second = pipe.dock_complex(data, num_poses=2, seed=2, aa_data=aa).timings
    assert "quarantines" not in first.counts and second.counts["quarantines"] == 1


def _profiled_events(prof):
    """(name, start, end) of the profiler's host events, by start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()),
                  key=lambda e: (e[1], -e[2]))


@pytest.mark.parametrize("score", ["new", "v1"])
def test_the_profiler_trace_holds_the_programs_ranges_nested_as_the_record(tables, complex_, score):
    data, aa = complex_
    plain = pipeline(tables, score).dock_complex(data, num_poses=3, seed=1, aa_data=aa)
    pipe = pipeline(tables, score)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        traced = pipe.dock_complex(data, num_poses=3, seed=1, aa_data=aa)
    # the ranges change nothing the dock computes
    assert np.array_equal(plain.poses, traced.poses)
    assert np.array_equal(plain.confidence, traced.confidence)
    assert np.array_equal(plain.order, traced.order)
    events = _profiled_events(prof)
    found = {n for n, *_ in events}
    assert not any(n.startswith("bench.") for n in found)
    model_ranges = {"embed", "conv0", "conv1", "lig<-lig", "lig<-rec", "rec<-rec", "rec<-lig",
                    "heads", "center", "torsion", "tp_contract", "lig<-atom", "atom<-atom"}
    if score == "new":
        model_ranges.add("step_cache")
    assert model_ranges <= found, model_ranges - found
    # the k-th range of a name is the record's k-th span of it, and sits
    # inside the range of its parent span
    rec = traced.timings
    by_name = {}
    for n, a, b in events:
        by_name.setdefault(n, []).append((a, b))
    seen = {}
    where = []
    for s in rec.spans:
        k = seen.get(s.name, 0)
        seen[s.name] = k + 1
        where.append(by_name[s.name][k])
    assert {n: len(by_name[n]) for n in seen} == seen
    for s, (a, b) in zip(rec.spans, where):
        if s.parent >= 0:
            pa, pb = where[s.parent]
            assert pa <= a and b <= pb, s.name


def test_without_a_profiler_no_range_is_opened(tables, complex_, monkeypatch):
    data, aa = complex_
    opened = []
    real = profiling.record_function

    def counting(name, *args):
        opened.append(name)
        return real(name, *args)

    monkeypatch.setattr(profiling, "record_function", counting)
    pipe = pipeline(tables)
    pipe.dock_complex(data, num_poses=2, seed=1, aa_data=aa)
    assert opened == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        pipe.dock_complex(data, num_poses=2, seed=1, aa_data=aa)
    assert opened.count("step") == STEPS and "tp_contract" in opened


def test_the_step_callback_sees_what_forward_hooks_see(tables, complex_):
    data, aa = complex_
    pipe = pipeline(tables)
    hooked, called, pending = [], [], []
    pre = pipe.model.register_forward_pre_hook(lambda _m, args: pending.append(args[1].clone()))
    post = pipe.model.register_forward_hook(
        lambda _m, _a, out: hooked.append((pending.pop(), out.tr.clone(), out.rot.clone(), out.tor.clone())))
    try:
        res = pipe.dock_complex(
            data, num_poses=3, seed=1, aa_data=aa, return_trajectory=True,
            on_step=lambda s, poses, out: called.append(
                (s, poses.clone(), out.tr.clone(), out.rot.clone(), out.tor.clone())))
    finally:
        pre.remove()
        post.remove()
    assert [c[0] for c in called] == list(range(STEPS)) and len(hooked) == STEPS
    for (_, *ours), theirs in zip(called, hooked):
        for a, b in zip(ours, theirs):
            assert torch.equal(a, b)
    # the trajectory is built through the same callback: each step's start
    # poses in the input frame, then the final poses
    center = np.asarray(data.original_center)
    for s, poses, *_ in called:
        np.testing.assert_array_equal(res.trajectory[s], poses[:, : data.n_lig].numpy() + center)
    np.testing.assert_array_equal(res.trajectory[-1], res.poses)
    assert res.trajectory.shape[0] == STEPS + 1


def test_only_device_spans_take_events(monkeypatch, tables, complex_):
    """On a CUDA device the origin and the ``diffusion``, ``confidence``
    and ``rank`` spans hold event pairs; every other span is timed on the
    host alone."""
    made = []

    def event(self):
        made.append(object())
        return made[-1]

    monkeypatch.setattr(profiling.DockTimings, "_event", event)
    real_init = profiling.DockTimings.__init__

    def init(self, dock_id, device=None):
        real_init(self, dock_id, None)
        self._stream = object()  # as on a CUDA device
        self.origin = self._event()

    monkeypatch.setattr(profiling.DockTimings, "__init__", init)
    data, aa = complex_
    rec = pipeline(tables).dock_complex(data, num_poses=2, seed=1, aa_data=aa).timings
    timed = {s.name for s in rec.spans if s.start_event is not None}
    assert timed == {"diffusion", "confidence", "rank"}
    assert all((s.start_event is None) == (s.end_event is None) for s in rec.spans)
    assert len(made) == 1 + 2 * 3 and rec.origin is made[0]


@pytest.mark.parametrize("score", ["new", "v1"])
def test_follow_steps_holds_each_step_from_the_docks_own_state(tables, complex_, score):
    """Between two docks of the same weights every step is held to 0; with
    other weights the first held step is the whole docks' first-step gap (the
    same state), every step parts, and a chunked dock gives one gap a step."""
    data, aa = complex_
    so3, torus = tables
    P, batch = 4, 2
    pipe = pipeline(tables, score)
    drawn = {}

    def noise(num_poses, n_bonds, seed):
        if seed not in drawn:
            drawn[seed] = pipe.draw_noise(num_poses, n_bonds, seed)
        return drawn[seed]

    kw = dict(num_poses=P, seed=0, aa_data=aa, batch_size=batch)
    start, held = chip_smoke.follow_steps(pipe, pipeline(tables, score), data, noise, kw)
    assert start == 0.0 and held == [0.0] * STEPS
    other = DockingPipeline(SCORE[score], 1, SAMPLER, so3, torus, device="cpu",
                            confidence_cfg=CONFIDENCE, confidence_weights=1)
    start, held = chip_smoke.follow_steps(pipe, other, data, noise, kw)
    a = pipe.dock_complex(data, noise=noise, return_trajectory=True, **kw)
    b = other.dock_complex(data, noise=noise, return_trajectory=True, **kw)
    assert start == 0.0 and len(held) == STEPS and min(held) > 0.0
    whole = [float(np.abs(a.trajectory[k] - b.trajectory[k]).max()) for k in range(1, STEPS + 1)]
    assert held[0] == pytest.approx(whole[0], rel=1e-5)
    # later steps start from the dock's state, not from the plain dock's own
    assert all(h != pytest.approx(w, rel=1e-3) for h, w in zip(held[1:], whole[1:]))
