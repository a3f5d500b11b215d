"""The rest of a run, driven on the CPU at tiny widths with the card's
look skipped: sound, it comes out correct; with the timed path broken
underneath, not correct. One case for each fault a docking cell can have:
a step that returns its state unchanged, half of the pose batch left out,
an answer altered where it is produced, an answer kept from an earlier
request."""

import argparse
import time

import numpy as np
import pytest
import torch

from benchmark.harness import main, port
from benchmark.tests.tiny import tiny_root


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


def run(root, workload="dl-mix-p10", factory=None, seconds=0.5):
    args = argparse.Namespace(workload=workload, seed=2**31 + 99, seconds=seconds, trace=0)
    return main.run(args, time.perf_counter(), device="cpu", root=root[0], benchmark=root[1],
                    port_factory=factory)


@pytest.mark.parametrize("workload", ["dl-mix-p10", "v1-mix-p10"])
def test_sound_run_is_correct(root, workload):
    r = run(root, workload)
    assert r["correct"] and r["failed"] == 0
    assert list(r)[-2:] == ["checks", "_lines"]
    assert set(r["metrics"]) == {"poses_per_s", "dock_p95_s", "peak_mem_gib", "setup_s"}
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())


def test_a_step_that_returns_its_state_unchanged(root, monkeypatch):
    from diffdock_tpu_torch.inference import sampler

    monkeypatch.setattr(sampler, "modify_conformer", lambda pos, *a, **k: pos)
    r = run(root)
    assert not r["correct"]
    assert r["checks"]["update_gap_A"]["value"] > r["checks"]["update_gap_A"]["limit"]


class HalfBatch(port.PortDocker):
    """Docks half of the poses and hands them back twice."""

    def dock(self, data, aa, num_poses, seed, n_steps=None):
        res = super().dock(data, aa, num_poses // 2 + num_poses % 2, seed, n_steps)
        poses = np.concatenate([res.poses, res.poses])[:num_poses]
        conf = np.concatenate([res.confidence, res.confidence])[:num_poses]
        return res.__class__(poses=poses, confidence=conf, order=np.argsort(-conf))


def test_half_of_the_batch_left_out(root):
    r = run(root, factory=HalfBatch)
    assert not r["correct"]


class AlteredConfidence(port.PortDocker):
    def dock(self, data, aa, num_poses, seed, n_steps=None):
        res = super().dock(data, aa, num_poses, seed, n_steps)
        conf = res.confidence.copy()
        conf[0] += 0.05 * max(1.0, float(np.abs(conf).max()))
        return res.__class__(poses=res.poses, confidence=conf, order=res.order)


class ReversedOrder(port.PortDocker):
    def dock(self, data, aa, num_poses, seed, n_steps=None):
        res = super().dock(data, aa, num_poses, seed, n_steps)
        return res.__class__(poses=res.poses, confidence=res.confidence, order=res.order[::-1].copy())


class MovedPose(port.PortDocker):
    def dock(self, data, aa, num_poses, seed, n_steps=None):
        res = super().dock(data, aa, num_poses, seed, n_steps)
        poses = res.poses.copy()
        poses[1, 0] += 0.5
        return res.__class__(poses=poses, confidence=res.confidence, order=res.order)


@pytest.mark.parametrize("factory,number", [(AlteredConfidence, "conf_gap"), (ReversedOrder, "ranked_gap"),
                                            (MovedPose, "update_gap_A")])
def test_an_answer_altered_where_it_is_produced(root, factory, number):
    r = run(root, factory=factory)
    assert not r["correct"]
    assert r["checks"][number]["value"] > r["checks"][number]["limit"]


class KeptAnswer(port.PortDocker):
    """Answers a complex that comes again with its first answer."""

    def dock(self, data, aa, num_poses, seed, n_steps=None):
        kept = self.__dict__.setdefault("kept", {})
        if n_steps is None and id(data) in kept:
            return kept[id(data)]
        res = super().dock(data, aa, num_poses, seed, n_steps)
        if n_steps is None:
            kept[id(data)] = res
        return res


def test_an_answer_kept_from_an_earlier_request(root):
    r = run(root, factory=KeptAnswer, seconds=4.0)
    # the window came round to the lead complex again, and the check judged it
    assert r["window"]["checked_docks"][-1] >= 3
    assert not r["correct"]
