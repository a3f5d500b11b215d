"""The plain reference against the port's plain path (``reference_kernels
=True``) at tiny widths on the CPU, on the same weights and draws."""

import numpy as np
import pytest
import torch

from benchmark.harness import inputs, port
from benchmark.harness.noise import Draws
from benchmark.harness.weights import init_specs, make_state_dict
from benchmark.reference import dock as rd
from benchmark.reference.diffusion.schedules import SigmaConfig as RefSigma
from benchmark.reference.inference.sampler import InitNoise, SamplerConfig as RefSampler, StepNoise
from benchmark.reference.models.config import ScoreModelConfig as RefConfig
from benchmark.tests.tiny import TINY_TRAFFIC, tiny_config


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["diffdock_l", "diffdock_v1"])
def test_reference_dock_matches_the_ports_plain_path(name):
    from diffdock_tpu_torch.inference.pipeline import DockingPipeline
    from diffdock_tpu_torch.inference.sampler import InitNoise as PI, StepNoise as PS

    cfg = tiny_config(name)
    ref_s = rd.build(port.model_config(cfg["score_model"], RefConfig, RefSigma))
    ref_c = rd.build(port.model_config(cfg["confidence_model"], RefConfig, RefSigma))
    ssd = make_state_dict(init_specs(ref_s), 11, "cpu")
    csd = make_state_dict(init_specs(ref_c), 12, "cpu")
    pipe = DockingPipeline(port.model_config(cfg["score_model"]), ssd, port.sampler_config(cfg["sampler"]),
                           device="cpu", reference_kernels=True,
                           confidence_cfg=port.model_config(cfg["confidence_model"]), confidence_weights=csd)
    ref_s.load_state_dict(ssd)
    ref_c.load_state_dict(csd)
    ref = rd.ReferenceDocker(ref_s, ref_c, port.sampler_config(cfg["sampler"], RefSampler), "cpu")
    fields, aa_fields = inputs.make_cycle(5, dict(TINY_TRAFFIC), cfg)[0]
    data, aa = port.PortDocker.complex(fields, aa_fields)
    rdata, raa = rd.as_reference_data(fields, aa_fields)
    nb = ref.bucket(rdata)[2]
    d = Draws.make(3, nb, ref.sampler_cfg.num_steps, 99, "cpu")

    def noise(P, n_bonds, _seed, fold=None):
        assert (P, n_bonds) == (3, nb)
        return PI(d.tor0, d.rot0, d.tr0, d.res0), PS(d.tr, d.rot, d.tor)

    got = pipe.dock_complex(data, num_poses=3, noise=noise, aa_data=aa)
    want = ref.dock(rdata, raa, 3, InitNoise(d.tor0, d.rot0, d.tr0, d.res0), StepNoise(d.tr, d.rot, d.tor))
    np.testing.assert_allclose(got.poses, want.poses, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.confidence, want.confidence, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got.order, want.order)
    # the judge of another dock's ranking reads the same confidences
    np.testing.assert_allclose(ref.confidence_of(rdata, raa, got.poses), got.confidence, rtol=1e-5, atol=1e-6)
