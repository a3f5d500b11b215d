"""The frozen work model: tied to a hand count at one small size, and its
census of a dock's contractions to the port's own launch count."""

import pytest
import torch

from benchmark.harness import inputs, port
from benchmark.harness.weights import init_specs, make_state_dict
from benchmark.reference import dock as rd
from benchmark.reference.data.complexes import atom_bucket
from benchmark.reference.diffusion.schedules import SigmaConfig as RefSigma
from benchmark.reference.inference.sampler import SamplerConfig as RefSampler
from benchmark.reference.models.config import ScoreModelConfig as RefConfig
from benchmark.reference.models.tpconv import NeighborBlock, TPConvLayer
from benchmark.tests.tiny import TINY_TRAFFIC, tiny_config
from benchmark.work import census
from benchmark.work.peaks import HBM_BYTES_PER_S, TF32X3_PEAK_FLOPS
from benchmark.work.tp3 import bound_ms, class_sums, tp3_work


def test_tp3_work_by_hand():
    # 3 rows x 2 neighbours, H = 4 (H+1 = 5 with the bias row), F_tot 6,
    # 10 weights in 4 columns, 7 outputs
    products, coupling, nbytes = tp3_work(6, 10, 4, 7, 3, 2, 4)
    assert products == 2 * 3 * 5 * 2 * 6 + 2 * 3 * 5 * 10
    assert coupling == 0
    assert nbytes == 4 * (3 * 2 * 5 + 3 * 2 * 6 + 5 * 4 + 3 * 7)
    ms, bound = bound_ms(products, coupling, nbytes)
    assert bound == "bytes" and ms == pytest.approx(nbytes / HBM_BYTES_PER_S * 1e3)
    ms, bound = bound_ms(1e12, 0, 1.0)
    assert bound == "operations" and ms == pytest.approx(1e12 / TF32X3_PEAK_FLOPS * 1e3)


def test_census_of_one_conv_layer_by_hand():
    torch.manual_seed(0)
    layer = TPConvLayer("4x0e + 2x1o", "1x0e + 1x1o + 1x2e", "4x0e + 2x1o + 2x1e", 6).eval()
    R, K, S = 5, 3, 7
    blk = NeighborBlock(sender_attr=torch.randn(1, S, layer.tp.irreps_in1.dim),
                        nbr_idx=torch.randint(0, S, (1, R, K)), nbr_mask=torch.ones(1, R, K, dtype=torch.bool),
                        edge_attr=torch.randn(1, R, K, 6), edge_sh=torch.randn(1, R, K, 9))
    attr = torch.randn(1, R, layer.tp.irreps_out.dim)
    calls, flops = census._counted(lambda: layer(attr, [blk]))
    f_tot, weight, w_len = class_sums(layer.tp)
    assert calls == [(f_tot, weight, w_len, layer.tp.irreps_out.dim, R, K, 6)]
    # the edge MLP's one hidden layer (6 -> 6) is the only product outside
    # the contraction
    assert flops == 2 * R * K * 6 * 6
    work = census.Work({calls[0]: 1}, flops)
    assert work.flops() == flops + 2 * R * 7 * K * f_tot + 2 * R * 7 * weight


@pytest.mark.parametrize("name", ["diffdock_l", "diffdock_v1"])
def test_census_counts_the_ports_contractions(name):
    from diffdock_tpu_torch.ops import fused_tp3

    torch.set_num_threads(1)
    cfg = tiny_config(name)
    ref_s = rd.build(port.model_config(cfg["score_model"], RefConfig, RefSigma))
    ref_c = rd.build(port.model_config(cfg["confidence_model"], RefConfig, RefSigma))
    ssd = make_state_dict(init_specs(ref_s), 1, "cpu")
    csd = make_state_dict(init_specs(ref_c), 2, "cpu")
    system = port.PortDocker(cfg, ssd, csd, "cpu")
    fields, aa_fields = inputs.make_cycle(7, dict(TINY_TRAFFIC), cfg)[0]
    data, aa = system.complex(fields, aa_fields)
    fused_tp3.counts.reset()
    system.dock(data, aa, 3, 11)
    launched = fused_tp3.counts.as_dict()["fused_tp3_reference"]  # the plain version runs on the CPU
    ref_s.load_state_dict(ssd)
    ref_c.load_state_dict(csd)
    ref = rd.ReferenceDocker(ref_s, ref_c, port.sampler_config(cfg["sampler"], RefSampler), "cpu")
    rdata, raa = rd.as_reference_data(fields, aa_fields)
    sizes = (*ref.bucket(rdata), atom_bucket(raa.n_atoms))
    score, conf = census.dock_work(ref, rdata, raa, 3, ref.sampler_cfg.num_steps, sizes)
    assert score.launches() + conf.launches() == launched
    real = census.dock_work(ref, rdata, raa, 3, ref.sampler_cfg.num_steps,
                            (rdata.n_lig, rdata.n_rec, rdata.n_bonds, raa.n_atoms))
    # the real sizes need less work than the padded buckets
    assert 0 < real[0].flops() < score.flops() and 0 < real[1].flops() < conf.flops()
    assert score.bound_ms() > 0 and conf.bound_ms() > 0
