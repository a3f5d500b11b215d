"""The port's run directories vs the JAX package's on the CPU.

``diffdock_tpu_torch.train.checkpoints`` reads and writes run directories
without flax, msgpack or PyYAML. Held here against the JAX package's
``save_checkpoint``/``load_checkpoint`` (flax, msgpack, PyYAML): the same
config, parameters equal bit for bit, in both directions; the port's
weight bytes equal ``flax.serialization.to_bytes``; the port's YAML reader
gives ``yaml.safe_load``'s dict. Parameters come from the JAX models'
``init`` (a small score model and an old all-atom confidence model).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import serialization

from diffdock_tpu.data import complexes as j_complexes
from diffdock_tpu.models.config import PRESETS as J_PRESETS
from diffdock_tpu.models.config import ScoreModelConfig as JScoreModelConfig
from diffdock_tpu.train import checkpoints as jckpt
from diffdock_tpu_torch.data.complexes import atom_bucket, bucket_sizes
from diffdock_tpu_torch.models.config import PRESETS, ScoreModelConfig
from diffdock_tpu_torch.models.old_models import build_confidence_model
from diffdock_tpu_torch.models.score_model import CGScoreModel
from diffdock_tpu_torch.train import checkpoints as ckpt
from diffdock_tpu_torch.utils import flax_msgpack, simple_yaml
from diffdock_tpu_torch.utils.convert import flax_from_model, state_dict_from_flax
from tests.test_torch_port_confidence import _conf_kw, _init_confidence, tables  # noqa: F401
from tests.test_torch_port_model import _init_params


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trees(tables):
    """(config kwargs, flax variables) of a small score model and an old
    all-atom confidence model, from the JAX models' ``init``."""
    js, jt, _, _ = tables
    jaa = j_complexes.synthetic_aa_complex(np.random.RandomState(0), n_lig=10, n_rec=16, n_bonds=2,
                                           atoms_per_res=3)
    nl, nr, nb = bucket_sizes(jaa.base.n_lig, jaa.base.n_rec, jaa.base.n_bonds)
    jpad = jax.tree.map(jnp.asarray, j_complexes.pad_aa_to(jaa, nl, nr, nb, atom_bucket(jaa.n_atoms)))
    skw = dict(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=1)
    _, score = _init_params(JScoreModelConfig(**skw), jpad.base, js, jt, seed=3)
    ckw = _conf_kw(True, 0, 2)
    _, conf = _init_confidence(JScoreModelConfig(**ckw), jpad, js, jt, 4)
    as_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return [(skw, as_np(score)), (ckw, as_np(conf))]


def _equal_trees(a, b):
    assert isinstance(a, dict) == isinstance(b, dict)
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _equal_trees(a[k], b[k])
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("which", [0, 1])
def test_port_reads_jax_run_dirs(tmp_path, trees, which):
    kw, variables = trees[which]
    jcfg = JScoreModelConfig(**kw)
    jckpt.save_checkpoint(str(tmp_path), variables, jcfg, extra={"epoch": 7, "note": "x y"})
    params, cfg, extra = ckpt.load_checkpoint(str(tmp_path))
    assert cfg == ScoreModelConfig(**kw) and dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert extra == {"epoch": 7, "note": "x y"}
    _equal_trees(params, variables)
    # the loaded tree builds the port's model, strictly
    model = CGScoreModel(cfg) if which == 0 else build_confidence_model(cfg)
    model.load_state_dict(state_dict_from_flax(params, cfg), strict=True)


@pytest.mark.parametrize("which", [0, 1])
def test_jax_reads_port_run_dirs(tmp_path, trees, which):
    kw, variables = trees[which]
    cfg = ScoreModelConfig(**kw)
    ckpt.save_checkpoint(str(tmp_path), variables, cfg, extra={"epoch": 7, "lr": 1e-5, "tags": ["a"]})
    params, jcfg, extra = jckpt.load_checkpoint(str(tmp_path))
    assert jcfg == JScoreModelConfig(**kw) and extra == {"epoch": 7, "lr": 1e-5, "tags": ["a"]}
    _equal_trees(params, variables)
    # the weight bytes are flax's own
    with open(tmp_path / ckpt.WEIGHTS_FILE, "rb") as f:
        assert f.read() == serialization.to_bytes(variables)
    with open(tmp_path / ckpt.CONFIG_FILE) as f:
        text = f.read()
    assert text == yaml.safe_dump({"model": dataclasses.asdict(JScoreModelConfig(**kw)), "epoch": 7,
                                   "lr": 1e-5, "tags": ["a"]}, sort_keys=True)


@pytest.mark.parametrize("which", [0, 1])
def test_port_model_round_trips_through_a_run_dir(tmp_path, trees, which):
    """A port model's weights -> flax tree -> run dir -> flax tree ->
    state_dict, bit for bit; the flax tree is the JAX model's own layout."""
    kw, variables = trees[which]
    cfg = ScoreModelConfig(**kw)
    model = CGScoreModel(cfg) if which == 0 else build_confidence_model(cfg)
    model.load_state_dict(state_dict_from_flax(variables, cfg), strict=True)
    tree = flax_from_model(model)
    _equal_trees(tree, variables)
    ckpt.save_checkpoint(str(tmp_path), tree, cfg)
    params, cfg2, _ = ckpt.load_checkpoint(str(tmp_path))
    assert cfg2 == cfg
    sd, ref = state_dict_from_flax(params, cfg2), model.state_dict()
    assert set(sd) == set(ref) and all(torch.equal(sd[k], ref[k]) for k in ref)


def test_msgpack_bytes_equal_flax_to_bytes():
    rng = np.random.RandomState(0)
    tree = {
        "params": {f"layer_{i}": {"kernel": rng.randn(i + 1, 3).astype(np.float32),
                                  "bias": rng.randn(3).astype(np.float32)} for i in range(20)},
        "batch_stats": {"bn": {"mean": np.zeros(0, np.float32), "var": np.ones((2, 70000), np.float32)}},
        "misc": {"step": np.int32(5), "flags": np.array([True, False]), "ids": np.arange(300),
                 "half": np.ones(3, np.float16), "wide": np.ones((1, 1, 1), np.float64)},
    }
    data = serialization.to_bytes(tree)
    assert flax_msgpack.to_bytes(tree) == data
    _equal_trees(flax_msgpack.msgpack_restore(data), serialization.msgpack_restore(data))
    back = flax_msgpack.msgpack_restore(data)
    assert back["misc"]["step"] == 5 and isinstance(back["misc"]["step"], np.int32)


def test_msgpack_scalars_match_the_msgpack_package():
    import msgpack

    for v in (0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32, -33, -128, -129, -2 ** 15 - 1,
              -2 ** 31 - 1, 1.5, -0.0, "x" * 40, "é" * 200, b"\x00" * 300, None, True, False,
              [1, [2, (3,)]], {"a": [], "b": {"c": "d"}}, list(range(20)), {str(i): i for i in range(20)}):
        assert flax_msgpack.packb(v) == msgpack.packb(v, use_bin_type=True), v
        assert flax_msgpack.unpackb(msgpack.packb(v, use_bin_type=True)) == msgpack.unpackb(
            msgpack.packb(v, use_bin_type=True)), v
    with pytest.raises(ValueError):
        flax_msgpack.unpackb(b"\xc1")
    with pytest.raises(ValueError):
        flax_msgpack.unpackb(msgpack.packb([1, 2])[:-1])


def test_yaml_reader_gives_safe_load_dicts_for_every_preset():
    for name, jcfg in J_PRESETS.items():
        for cfg in (jcfg, dataclasses.replace(jcfg, **_conf_kw(True, 1280, 5)),
                    dataclasses.replace(jcfg, crop_beyond=20.0, bn_axis_names=("batch",))):
            meta = {"model": dataclasses.asdict(cfg), "epoch": 3, "lr": 1e-3, "name": "run 1",
                    "empty": "", "flag": "yes", "none": None, "nested": [[1, 2], {"a": [1.5e-05]}]}
            text = yaml.safe_dump(meta, sort_keys=True)
            assert simple_yaml.load(text) == yaml.safe_load(text), name
            assert yaml.safe_load(simple_yaml.dump(meta)) == yaml.safe_load(text), name
        assert ckpt._cfg_from_dict(yaml.safe_load(yaml.safe_dump(dataclasses.asdict(jcfg)))) == PRESETS[name]


def test_yaml_reader_refuses_what_it_does_not_support():
    text = "a: 1\nb: &anchor 2\n"
    with pytest.raises(simple_yaml.YAMLError, match="line 2"):
        simple_yaml.load(text)
    # forms safe_dump never writes, among them those safe_load reads as
    # another type than a plain string
    for bad in ("a: |\n  text\n", "a: 2001-12-14\n", "a:\n\tb: 1\n", "a: 1:20\n", "a: b\n  c\n",
                "a: 'open\n", "a: !!str x\n", "- a\nb: 1\n", "a: [1, 2]\n", "a: {b: 1}\n", "a: 0x1f\n",
                "a: 010\n", "a: Yes\n", "a: off\n", "a: 1_000\n", "a: .5\n", "a: \"w\"\n", "---\na: 1\n"):
        with pytest.raises(simple_yaml.YAMLError):
            simple_yaml.load(bad)
    ok = "# comment\na: 'q ''x'' # not a comment'  # trailing\nb: {}\nc: []\nf: 1e-05\ng: ~\n" \
         "h:\n  - - 1\n    - 2\n  - k: v\n    z: 3\ni: true\nj: -.inf\nk: 1.0e-05\nl: -12\nm: run 1\n" \
         "n:\n- 1.5\n- null\n"
    assert simple_yaml.load(ok) == yaml.safe_load(ok)


def test_resolve_weights_name_and_preference(tmp_path):
    d = str(tmp_path)
    for f in ("best_ema_model.msgpack", "best_model.msgpack", "last_model.msgpack"):
        open(os.path.join(d, f), "w").close()
    assert ckpt.resolve_weights_name(d, "best_ema_inference_epoch_model.pt") == "best_ema_model.msgpack"
    assert ckpt.resolve_weights_name(d, "best_model_epoch75.pt") == "best_model.msgpack"
    assert ckpt.resolve_weights_name(d, "last_model.pt") == "last_model.msgpack"
    open(os.path.join(d, "custom.pt"), "w").close()
    assert ckpt.resolve_weights_name(d, "custom.pt") == "custom.pt"
    for name in ("best_ema_inference_epoch_model.pt", "best_model_epoch75.pt", "last_model.pt",
                 "custom.pt", "absent.msgpack"):
        assert ckpt.resolve_weights_name(d, name) == jckpt.resolve_weights_name(d, name)
    # with no weights name, model.msgpack first, then the EMA flavors
    tree = {"params": {"w": np.ones(2, np.float32)}}
    ckpt.save_checkpoint(d, tree, ScoreModelConfig(), weights_name="best_ema_model.msgpack")
    assert ckpt.load_checkpoint(d)[0]["params"]["w"].tolist() == [1.0, 1.0]
    ckpt.save_checkpoint(d, {"params": {"w": np.zeros(2, np.float32)}}, ScoreModelConfig())
    assert ckpt.load_checkpoint(d)[0]["params"]["w"].tolist() == [0.0, 0.0]
    assert ckpt.load_checkpoint(d, "best_ema_inference_epoch_model.pt")[0]["params"]["w"].tolist() == [1, 1]
    with pytest.raises(FileNotFoundError):
        ckpt.load_checkpoint(d, "absent.msgpack")
