"""The port's ESM2 encoder and embedders against the JAX package's on the CPU.

The tiny configuration of ``tests/test_esm2_jax.py`` (64 wide, 2 layers, 4
heads, FFN 96) with random float32 params drawn in numpy: the port's
``ESM2`` holding the JAX params dict (carried across by
``params_to_state_dict``) against JAX's ``esm2_forward``, with padding and
``<mask>`` tokens, every row (padded rows too) within 1e-5 of the output's
scale (max(max|JAX|, 1)): the two float32 softmaxes differ by ~1e-7 of
scale, and the whole gap measured 1.5e-6 at scale 3.3. Then the npz layout
both ways, the HuggingFace converter against a tiny random ``EsmModel``
(skipped without ``transformers``), the embedders on e2e_synth receptors
(one split into two chains) against ``JaxESM2Embedder`` and the JAX
``ESM2Embedder``, and ``make_embedder``.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdock_tpu.data import chem as jchem
from diffdock_tpu.data import esm as jesm
from diffdock_tpu.models import esm2 as J
from diffdock_tpu_torch.data import chem, esm
from diffdock_tpu_torch.models import esm2 as T

HID, LAYERS, HEADS, INTER = 64, 2, 4, 96
RTOL = 1e-5  # share of max(max|JAX|, 1), float32
SYNTH = Path(__file__).resolve().parent.parent / "data" / "e2e_synth"


def two_chain_pdb(src: Path, dst: Path, split: int = 50) -> Path:
    """``src`` with chain B from residue ``split + 1`` on: a receptor of two
    chains in file order."""
    lines = []
    for line in src.read_text().splitlines():
        if line.startswith(("ATOM", "HETATM")) and int(line[22:26]) > split:
            line = line[:21] + "B" + line[22:]
        lines.append(line)
    dst.write_text("\n".join(lines) + "\n")
    return dst


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_params(seed: int, hid: int = HID, layers: int = LAYERS, inter: int = INTER) -> dict:
    """A JAX-layout params dict with float32 draws from numpy: matrices
    scaled by 1/sqrt(fan-in), biases 0.1, LayerNorms 1 + 0.1 N(0, 1)."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    p = {"embed": 0.5 * f(33, hid), "final_ln_w": 1 + 0.1 * f(hid), "final_ln_b": 0.1 * f(hid), "layers": []}
    shapes = dict(q=(hid, hid), k=(hid, hid), v=(hid, hid), attn_out=(hid, hid), fc1=(hid, inter),
                  fc2=(inter, hid))
    for _ in range(layers):
        layer = {}
        for n, (a, b) in shapes.items():
            layer[f"{n}_w"] = f(a, b) / np.float32(np.sqrt(a))
            layer[f"{n}_b"] = 0.1 * f(b)
        for n in ("ln1", "ln2"):
            layer[f"{n}_w"] = 1 + 0.1 * f(hid)
            layer[f"{n}_b"] = 0.1 * f(hid)
        p["layers"].append(layer)
    return p


def _cfgs(heads=HEADS):
    return (J.ESM2Config(hidden_size=HID, num_layers=LAYERS, num_heads=heads, intermediate_size=INTER),
            T.ESM2Config(hidden_size=HID, num_layers=LAYERS, num_heads=heads, intermediate_size=INTER))


def _tokens(case: str):
    rng = np.random.RandomState(1)
    tokens = rng.randint(3, 30, (2, 21)).astype(np.int32)
    tokens[:, 0] = T.CLS_ID
    tokens[:, -1] = T.EOS_ID
    mask = np.ones_like(tokens)
    if case == "padding and mask tokens":
        tokens[0, 5] = tokens[1, 7] = tokens[1, 8] = T.MASK_ID
        tokens[0, 15:] = T.PAD_ID
        mask[0, 15:] = 0
        tokens[0, 14] = T.EOS_ID
    return tokens, mask


def _assert_close(out, ref):
    scale = max(float(np.abs(ref).max()), 1.0)
    assert np.isfinite(out).all()
    assert float(np.abs(out - ref).max()) <= RTOL * scale, (float(np.abs(out - ref).max()), scale)


@pytest.mark.parametrize("case", ["full batch", "padding and mask tokens"])
def test_forward_matches_esm2_forward(case):
    jcfg, tcfg = _cfgs()
    params = random_params(0)
    tokens, mask = _tokens(case)
    ref = np.asarray(J.esm2_forward(jax.tree.map(jnp.asarray, params), jcfg, tokens, mask))
    model = T.ESM2.from_params(params, tcfg, device="cpu")
    with torch.no_grad():
        out = model(torch.as_tensor(tokens), torch.as_tensor(mask)).numpy()
    assert out.shape == (2, 21, HID) and out.dtype == np.float32
    _assert_close(out, ref)


def test_token_dropout_scales_a_plain_embed_and_counts_unpadded_tokens():
    """With no layers the output is the final LayerNorm of the scaled
    embeddings: 0.88 for a sequence without <mask>; (1 - 0.12) / (1 -
    1/15) for one <mask> among 15 unpadded tokens of 21."""
    _, tcfg = _cfgs()
    cfg0 = T.ESM2Config(hidden_size=HID, num_layers=0, num_heads=HEADS, intermediate_size=INTER)
    params = dict(random_params(0), layers=[])
    model = T.ESM2.from_params(params, cfg0, device="cpu")
    model.final_ln = torch.nn.Identity()
    tokens, mask = _tokens("padding and mask tokens")
    tokens[1, 7:9] = 4  # row 1 without <mask>
    with torch.no_grad():
        out = model(torch.as_tensor(tokens), torch.as_tensor(mask)).numpy()
    emb = params["embed"][tokens]
    np.testing.assert_allclose(out[1], emb[1] * np.float32(0.88), rtol=1e-6)
    want0 = emb[0] * np.float32(0.88 / (1 - 1 / 15)) * mask[0, :, None]
    want0[5] = 0.0
    np.testing.assert_allclose(out[0], want0, rtol=1e-6, atol=1e-7)
    jcfg0 = J.ESM2Config(hidden_size=HID, num_layers=0, num_heads=HEADS, intermediate_size=INTER)
    ref = np.asarray(J.esm2_forward(jax.tree.map(jnp.asarray, params), jcfg0, tokens, mask))
    with torch.no_grad():
        model.final_ln = T.ESM2.from_params(params, cfg0, device="cpu").final_ln
        _assert_close(model(torch.as_tensor(tokens), torch.as_tensor(mask)).numpy(), ref)


def test_rotary_tables_are_the_jax_packages():
    cos, sin = T._rotary_cos_sin(37, 16, "cpu")
    jcos, jsin = J._rotary_cos_sin(37, 16, jnp.float32)
    np.testing.assert_array_equal(cos.numpy(), np.asarray(jcos))
    np.testing.assert_array_equal(sin.numpy(), np.asarray(jsin))


def test_params_carry_across_to_the_state_dict_and_back():
    params = random_params(2)
    _, tcfg = _cfgs()
    model = T.ESM2.from_params(params, tcfg, device="cpu")
    assert model.layers[0].q.weight.shape == (HID, HID) and model.layers[1].fc1.weight.shape == (INTER, HID)
    np.testing.assert_array_equal(model.layers[1].fc1.weight.detach().numpy(), params["layers"][1]["fc1_w"].T)
    back = T.module_params(model)
    assert back.keys() == params.keys() and len(back["layers"]) == LAYERS
    for k in ("embed", "final_ln_w", "final_ln_b"):
        np.testing.assert_array_equal(back[k], params[k])
    for a, b in zip(back["layers"], params["layers"]):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_reset_parameters_is_seeded():
    _, tcfg = _cfgs()
    a, b = T.ESM2(tcfg), T.ESM2(tcfg)
    a.reset_parameters(torch.Generator().manual_seed(5))
    b.reset_parameters(torch.Generator().manual_seed(5))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    ln = a.layers[0].ln1.weight.detach()
    assert abs(float(ln.mean()) - 1.0) < 0.02 and abs(float(a.layers[0].q.weight.detach().std()) - 0.02) < 0.005


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("num_heads", [HEADS, None])
def test_npz_written_by_either_package_loads_in_the_other(tmp_path, writer, num_heads):
    """Same arrays, same config (without ``meta/num_heads``: hidden // 64
    heads in both) and the same outputs."""
    params = random_params(3)
    path = str(tmp_path / "esm2.npz")
    (J.save_params if writer == "jax" else T.save_params)(params, path, num_heads=num_heads)
    jp, jcfg = J.load_params(path)
    tp, tcfg = T.load_params(path)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.num_heads == (num_heads or HID // 64) and tcfg.intermediate_size == INTER
    assert tcfg.num_layers == LAYERS and tcfg.vocab_size == 33
    for k in ("embed", "final_ln_w", "final_ln_b"):
        np.testing.assert_array_equal(tp[k], params[k])
        np.testing.assert_array_equal(jp[k], params[k])
    for a, b in zip(tp["layers"], params["layers"]):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    tokens, mask = _tokens("padding and mask tokens")
    ref = np.asarray(J.esm2_forward(jax.tree.map(jnp.asarray, jp), jcfg, tokens, mask))
    with torch.no_grad():
        out = T.ESM2.from_params(tp, tcfg, "cpu")(torch.as_tensor(tokens), torch.as_tensor(mask)).numpy()
    _assert_close(out, ref)


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """A tiny random HF ``EsmModel`` (ESM2 layout) and its tokenizer saved
    to a local directory."""
    transformers = pytest.importorskip("transformers")
    cfg = transformers.EsmConfig(
        vocab_size=33, hidden_size=HID, num_hidden_layers=LAYERS, num_attention_heads=HEADS,
        intermediate_size=INTER, max_position_embeddings=256, position_embedding_type="rotary",
        token_dropout=True, emb_layer_norm_before=False, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, pad_token_id=1, mask_token_id=32, layer_norm_eps=1e-5,
    )
    torch.manual_seed(0)
    model = transformers.EsmModel(cfg, add_pooling_layer=False).eval()
    d = tmp_path_factory.mktemp("hf_esm2")
    model.save_pretrained(d)
    (d / "vocab.txt").write_text("\n".join(T.ESM2_TOKENS) + "\n")
    transformers.EsmTokenizer(str(d / "vocab.txt")).save_pretrained(d)
    return d, model


def test_convert_hf_state_dict_matches_the_hf_model(hf_dir):
    d, hf = hf_dir
    sd = hf.state_dict()
    params = T.convert_hf_state_dict(sd, LAYERS)
    jparams = J.convert_hf_state_dict(sd, LAYERS)
    assert params.keys() == jparams.keys()
    for k in ("embed", "final_ln_w", "final_ln_b"):
        np.testing.assert_array_equal(params[k], jparams[k])
    for a, b in zip(params["layers"], jparams["layers"]):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    # an EsmForMaskedLM-style "esm." prefix reads the same
    pre = T.convert_hf_state_dict({"esm." + k: v for k, v in sd.items()}, LAYERS)
    np.testing.assert_array_equal(pre["layers"][1]["fc2_w"], params["layers"][1]["fc2_w"])
    tokens, mask = _tokens("full batch")
    with torch.no_grad():
        ref = hf(input_ids=torch.as_tensor(tokens, dtype=torch.int64),
                 attention_mask=torch.as_tensor(mask, dtype=torch.int64)).last_hidden_state.numpy()
        out = T.ESM2.from_params(params, _cfgs()[1], "cpu")(torch.as_tensor(tokens),
                                                            torch.as_tensor(mask)).numpy()
    # the bound of tests/test_esm2_jax.py for its HF comparison
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)


def _protein_pair(name, tmp_path):
    """The port's and JAX's parse of e2e_synth receptor ``name`` split into
    two chains (see ``two_chain_pdb``)."""
    path = two_chain_pdb(SYNTH / name / f"{name}_protein_processed.pdb", tmp_path / f"{name}_ab.pdb")
    return chem.read_pdb_file(str(path)), jchem.read_pdb_file(str(path))


def test_embedder_matches_the_jax_embedder_on_a_receptor(tmp_path):
    params = random_params(4)
    jcfg, tcfg = _cfgs()
    prot, jprot = _protein_pair("syn001_l24r104", tmp_path)
    assert [c for c, _ in esm.chain_sequences(prot)] == ["A", "B"]
    emb = T.TorchESM2Embedder.from_params(params, tcfg, device="cpu")
    out = emb.embed_protein(prot)
    ref = J.JaxESM2Embedder(params, jcfg).embed_protein(jprot)
    assert out.shape == ref.shape == (104, HID) and out.dtype == np.float32
    _assert_close(out, ref)
    # chains embedded apart, concatenated in file order; 128-token buckets
    a, b = [emb.embed(s) for _, s in esm.chain_sequences(prot)]
    np.testing.assert_array_equal(out, np.concatenate([a, b]))
    assert emb.quantum == 128


def test_hf_weight_embedder_matches_the_jax_one(hf_dir, tmp_path):
    """``data/esm.py:ESM2Embedder``: the JAX package runs HF's EsmModel on
    the CPU, the port its own encoder on the converted weights."""
    d, _ = hf_dir
    prot, jprot = _protein_pair("syn006_l29r122", tmp_path)
    out = esm.ESM2Embedder(str(d), device="cpu").embed_protein(prot)
    ref = jesm.ESM2Embedder(str(d)).embed_protein(jprot)
    assert out.shape == ref.shape == (122, HID)
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)
    # an empty protein gives no rows of the model's width (the JAX embedder
    # gives 1280 columns whatever the width: the same for ESM2-650M)
    empty = chem.ProteinStructure([])
    assert esm.ESM2Embedder(str(d), device="cpu").embed_protein(empty).shape == (0, HID)
    assert jesm.ESM2Embedder(str(d)).embed_protein(empty).shape == (0, esm.ESM_DIM)


def test_hf_weight_embedder_refuses_missing_weights(tmp_path):
    pytest.importorskip("transformers")
    with pytest.raises(RuntimeError, match="not in local HF cache"):
        esm.ESM2Embedder(str(tmp_path / "absent"), device="cpu")


def test_make_embedder_reads_the_npz(tmp_path, monkeypatch):
    params = random_params(5)
    path = str(tmp_path / "esm2.npz")
    J.save_params(params, path, num_heads=HEADS)
    monkeypatch.setenv("DIFFDOCK_TPU_ESM2_NPZ", path)
    emb = esm.make_embedder(device="cpu")
    assert isinstance(emb, T.TorchESM2Embedder) and emb.cfg.num_heads == HEADS
    assert emb.device == torch.device("cpu")
    prot, jprot = _protein_pair("syn001_l24r104", tmp_path)
    _assert_close(emb.embed_protein(prot), jesm.make_embedder().embed_protein(jprot))
    live = esm.compute_esm_embeddings_if_available(prot, device="cpu")
    np.testing.assert_array_equal(live, emb.embed_protein(prot))


def test_without_weights_there_is_no_embedder(tmp_path, monkeypatch):
    monkeypatch.setenv("DIFFDOCK_TPU_ESM2_NPZ", str(tmp_path / "absent.npz"))
    prot = chem.read_pdb_file(str(SYNTH / "syn001_l24r104" / "syn001_l24r104_protein_processed.pdb"))
    with pytest.raises(RuntimeError):
        esm.make_embedder(device="cpu")
    assert esm.compute_esm_embeddings_if_available(prot, device="cpu") is None
