"""The ESM2 protein language model encoder (port of ``diffdock_tpu/models/esm2.py``).

DiffDock-L and the shipped confidence model read per-residue ESM2-650M
embeddings (1280 wide, the last layer of 33). This module computes them on
the card with the port's own encoder: rotary attention, pre-LN blocks,
ESM-style token-dropout scaling, exact-erf GELU and the final LayerNorm, as
the JAX package's ``esm2_forward`` writes them. The JAX package runs the
encoder outside any Pallas kernel, so the projections are ``nn.Linear`` and
the attention is plain PyTorch (einsum, additive ``-inf`` key bias, float32
softmax); the forward runs with TF32 off whatever the process's setting.

Weights travel as the JAX package's params dict (numpy arrays, linear
weights stored (in, out)): :func:`convert_hf_state_dict` makes one from a
HuggingFace ``EsmModel`` state dict, :func:`save_params` / :func:`load_params`
store it in the JAX package's npz layout (a file written by either package
loads in the other), and :meth:`ESM2.from_params` / :func:`module_params`
carry it to and from the module's ``state_dict``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from diffdock_tpu_torch import DEFAULT_DEVICE

# The ESM alphabet (fair-esm ``Alphabet.from_architecture("ESM-1b")``,
# shared by every ESM2 release; part of the checkpoint contract).
ESM2_TOKENS: List[str] = [
    "<cls>", "<pad>", "<eos>", "<unk>",
    "L", "A", "G", "V", "S", "E", "R", "T", "I", "D", "P", "K", "Q", "N",
    "F", "Y", "M", "H", "W", "C", "X", "B", "U", "Z", "O", ".", "-",
    "<null_1>", "<mask>",
]
TOKEN_TO_ID = {t: i for i, t in enumerate(ESM2_TOKENS)}
CLS_ID, PAD_ID, EOS_ID, UNK_ID = 0, 1, 2, 3
MASK_ID = TOKEN_TO_ID["<mask>"]

# the params dict's linear layers of one block (weights (in, out)) and its
# LayerNorms
_LINEARS = ("q", "k", "v", "attn_out", "fc1", "fc2")
_NORMS = ("ln1", "ln2")


@dataclasses.dataclass(frozen=True)
class ESM2Config:
    vocab_size: int = 33
    hidden_size: int = 1280  # esm2_t33_650M
    num_layers: int = 33
    num_heads: int = 20
    intermediate_size: int = 5120
    layer_norm_eps: float = 1e-5
    token_dropout: bool = True
    mask_token_id: int = MASK_ID
    pad_token_id: int = PAD_ID

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def tokenize(sequence: str) -> np.ndarray:
    """<cls> + residues + <eos> (fair-esm batch_converter layout)."""
    ids = [CLS_ID] + [TOKEN_TO_ID.get(c, UNK_ID) for c in sequence] + [EOS_ID]
    return np.asarray(ids, np.int32)


def _rotary_cos_sin(length: int, dim: int, device):
    """The rotate-half tables ``[freqs, freqs]``, built in numpy float32 as
    the JAX package builds them."""
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    t = np.arange(length, dtype=np.float32)
    freqs = np.outer(t, inv_freq)  # (L, dim/2)
    emb = np.concatenate([freqs, freqs], axis=-1)  # (L, dim)
    return (torch.as_tensor(np.cos(emb), dtype=torch.float32, device=device),
            torch.as_tensor(np.sin(emb), dtype=torch.float32, device=device))


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


@contextlib.contextmanager
def _full_fp32():
    """Float32 products in full float32 for the duration, the caller's TF32
    setting restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


class ESM2Layer(nn.Module):
    """One pre-LN transformer block: rotary self-attention, then the
    exact-erf GELU feed-forward, each added to the residual stream."""

    def __init__(self, cfg: ESM2Config):
        super().__init__()
        h, f = cfg.hidden_size, cfg.intermediate_size
        self.ln1 = nn.LayerNorm(h, eps=cfg.layer_norm_eps)
        self.q = nn.Linear(h, h)
        self.k = nn.Linear(h, h)
        self.v = nn.Linear(h, h)
        self.attn_out = nn.Linear(h, h)
        self.ln2 = nn.LayerNorm(h, eps=cfg.layer_norm_eps)
        self.fc1 = nn.Linear(h, f)
        self.fc2 = nn.Linear(f, h)
        self.num_heads = cfg.num_heads

    def forward(self, x, cos, sin, bias):
        B, L, H = x.shape
        nh = self.num_heads
        hd = H // nh

        def heads(v):  # (B, L, H) -> (B, nh, L, hd)
            return v.reshape(B, L, nh, hd).transpose(1, 2)

        h_ln = self.ln1(x)
        q = heads(self.q(h_ln)) * (hd ** -0.5)  # scaled before the rotary
        k = heads(self.k(h_ln))
        v = heads(self.v(h_ln))
        q = q * cos + _rotate_half(q) * sin
        k = k * cos + _rotate_half(k) * sin
        logits = torch.einsum("bhqd,bhkd->bhqk", q, k) + bias
        w = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        ctx = torch.einsum("bhqk,bhkd->bhqd", w, v)
        x = x + self.attn_out(ctx.transpose(1, 2).reshape(B, L, H))

        ff = self.fc1(self.ln2(x))
        ff = ff * 0.5 * (1.0 + torch.erf(ff / math.sqrt(2.0)))  # exact gelu
        return x + self.fc2(ff)


class ESM2(nn.Module):
    """The ESM2 encoder: ``tokens`` (B, L) int, ``mask`` (B, L) {0, 1} ->
    (B, L, hidden) float32, HF ``EsmModel``'s ``last_hidden_state`` with
    fair-esm's token-dropout scaling over the unpadded tokens."""

    def __init__(self, cfg: ESM2Config):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(ESM2Layer(cfg) for _ in range(cfg.num_layers))
        self.final_ln = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    @classmethod
    def from_params(cls, params: Dict, cfg: ESM2Config, device=DEFAULT_DEVICE) -> "ESM2":
        """The module on ``device`` holding a JAX-layout params dict."""
        model = cls(cfg).to(device)
        model.load_state_dict(params_to_state_dict(params))
        return model.eval()

    def reset_parameters(self, generator: torch.Generator, std: float = 0.02) -> None:
        """Random weights drawn from ``generator`` on the host: every matrix
        and bias N(0, std), every LayerNorm weight 1 + N(0, std) and bias
        N(0, std)."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                draw = torch.randn(p.shape, generator=generator) * std
                if name.endswith("weight") and (name.startswith("final_ln")
                                                or name.split(".")[-2] in _NORMS):
                    draw += 1.0
                p.copy_(draw)

    def forward(self, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        mask_f = mask.to(torch.float32)
        with _full_fp32():
            x = self.embed(tokens.long())  # (B, L, H)
            if cfg.token_dropout:
                is_mask = (tokens == cfg.mask_token_id)[..., None]
                x = torch.where(is_mask, torch.zeros((), dtype=x.dtype, device=x.device), x)
                mask_ratio_train = 0.15 * 0.8
                ratio_obs = is_mask[..., 0].to(torch.float32).sum(-1) / mask_f.sum(-1)
                x = x * (1.0 - mask_ratio_train) / (1.0 - ratio_obs)[:, None, None]
            x = x * mask_f[..., None]
            cos, sin = _rotary_cos_sin(x.shape[1], cfg.head_dim, x.device)
            # additive attention bias: 0 for valid keys, -inf for padding
            bias = torch.where(mask_f[:, None, None, :] > 0, 0.0, -math.inf)
            for layer in self.layers:
                x = layer(x, cos, sin, bias)
            return self.final_ln(x)


def params_to_state_dict(params: Dict) -> Dict[str, torch.Tensor]:
    """JAX-layout params dict -> :class:`ESM2` ``state_dict`` (linear
    weights (in, out) -> (out, in))."""
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    sd = {"embed.weight": t(params["embed"]),
          "final_ln.weight": t(params["final_ln_w"]), "final_ln.bias": t(params["final_ln_b"])}
    for i, layer in enumerate(params["layers"]):
        for name in _LINEARS + _NORMS:
            w = t(layer[f"{name}_w"])
            sd[f"layers.{i}.{name}.weight"] = w.T.contiguous() if name in _LINEARS else w
            sd[f"layers.{i}.{name}.bias"] = t(layer[f"{name}_b"])
    return sd


def module_params(model: ESM2) -> Dict:
    """:class:`ESM2` -> the JAX-layout params dict of numpy float32 arrays
    (the inverse of :func:`params_to_state_dict`)."""
    sd = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    layers = []
    for i in range(len(model.layers)):
        layer = {}
        for name in _LINEARS + _NORMS:
            w = sd[f"layers.{i}.{name}.weight"]
            layer[f"{name}_w"] = np.ascontiguousarray(w.T) if name in _LINEARS else w
            layer[f"{name}_b"] = sd[f"layers.{i}.{name}.bias"]
        layers.append(layer)
    return {"embed": sd["embed.weight"], "final_ln_w": sd["final_ln.weight"],
            "final_ln_b": sd["final_ln.bias"], "layers": layers}


def convert_hf_state_dict(state_dict, num_layers: int) -> Dict:
    """HF ``EsmModel`` state dict (torch tensors or numpy arrays) -> the
    params dict. Accepts keys with or without a leading ``esm.`` prefix
    (EsmModel vs EsmForMaskedLM checkpoints). Linear weights transpose
    from torch's (out, in) to (in, out)."""

    def arr(key):
        for k in (key, "esm." + key):
            if k in state_dict:
                v = state_dict[k]
                return np.asarray(v.detach().cpu().numpy()
                                  if hasattr(v, "detach") else v, np.float32)
        raise KeyError(key)

    params = {
        "embed": arr("embeddings.word_embeddings.weight"),
        "final_ln_w": arr("encoder.emb_layer_norm_after.weight"),
        "final_ln_b": arr("encoder.emb_layer_norm_after.bias"),
        "layers": [],
    }
    for i in range(num_layers):
        pre = f"encoder.layer.{i}."
        params["layers"].append({
            "ln1_w": arr(pre + "attention.LayerNorm.weight"),
            "ln1_b": arr(pre + "attention.LayerNorm.bias"),
            "q_w": arr(pre + "attention.self.query.weight").T,
            "q_b": arr(pre + "attention.self.query.bias"),
            "k_w": arr(pre + "attention.self.key.weight").T,
            "k_b": arr(pre + "attention.self.key.bias"),
            "v_w": arr(pre + "attention.self.value.weight").T,
            "v_b": arr(pre + "attention.self.value.bias"),
            "attn_out_w": arr(pre + "attention.output.dense.weight").T,
            "attn_out_b": arr(pre + "attention.output.dense.bias"),
            "ln2_w": arr(pre + "LayerNorm.weight"),
            "ln2_b": arr(pre + "LayerNorm.bias"),
            "fc1_w": arr(pre + "intermediate.dense.weight").T,
            "fc1_b": arr(pre + "intermediate.dense.bias"),
            "fc2_w": arr(pre + "output.dense.weight").T,
            "fc2_b": arr(pre + "output.dense.bias"),
        })
    return params


def save_params(params: Dict, path: str, num_heads: Optional[int] = None) -> None:
    """The params dict as the JAX package's npz (``layer{i}/{name}`` keys,
    ``meta/num_heads`` when given)."""
    flat = {"embed": params["embed"],
            "final_ln_w": params["final_ln_w"],
            "final_ln_b": params["final_ln_b"]}
    for i, layer in enumerate(params["layers"]):
        for k, v in layer.items():
            flat[f"layer{i}/{k}"] = v
    if num_heads is not None:
        flat["meta/num_heads"] = np.asarray(num_heads, np.int32)
    np.savez_compressed(path, **{k: np.asarray(v) for k, v in flat.items()})


def load_params(path: str):
    """Returns (params, cfg): the config is reconstructed from the stored
    shapes and the ``meta/num_heads`` entry, else ``hidden // 64`` heads."""
    with np.load(path) as z:
        layers: List[Dict] = []
        i = 0
        while f"layer{i}/ln1_w" in z:
            layers.append({k.split("/", 1)[1]: z[k] for k in z.files
                           if k.startswith(f"layer{i}/")})
            i += 1
        params = {"embed": z["embed"], "final_ln_w": z["final_ln_w"],
                  "final_ln_b": z["final_ln_b"], "layers": layers}
        hidden = params["embed"].shape[1]
        heads = (int(z["meta/num_heads"]) if "meta/num_heads" in z
                 else max(1, hidden // 64))
    cfg = ESM2Config(
        vocab_size=params["embed"].shape[0],
        hidden_size=hidden,
        num_layers=len(layers),
        num_heads=heads,
        intermediate_size=layers[0]["fc1_w"].shape[1] if layers else 4 * hidden,
    )
    return params, cfg


class TorchESM2Embedder:
    """Per-chain embeddings with the port's encoder on the model's device
    (counterpart of the JAX package's ``JaxESM2Embedder``): per-residue
    representations with the <cls>/<eos> rows stripped, lengths padded up
    to a multiple of ``length_quantum`` so the allocator sees few shapes."""

    def __init__(self, model: ESM2, length_quantum: int = 128):
        self.model = model.eval()
        self.cfg = model.cfg
        self.quantum = length_quantum

    @classmethod
    def from_params(cls, params: Dict, cfg: ESM2Config, length_quantum: int = 128,
                    device=DEFAULT_DEVICE) -> "TorchESM2Embedder":
        return cls(ESM2.from_params(params, cfg, device), length_quantum)

    @property
    def device(self) -> torch.device:
        return self.model.embed.weight.device

    def embed(self, sequence: str) -> np.ndarray:
        """(len(sequence), hidden) float32 per-residue embeddings."""
        ids = tokenize(sequence)
        n = len(ids)
        lb = -(-n // self.quantum) * self.quantum
        toks = np.full((1, lb), PAD_ID, np.int64)
        toks[0, :n] = ids
        mask = np.zeros((1, lb), np.int64)
        mask[0, :n] = 1
        with torch.inference_mode():
            out = self.model(torch.as_tensor(toks, device=self.device),
                             torch.as_tensor(mask, device=self.device))
            return out[0, 1: n - 1].cpu().numpy()  # strip <cls>/<eos>

    def embed_protein(self, protein) -> np.ndarray:
        """Every chain's embeddings, concatenated in file order: rows align
        with the receptor featurizer's residues (none for a protein
        without chains)."""
        from diffdock_tpu_torch.data.esm import chain_sequences

        parts = [self.embed(seq) for _, seq in chain_sequences(protein)]
        if not parts:
            return np.zeros((0, self.cfg.hidden_size), np.float32)
        return np.concatenate(parts, axis=0)
