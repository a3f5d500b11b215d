"""Reference PyTorch (e3nn/PyG) checkpoints -> the flax-shaped tree (port
of ``diffdock_tpu/utils/torch_import.py``).

The reference releases trained score and confidence weights as torch
state dicts with a flat argparse dump beside them (``model_parameters.yml``).
The key and permutation maps here are the JAX package's, copied so that the
port imports nothing of it; their output is that package's own
``(params, batch_stats, report)``: nested dicts of float32 numpy arrays in
the flax layout, the tree a run directory of either package holds.
:func:`diffdock_tpu_torch.utils.convert.load_converted` turns it into a
port model's ``state_dict``. The TP weight permutations take their path
layout from the port's own ``ops/tensor_product.py``, whose flat weight
layout is the JAX package's.

Converters exist for the four reference architectures:

* ``convert_cg_state_dict``      — new CGModel (``models/cg_model.py``)
* ``convert_aa_state_dict``      — new AAModel (``models/aa_model.py``),
  loaded into the port's ``AAScoreModel``
* ``convert_old_cg_state_dict``  — CGOldModel (``models/old_cg_model.py``)
* ``convert_old_aa_state_dict``  — AAOldModel (``models/old_aa_model.py``),
  the architecture of the shipped default confidence model

Transforms:

* plain Linears transpose (torch stores (out, in); flax (in, out)),
* per-categorical embedding tables map 1:1,
* the tensor-product weight-generating MLP's final linear maps onto
  ``FCBlock.out_kernel/out_bias`` with a column permutation between the
  reference TP's flat weight layout and ours:
  - e3nn ``o3.FullyConnectedTensorProduct`` (shared_weights=False) flattens
    per-instruction blocks in in1-major instruction order
    (``tp_weight_permutation``);
  - ``FasterTensorProduct`` (used when ``sh_lmax == 1 and not
    use_second_order_repr``) flattens per-output-key blocks in its fixed
    '0e','1o','1e','0o' dict order (``faster_weight_permutation``);
* e3nn BatchNorm weight/bias/running stats map onto the irreps batch
  norm's weight/bias and ``batch_stats`` mean/var.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np


def _t(a) -> np.ndarray:
    return np.asarray(a, np.float32).T


def _n(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def tp_weight_permutation(tp) -> np.ndarray:
    """perm[j] = e3nn flat index feeding OUR flat weight index j.

    e3nn instruction order: for i in in1, for j in in2, for every allowed
    output entry (i-major). Ours: for k in irreps_out, for (i, j) i-major.
    Both decompose into the same (i, j, k) path blocks of size
    mul1 * mul2 * mul_out, laid out (u-major, v, w-minor) in both
    conventions — so blocks permute wholesale.
    """
    e3nn_paths: List[Tuple[int, int, int, int]] = []  # (i, j, k, size)
    for i, e1 in enumerate(tp.irreps_in1):
        for j, e2 in enumerate(tp.irreps_in2):
            for k, ek in enumerate(tp.irreps_out):
                if ek.ir in e1.ir * e2.ir:
                    e3nn_paths.append((i, j, k, e1.mul * e2.mul * ek.mul))
    offsets = {}
    off = 0
    for i, j, k, size in e3nn_paths:
        offsets[(i, j, k)] = (off, size)
        off += size
    total = off

    perm = np.empty(total, np.int64)
    pos = 0
    for k, (pk, ek) in enumerate(zip(tp.paths, tp.irreps_out)):
        for p in pk:
            o, size = offsets[(p.i, p.j, k)]
            perm[pos : pos + size] = np.arange(o, o + size)
            pos += size
    assert pos == total == tp.weight_numel
    return perm


# FasterTensorProduct weight layout (tensor_layers.py:63-69): fixed output
# key order with fixed contributing-input order per key
_FASTER_KEYS = [(0, 1), (1, -1), (1, 1), (0, -1)]  # 0e, 1o, 1e, 0o
_FASTER_IN_ORDER = {
    (0, 1): [(0, 1), (1, -1)],
    (1, -1): [(0, 1), (1, -1), (1, 1)],
    (1, 1): [(1, -1), (1, 1), (0, -1)],
    (0, -1): [(1, 1), (0, -1)],
}


def faster_weight_permutation(tp) -> np.ndarray:
    """perm[j] = FasterTensorProduct flat index feeding OUR flat index j.

    Requires sh == 1x0e+1x1o (the layer asserts this) and at most one input
    entry per (l, parity) — true for every irrep ladder. For ladder-ordered
    outputs the permutation is the identity; computed programmatically so
    non-ladder layouts (e.g. '{ns}x0o + {ns}x0e') convert correctly too.
    """
    in_entries = {(e.ir.l, e.ir.p): (i, e.mul) for i, e in enumerate(tp.irreps_in1)}
    out_entries = {(e.ir.l, e.ir.p): (k, e.mul) for k, e in enumerate(tp.irreps_out)}
    assert len(in_entries) == len(tp.irreps_in1), "duplicate input irreps"
    assert len(out_entries) == len(tp.irreps_out), "duplicate output irreps"

    offsets = {}
    off = 0
    for ok in _FASTER_KEYS:
        if ok not in out_entries:
            continue
        k, w = out_entries[ok]
        for ik in _FASTER_IN_ORDER[ok]:
            if ik not in in_entries:
                continue
            i, mul = in_entries[ik]
            offsets[(k, i)] = (off, mul * w)
            off += mul * w
    assert off == tp.weight_numel, (off, tp.weight_numel)

    perm = np.empty(off, np.int64)
    pos = 0
    for k, pk in enumerate(tp.paths):
        for p in pk:
            o, size = offsets[(k, p.i)]
            perm[pos : pos + size] = np.arange(o, o + size)
            pos += size
    assert pos == off
    return perm


def _convert_fc(sd: Dict, prefix: str, tp, tp_weights_layers: int = 2,
                faster: bool = False):
    """Reference FCBlock (Sequential, linears at indices 0,3,6,...) ->
    our FCBlock {Dense_i: {kernel,bias}, out_kernel, out_bias}."""
    out: Dict[str, Any] = {}
    n_linears = tp_weights_layers
    for li in range(n_linears - 1):
        w = sd.pop(f"{prefix}.{3 * li}.weight")
        b = sd.pop(f"{prefix}.{3 * li}.bias")
        out[f"Dense_{li}"] = {"kernel": _t(w), "bias": _n(b)}
    w = sd.pop(f"{prefix}.{3 * (n_linears - 1)}.weight")
    b = sd.pop(f"{prefix}.{3 * (n_linears - 1)}.bias")
    perm = faster_weight_permutation(tp) if faster else tp_weight_permutation(tp)
    out["out_kernel"] = _t(w)[:, perm]
    out["out_bias"] = _n(b)[perm]
    return out


def _convert_sequential(sd: Dict, prefix: str, linear_idxs=(0, 3)):
    out = {}
    for di, li in enumerate(linear_idxs):
        out[f"Dense_{di}"] = {
            "kernel": _t(sd.pop(f"{prefix}.{li}.weight")),
            "bias": _n(sd.pop(f"{prefix}.{li}.bias")),
        }
    return out


def _convert_bn(sd: Dict, prefix: str):
    params = {
        "weight": _n(sd.pop(f"{prefix}.weight")),
        "bias": _n(sd.pop(f"{prefix}.bias")),
    }
    stats = {
        "mean": _n(sd.pop(f"{prefix}.running_mean")),
        "var": _n(sd.pop(f"{prefix}.running_var")),
    }
    sd.pop(f"{prefix}.num_batches_tracked", None)
    return params, stats


def _convert_atom_encoder(sd: Dict, prefix: str, kind: str = "new"):
    """kind='new': the fuse layer is ``additional_features_embedder``
    (models/layers.py:57) -> our ``fuse``. kind='old': additive ``linear``
    plus optional ``lm_embedding_layer`` (models/layers.py:96-101) -> same
    names in our ``OldAtomEncoder``."""
    out: Dict[str, Any] = {}
    i = 0
    while f"{prefix}.atom_embedding_list.{i}.weight" in sd:
        out[f"cat_{i}"] = {
            "embedding": _n(sd.pop(f"{prefix}.atom_embedding_list.{i}.weight"))
        }
        i += 1
    if kind == "new":
        if f"{prefix}.additional_features_embedder.weight" in sd:
            out["fuse"] = {
                "kernel": _t(sd.pop(f"{prefix}.additional_features_embedder.weight")),
                "bias": _n(sd.pop(f"{prefix}.additional_features_embedder.bias")),
            }
    else:
        if f"{prefix}.linear.weight" in sd:
            out["linear"] = {
                "kernel": _t(sd.pop(f"{prefix}.linear.weight")),
                "bias": _n(sd.pop(f"{prefix}.linear.bias")),
            }
        if f"{prefix}.lm_embedding_layer.weight" in sd:
            out["lm_embedding_layer"] = {
                "kernel": _t(sd.pop(f"{prefix}.lm_embedding_layer.weight")),
                "bias": _n(sd.pop(f"{prefix}.lm_embedding_layer.bias")),
            }
    return out


def _convert_irreps_linear(sd: Dict, prefix: str, irreps_in: str,
                           irreps_out: str):
    """e3nn ``o3.Linear`` (internal_weights=True) -> our ``IrrepsLinear``.

    e3nn flattens per-instruction (mul_in, mul_out) blocks in in-major
    instruction order; ours keys one stacked kernel per OUTPUT entry
    (``w_{k}``), with input entries stacked in irreps_in order — the same
    row order, so blocks concatenate directly. Both divide by
    sqrt(total fan-in) at apply time."""
    from diffdock_tpu_torch.ops.irreps import Irreps

    w = _n(sd.pop(f"{prefix}.weight")).ravel()
    in_e = list(Irreps(irreps_in))
    out_e = list(Irreps(irreps_out))
    blocks: Dict[int, list] = {}
    off = 0
    for i, e1 in enumerate(in_e):
        for k, e3 in enumerate(out_e):
            if (e1.ir.l, e1.ir.p) == (e3.ir.l, e3.ir.p):
                size = e1.mul * e3.mul
                blocks.setdefault(k, []).append(
                    (i, w[off : off + size].reshape(e1.mul, e3.mul))
                )
                off += size
    assert off == w.size, (off, w.size)
    return {
        f"w_{k}": np.concatenate([b for _, b in sorted(lst)], axis=0)
        for k, lst in blocks.items()
    }


def _convert_confidence_mlp(sd: Dict, stats: Dict, prefix: str, our_name: str):
    """Dense(-BN1d)-ReLU-Drop x2 + Dense -> ConfidenceMLP params/stats.
    Walks the Sequential indices, classifying 2D weights as linears and 1D
    as torch BatchNorm1d (absent when confidence_no_batchnorm)."""
    cp: Dict[str, Any] = {}
    li = 0
    # Sequential slots: Linear(0) BN/Id(1) ReLU(2) Drop(3) Linear(4) BN/Id(5)
    # ReLU(6) Drop(7) Linear(8); scan all slots, skipping parameterless ones
    for idx in range(9):
        if f"{prefix}.{idx}.weight" not in sd:
            continue
        w = sd.pop(f"{prefix}.{idx}.weight")
        b = sd.pop(f"{prefix}.{idx}.bias")
        if np.asarray(w).ndim == 2:
            cp[f"Dense_{li}"] = {"kernel": _t(w), "bias": _n(b)}
            li += 1
        else:  # torch BatchNorm1d inside the MLP
            cp[f"BatchNorm_{li - 1}"] = {"scale": _n(w), "bias": _n(b)}
            stats.setdefault(our_name, {})[f"BatchNorm_{li - 1}"] = {
                "mean": _n(sd.pop(f"{prefix}.{idx}.running_mean")),
                "var": _n(sd.pop(f"{prefix}.{idx}.running_var")),
            }
            sd.pop(f"{prefix}.{idx}.num_batches_tracked", None)
    return cp


def _to_numpy_sd(state_dict: Dict[str, Any]) -> Dict[str, np.ndarray]:
    return {
        k: (v.numpy() if hasattr(v, "numpy") else np.asarray(v))
        for k, v in state_dict.items()
    }


def _sh_str(cfg) -> str:
    from diffdock_tpu_torch.ops.irreps import Irreps

    return str(Irreps.spherical_harmonics(cfg.sh_lmax))


def _is_faster(cfg) -> bool:
    # reference aa_model.py:127 / cg_model.py conv construction
    return cfg.sh_lmax == 1 and not cfg.use_second_order_repr


class _Ctx:
    """Shared conversion state: numpy state dict + output trees."""

    def __init__(self, state_dict, cfg, old: bool):
        from diffdock_tpu_torch.ops.irreps import get_irrep_seq
        from diffdock_tpu_torch.ops.tensor_product import FullyConnectedTensorProduct

        self.sd = _to_numpy_sd(state_dict)
        self.cfg = cfg
        self.params: Dict[str, Any] = {}
        self.stats: Dict[str, Any] = {}
        self.twl = 2 if old else cfg.tp_weights_layers
        self.sh = _sh_str(cfg)
        self.irrep_seq = get_irrep_seq(
            cfg.ns, cfg.nv, cfg.use_second_order_repr,
            False if old else cfg.reduce_pseudoscalars,
        )
        self._FCTP = FullyConnectedTensorProduct
        # only the ladder convs may use FasterTensorProduct, and never in
        # the old architecture (OldTensorProductConvLayer has no faster flag)
        self.ladder_faster = (not old) and _is_faster(cfg)

    def ladder(self, i: int) -> str:
        return self.irrep_seq[min(i, len(self.irrep_seq) - 1)]

    def tp_for(self, i: int):
        return self._FCTP(self.ladder(i), self.sh, self.ladder(i + 1))

    def seq(self, name: str, ref: Optional[str] = None):
        ref = ref or name
        if f"{ref}.0.weight" in self.sd:
            self.params[name] = _convert_sequential(self.sd, ref)

    def conv_layer(self, ref: str, ours: str, tp, n_groups: int,
                   faster: bool = False, multi: bool = False):
        """One TensorProductConvLayer / OldTensorProductConvLayer."""
        p: Dict[str, Any] = {}
        if n_groups == 1:
            # Joint/Multi layers name their single shared FC 'fc_shared'
            our_fc = "fc_shared" if multi else "fc"
            fc_prefixes = {our_fc: f"{ref}.fc"}
        else:
            fc_prefixes = {f"fc_{g}": f"{ref}.fc.{g}" for g in range(n_groups)}
        for our_fc, ref_fc in fc_prefixes.items():
            if f"{ref_fc}.0.weight" in self.sd:
                p[our_fc] = _convert_fc(self.sd, ref_fc, tp, self.twl, faster)
        if f"{ref}.batch_norm.weight" in self.sd:
            bn_p, bn_s = _convert_bn(self.sd, f"{ref}.batch_norm")
            p["bn"] = bn_p
            self.stats.setdefault(ours, {})["bn"] = bn_s
        self.params[ours] = p

    def score_heads(self):
        """center conv + tr/rot/torsion heads (identical across all four
        architectures, cg_model.py:222-250 / old_cg_model.py:156-201)."""
        cfg = self.cfg
        sd = self.sd
        if "center_edge_embedding.0.weight" in sd:
            self.params["center_edge_embedding"] = _convert_sequential(
                sd, "center_edge_embedding"
            )
        # in irreps of the final convs = output of the last ladder step
        npe = 0 if cfg.old_architecture else cfg.num_prot_emb_layers
        final_in = self.ladder(npe + cfg.num_conv_layers)
        if "sidechain_predictor.weight" in sd:
            self.params["sidechain_predictor"] = _convert_irreps_linear(
                sd, "sidechain_predictor", final_in,
                "4x0e + 2x1e + 4x0o + 2x1o",
            )
        tp_final = self._FCTP(final_in, self.sh, "2x1o + 2x1e")
        self.conv_layer("final_conv", "final_conv", tp_final, 1)
        for name in ("tr_final_layer", "rot_final_layer"):
            if f"{name}.0.weight" in sd:
                self.params[name] = _convert_sequential(sd, name, (0, 3))
        if not cfg.no_torsion and "final_edge_embedding.0.weight" in sd:
            self.params["final_edge_embedding"] = _convert_sequential(
                sd, "final_edge_embedding"
            )
            from diffdock_tpu_torch.ops.tensor_product import FullTensorProduct

            ftp = FullTensorProduct(self.sh, "2e")
            tp_tor = self._FCTP(
                final_in, str(ftp.irreps_out), f"{cfg.ns}x0o + {cfg.ns}x0e"
            )
            self.conv_layer("tor_bond_conv", "tor_bond_conv", tp_tor, 1)
            # tor_final_layer Sequential: Linear(0, bias=False), Tanh,
            # Dropout, Linear(3, bias=False)
            self.params["tor_final_dense1"] = {
                "kernel": _t(sd.pop("tor_final_layer.0.weight")),
            }
            sd.pop("tor_final_layer.0.bias", None)
            self.params["tor_final_dense2"] = {
                "kernel": _t(sd.pop("tor_final_layer.3.weight")),
            }
            sd.pop("tor_final_layer.3.bias", None)

    def confidence_heads(self):
        cfg = self.cfg
        if "confidence_predictor.0.weight" in self.sd:
            self.params["confidence_predictor"] = _convert_confidence_mlp(
                self.sd, self.stats, "confidence_predictor",
                "confidence_predictor",
            )
        if "atom_confidence_predictor.0.weight" in self.sd:
            self.params["atom_confidence_predictor"] = _convert_confidence_mlp(
                self.sd, self.stats, "atom_confidence_predictor",
                "atom_confidence_predictor",
            )
        if "affinity_predictor.0.weight" in self.sd:
            self.params["affinity_predictor"] = _convert_confidence_mlp(
                self.sd, self.stats, "affinity_predictor",
                "affinity_predictor",
            )

    def finish(self):
        report = {"unconsumed": sorted(self.sd.keys())}
        return self.params, self.stats, report


def convert_cg_state_dict(
    state_dict: Dict[str, Any], cfg
) -> Tuple[Dict[str, Any], Dict[str, Any], Dict[str, List[str]]]:
    """Reference new CGModel state dict -> (params, batch_stats, report)."""
    c = _Ctx(state_dict, cfg, old=False)
    sd = c.sd

    c.params["lig_node_embedding"] = _convert_atom_encoder(
        sd, "lig_node_embedding", "new"
    )
    c.params["rec_node_embedding"] = _convert_atom_encoder(
        sd, "rec_node_embedding", "new"
    )
    for name in ("lig_edge_embedding", "rec_edge_embedding",
                 "rec_sigma_embedding", "cross_edge_embedding"):
        c.seq(name)

    for l in range(cfg.num_prot_emb_layers):
        c.conv_layer(f"rec_emb_layers.{l}", f"rec_emb_{l}", c.tp_for(l), 1,
                     faster=c.ladder_faster)
        if f"lig_emb_layers.{l}.fc.0.weight" in sd:
            c.conv_layer(f"lig_emb_layers.{l}", f"lig_emb_{l}", c.tp_for(l),
                         1, faster=c.ladder_faster)
    n_groups = 4 if cfg.differentiate_convolutions else 1
    for l in range(cfg.num_conv_layers):
        # the last joint layer only has ligand-receiver groups
        # (cg_model.py:347-349 restricts to s2 edges)
        ng = n_groups if l < cfg.num_conv_layers - 1 else (
            2 if cfg.differentiate_convolutions else 1
        )
        c.conv_layer(
            f"conv_layers.{l}", f"conv_{l}",
            c.tp_for(cfg.num_prot_emb_layers + l), ng,
            faster=c.ladder_faster, multi=not cfg.differentiate_convolutions,
        )

    if cfg.confidence_mode:
        c.confidence_heads()
    else:
        c.score_heads()
    return c.finish()


def convert_aa_state_dict(
    state_dict: Dict[str, Any], cfg
) -> Tuple[Dict[str, Any], Dict[str, Any], Dict[str, List[str]]]:
    """Reference new AAModel state dict (models/aa_model.py) ->
    (params, batch_stats, report). Conv layers are MultiTPConvLayers with 4
    protein-embedding groups and 9 (3 on the last layer) joint groups."""
    c = _Ctx(state_dict, cfg, old=False)
    sd = c.sd

    c.params["lig_node_embedding"] = _convert_atom_encoder(
        sd, "lig_node_embedding", "new"
    )
    c.params["rec_node_embedding"] = _convert_atom_encoder(
        sd, "rec_node_embedding", "new"
    )
    c.params["atom_node_embedding"] = _convert_atom_encoder(
        sd, "atom_node_embedding", "new"
    )
    for name in ("lig_edge_embedding", "rec_edge_embedding",
                 "rec_sigma_embedding", "atom_edge_embedding",
                 "lr_edge_embedding", "ar_edge_embedding",
                 "la_edge_embedding"):
        c.seq(name)

    diff = cfg.differentiate_convolutions
    for l in range(cfg.num_prot_emb_layers):
        c.conv_layer(
            f"rec_emb_layers.{l}", f"rec_emb_{l}", c.tp_for(l),
            4 if diff else 1, faster=c.ladder_faster, multi=True,
        )
        if f"lig_emb_layers.{l}.fc.0.weight" in sd:
            c.conv_layer(
                f"lig_emb_layers.{l}", f"lig_emb_{l}", c.tp_for(l), 1,
                faster=c.ladder_faster,
            )
    for l in range(cfg.num_conv_layers):
        last = l == cfg.num_conv_layers - 1
        ng = (3 if last else 9) if diff else 1
        c.conv_layer(
            f"conv_layers.{l}", f"conv_{l}",
            c.tp_for(cfg.num_prot_emb_layers + l), ng,
            faster=c.ladder_faster, multi=True,
        )

    if cfg.confidence_mode:
        c.confidence_heads()
    else:
        c.score_heads()
    return c.finish()


def convert_old_cg_state_dict(
    state_dict: Dict[str, Any], cfg
) -> Tuple[Dict[str, Any], Dict[str, Any], Dict[str, List[str]]]:
    """Reference CGOldModel state dict (models/old_cg_model.py) ->
    (params, batch_stats, report) for ``OldCGScoreModel``."""
    c = _Ctx(state_dict, cfg, old=True)
    sd = c.sd
    kind = "old" if cfg.use_old_atom_encoder else "new"

    c.params["lig_node_embedding"] = _convert_atom_encoder(
        sd, "lig_node_embedding", kind
    )
    c.params["rec_node_embedding"] = _convert_atom_encoder(
        sd, "rec_node_embedding", kind
    )
    for name in ("lig_edge_embedding", "rec_edge_embedding",
                 "cross_edge_embedding"):
        c.seq(name)

    L = cfg.num_conv_layers
    for stack, our, used in (
        ("lig_conv_layers", "lig_conv", L),
        ("rec_conv_layers", "rec_conv", L - 1),
        ("lig_to_rec_conv_layers", "lig_to_rec_conv", L - 1),
        ("rec_to_lig_conv_layers", "rec_to_lig_conv", L),
    ):
        for l in range(L):
            c.conv_layer(f"{stack}.{l}", f"{our}_{l}", c.tp_for(l), 1)
            if l >= used:
                # the reference constructs a full ModuleList but never calls
                # the receptor-side convs of the last layer
                # (old_cg_model.py:260); they stay at init values in the
                # checkpoint and have no counterpart in our param tree
                c.params.pop(f"{our}_{l}")
                c.stats.pop(f"{our}_{l}", None)

    if cfg.confidence_mode:
        c.confidence_heads()
    else:
        c.score_heads()
    return c.finish()


def convert_old_aa_state_dict(
    state_dict: Dict[str, Any], cfg
) -> Tuple[Dict[str, Any], Dict[str, Any], Dict[str, List[str]]]:
    """Reference AAOldModel state dict (models/old_aa_model.py) ->
    (params, batch_stats, report) for ``OldAAScoreModel``. This covers the
    SHIPPED default confidence checkpoint."""
    c = _Ctx(state_dict, cfg, old=True)
    sd = c.sd
    kind = "old" if cfg.use_old_atom_encoder else "new"

    for enc in ("lig_node_embedding", "rec_node_embedding",
                "atom_node_embedding"):
        c.params[enc] = _convert_atom_encoder(sd, enc, kind)
    for name in ("lig_edge_embedding", "rec_edge_embedding",
                 "atom_edge_embedding", "lr_edge_embedding",
                 "ar_edge_embedding", "la_edge_embedding"):
        c.seq(name)

    for l in range(cfg.num_conv_layers):
        for k in range(9):
            i = 9 * l + k
            c.conv_layer(f"conv_layers.{i}", f"conv_{i}", c.tp_for(l), 1)
            if k >= 3 and l == cfg.num_conv_layers - 1:
                # convs 3-8 of the last layer are constructed but never
                # called (old_aa_model.py:248 'last layer optimisation')
                c.params.pop(f"conv_{i}")
                c.stats.pop(f"conv_{i}", None)

    if cfg.confidence_mode:
        c.confidence_heads()
    else:
        c.score_heads()
    return c.finish()


def convert_state_dict(state_dict: Dict[str, Any], cfg):
    """Dispatch on (old_architecture, all_atoms) like the reference factory."""
    if cfg.old_architecture:
        fn = convert_old_aa_state_dict if cfg.all_atoms else convert_old_cg_state_dict
    else:
        fn = convert_aa_state_dict if cfg.all_atoms else convert_cg_state_dict
    return fn(state_dict, cfg)


def config_from_reference_args(
    args: Dict[str, Any],
    confidence_mode: bool = False,
    old: bool = False,
):
    """Map a reference run's ``model_parameters.yml`` args (the argparse
    namespace dump shipped with every released checkpoint) onto our
    ``ScoreModelConfig``, replicating the reference factory's defaults and
    negations (``utils/utils.py:172-281`` ``get_model``)."""
    import dataclasses

    from diffdock_tpu_torch.diffusion.schedules import SigmaConfig
    from diffdock_tpu_torch.models.config import ScoreModelConfig

    g = args.get

    def has_esm():
        return any(
            g(k) is not None
            for k in (
                "esm_embeddings_path", "moad_esm_embeddings_path",
                "pdbbind_esm_embeddings_path",
                "pdbsidechain_esm_embeddings_path",
            )
        )

    rmsd_cut = g("rmsd_classification_cutoff")
    num_conf_outputs = (
        len(rmsd_cut) + 1 if isinstance(rmsd_cut, list) else 1
    )
    atom_rmsd_cut = g("atom_rmsd_classification_cutoff")
    sigma = SigmaConfig(
        tr_sigma_min=g("tr_sigma_min", 0.1),
        tr_sigma_max=g("tr_sigma_max", 30.0),
        rot_sigma_min=g("rot_sigma_min", 0.1),
        rot_sigma_max=g("rot_sigma_max", 1.65),
        tor_sigma_min=g("tor_sigma_min", 0.0314),
        tor_sigma_max=g("tor_sigma_max", 3.14),
    )
    cfg = ScoreModelConfig(
        ns=g("ns", 16),
        nv=g("nv", 4),
        num_conv_layers=g("num_conv_layers", 2),
        num_prot_emb_layers=0 if old else g("num_prot_emb_layers", 0) or 0,
        sh_lmax=2 if old else g("sh_lmax", 2) or 2,
        use_second_order_repr=bool(g("use_second_order_repr", False)),
        reduce_pseudoscalars=(
            False if old else bool(g("reduce_pseudoscalars", False))
        ),
        embed_also_ligand=(
            False if old else bool(g("embed_also_ligand", False))
        ),
        lig_max_radius=g("max_radius", 5.0),
        cross_max_distance=g("cross_max_distance", 80.0),
        crop_beyond=g("crop_beyond"),
        dynamic_max_cross=bool(g("dynamic_max_cross", False)),
        in_lig_edge_features=4,
        sigma_embed_dim=g("sigma_embed_dim", 32),
        distance_embed_dim=g("distance_embed_dim", 32),
        cross_distance_embed_dim=g("cross_distance_embed_dim", 32),
        # reference get_model falls back to scale 10000 when the run
        # predates the embedding_type arg (utils/utils.py:174-177)
        embedding_type=g("embedding_type", "sinusoidal"),
        embedding_scale=(
            g("embedding_scale", 1000) if "embedding_type" in args else 10000
        ),
        lm_embedding_dim=1280 if has_esm() else 0,
        batch_norm=not g("no_batch_norm", False),
        dropout=g("dropout", 0.0),
        tp_weights_layers=g("tp_weights_layers", 2),
        smooth_edges=bool(g("smooth_edges", False)),
        odd_parity=bool(g("odd_parity", False)),
        no_torsion=bool(g("no_torsion", False)),
        scale_by_sigma=bool(g("scale_by_sigma", True)),
        # reference: not args.not_fixed_center_conv if present else False
        fixed_center_conv=(
            (not g("not_fixed_center_conv"))
            if "not_fixed_center_conv" in args else False
        ),
        confidence_mode=confidence_mode,
        confidence_dropout=g("confidence_dropout", 0.0),
        confidence_no_batchnorm=bool(g("confidence_no_batchnorm", False)),
        num_confidence_outputs=num_conf_outputs,
        affinity_prediction=bool(g("affinity_prediction", False)),
        atom_confidence=(
            g("atom_confidence_loss_weight", 0.0) or 0.0
        ) > 0.0,
        atom_num_confidence_outputs=(
            len(atom_rmsd_cut) + 1 if isinstance(atom_rmsd_cut, list) else 1
        ),
        sidechain_pred=(
            (g("sidechain_loss_weight", 0.0) or 0.0) > 0
            or (g("backbone_loss_weight", 0.0) or 0.0) > 0
        ),
        differentiate_convolutions=not g("no_differentiate_convolutions", False),
        old_architecture=old,
        use_old_atom_encoder=bool(g("use_old_atom_encoder", True)) if old
        else True,
        all_atoms=bool(g("all_atoms", False)),
        sigma=sigma,
    )
    return dataclasses.replace(cfg)


def load_torch_checkpoint(path: str, cfg):
    """Read a reference ``.pt`` checkpoint and convert it. The file is a
    state dict of tensors, or a dict with one under ``"model"`` (a
    ``DataParallel`` run's keys carry ``module.``); either loads with
    ``weights_only=True``, which unpickles tensors and plain containers
    only, never code."""
    import torch

    raw = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(raw, dict) and "model" in raw:
        raw = raw["model"]
    state_dict = {k.replace("module.", ""): v for k, v in raw.items()}
    return convert_state_dict(state_dict, cfg)
