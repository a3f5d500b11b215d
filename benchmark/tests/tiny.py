"""A tiny cell for the CPU tests: the real harness, configuration layout
and readers, at widths and sizes a test run holds."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

from benchmark.harness import spec

TINY_SCORE = dict(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=1, lm_embedding_dim=16,
                  sigma_embed_dim=8, distance_embed_dim=8, cross_distance_embed_dim=8)
TINY_CONFIDENCE = dict(ns=8, nv=2, num_conv_layers=2, lm_embedding_dim=16)
TINY_V1 = dict(ns=8, nv=2, num_conv_layers=3, lm_embedding_dim=16, sigma_embed_dim=8,
               distance_embed_dim=8, cross_distance_embed_dim=8)
TINY_TRAFFIC = dict(poses=3, cycle=[[10, 30], [8, 20], [9, 24]], ligand_atoms_per_rotatable_bond=4,
                    atoms_per_residue=4, warmup_steps=1)
TINY_GRAPH = dict(c_alpha_max_neighbors=6, atom_max_neighbors=4)


def tiny_config(name: str) -> dict:
    """The cell's configuration file with its widths, steps and graphs cut."""
    cfg = copy.deepcopy(spec.load_json(spec.BENCH_DIR / "configs" / f"{name}.json"))
    cfg["score_model"].update(TINY_V1 if cfg["score_model"]["old_architecture"] else TINY_SCORE)
    cfg["confidence_model"].update(TINY_CONFIDENCE)
    cfg["sampler"].update(inference_steps=4, actual_steps=3)
    cfg["graph"].update(TINY_GRAPH)
    return cfg


def tiny_root(tmp: Path, limits=None) -> tuple:
    """(root, benchmark): a benchmark folder under ``tmp`` whose cells are
    the real ones cut to tiny sizes, with the real metric readers."""
    bench = spec.load_json(spec.find_benchmark())
    for sub in ("configs", "traffic", "limits"):
        (tmp / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(spec.BENCH_DIR / "metrics", tmp / "metrics", dirs_exist_ok=True)
    for c in bench["configs"]:
        (tmp / "configs" / f"{c['name']}.json").write_text(json.dumps(tiny_config(c["name"])))
    for w in bench["workloads"]:
        traffic = spec.load_json(spec.BENCH_DIR / "traffic" / f"{w['traffic']}.json")
        traffic.update(TINY_TRAFFIC)
        (tmp / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(traffic))
        lim = spec.load_json(spec.BENCH_DIR / "limits" / f"{w['name']}.json")
        if limits is not None:
            lim["limits"] = dict(limits)
        (tmp / "limits" / f"{w['name']}.json").write_text(json.dumps(lim))
    return tmp, bench
