"""gnina rescoring (port of ``diffdock_tpu/eval/gnina.py``; the reference's
``utils/gnina_utils.py:13-89``): write the pose, run a gnina binary, read
its CNNscore and minimized coordinates. On the host, and only where the
binary is on ``PATH``; the subprocess protocol is the JAX package's."""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np

from diffdock_tpu_torch.data.chem import Molecule, read_molecule_file, write_sdf


def gnina_available(binary: str = "gnina") -> bool:
    return shutil.which(binary) is not None


def gnina_score(
    mol: Molecule,
    pose,
    receptor_pdb: str,
    binary: str = "gnina",
    minimize: bool = True,
    timeout_s: float = 120.0,
) -> Optional[float]:
    """Returns CNNscore, or None if gnina is unavailable/fails."""
    if not gnina_available(binary):
        return None
    with tempfile.TemporaryDirectory() as td:
        pose_sdf = os.path.join(td, "pose.sdf")
        with open(pose_sdf, "w") as f:
            f.write(write_sdf(mol, pose))
        cmd = [binary, "--receptor", receptor_pdb, "--ligand", pose_sdf,
               "--score_only" if not minimize else "--minimize"]
        try:
            out = subprocess.run(
                cmd, capture_output=True, text=True, timeout=timeout_s,
                check=True,
            ).stdout
        except (subprocess.SubprocessError, OSError):
            return None
        for line in out.splitlines():
            if line.strip().startswith("CNNscore"):
                try:
                    return float(line.split()[-1])
                except ValueError:
                    return None
    return None


def read_gnina_score_sdf(sdf_path: str) -> float:
    """CNNscore SDF property written by gnina ``-o``
    (reference ``utils/gnina_utils.py:22-27``)."""
    with open(sdf_path) as f:
        matches = re.findall(r"> <CNNscore>\n(.*?)\n", f.read())
    return float(matches[0]) if matches else 0.0


def gnina_minimize_pose(
    mol: Molecule,
    pose: np.ndarray,
    receptor_pdb: str,
    binary: str = "gnina",
    full_dock: bool = False,
    autobox_add: float = 4.0,
    timeout_s: float = 600.0,
) -> Tuple[np.ndarray, Molecule, float]:
    """Energy-minimize (or fully re-dock) one predicted pose with gnina and
    return ``(heavy-atom coords, heavy-atom mol, CNNscore)``
    (reference ``utils/gnina_utils.py:40-89`` ``get_gnina_poses``).

    On any failure — binary missing, subprocess error, unparseable output —
    falls back to the input pose with score 0.0, exactly like the reference.
    """
    heavy = mol.remove_hs()
    if not gnina_available(binary):
        return np.asarray(pose), heavy, 0.0
    with tempfile.TemporaryDirectory() as td:
        pred_sdf = os.path.join(td, "pred.sdf")
        out_sdf = os.path.join(td, "gnina.sdf")
        with open(pred_sdf, "w") as f:
            f.write(write_sdf(mol, pose))
        if full_dock:
            cmd = [binary, "-r", receptor_pdb, "-l", pred_sdf,
                   "--autobox_ligand", pred_sdf, "-o", out_sdf,
                   "--no_gpu", "--autobox_add", str(autobox_add)]
        else:
            cmd = [binary, "--receptor", receptor_pdb, "--ligand", pred_sdf,
                   "--minimize", "-o", out_sdf]
        try:
            subprocess.run(cmd, capture_output=True, timeout=timeout_s,
                           check=True)
            gmol = read_molecule_file(out_sdf).remove_hs()
            score = read_gnina_score_sdf(out_sdf)
            return np.asarray(gmol.coords), gmol, score
        except Exception:  # noqa: BLE001 — reference-style fallback
            return np.asarray(pose), heavy, 0.0
