"""Released weights: download and one-time conversion to a native run
directory (port of ``diffdock_tpu/utils/download.py``).

When ``--model_dir`` does not exist, the reference ``inference.py``
downloads ``diffdock_models.zip`` from the repository's release page,
trying the URLs in order, swallowing per-URL failures and raising only when
every URL failed; :func:`ensure_downloaded` does the same, with the opener
injectable. A downloaded directory is in the reference format (torch
``.pt`` weights plus a flat reference-args ``model_parameters.yml``);
:func:`prepare_model_dir` converts the requested weights once, through
:mod:`diffdock_tpu_torch.cli.import_weights`, into a ``tpu_native*``
subdirectory with a ``SOURCE`` provenance record, under the JAX package's
names. The run-directory format is shared with the JAX package, so a
subdirectory that either package converted is read by the other, and a
``SOURCE`` that does not match the request raises in both.
"""

from __future__ import annotations

import io
import os
import zipfile
from typing import Callable, List, Optional, Sequence

# reference inference.py:50-54
REPOSITORY_URL = "https://github.com/gcorso/DiffDock"
REMOTE_URLS = (
    f"{REPOSITORY_URL}/releases/latest/download/diffdock_models.zip",
    f"{REPOSITORY_URL}/releases/download/v1.1/diffdock_models.zip",
)

# reference inference.py:84 / workdir layout: the released zip extracts
# score + confidence run dirs with this default weights file name
DEFAULT_CKPT = "best_ema_inference_epoch_model.pt"

NATIVE_SUBDIR = "tpu_native"


def _default_opener(url: str, timeout: float):
    from urllib.request import urlopen

    return urlopen(url, timeout=timeout)


def download_and_extract(
    remote_url: str,
    local_dir: str,
    opener: Optional[Callable] = None,
    timeout: float = 60.0,
) -> List[str]:
    """Fetch a zip from ``remote_url`` and extract it under ``local_dir``;
    returns the archive's file list (reference ``utils/download.py:8-14``)."""
    opener = opener or _default_opener
    resp = opener(remote_url, timeout)
    payload = resp.read()
    os.makedirs(local_dir, exist_ok=True)
    with zipfile.ZipFile(io.BytesIO(payload)) as zf:
        names = zf.namelist()
        zf.extractall(local_dir)
    return names


def ensure_downloaded(
    model_dir: str,
    remote_urls: Optional[Sequence[str]] = None,
    opener: Optional[Callable] = None,
    timeout: float = 60.0,
) -> List[str]:
    """If ``model_dir`` exists, do nothing (returns []). Otherwise try each
    URL in order, extracting into the PARENT of ``model_dir`` (the released
    zip contains the run dirs themselves — reference ``inference.py:132``),
    and return the extracted file list. Raises ``RuntimeError`` listing the
    attempted URLs when every download failed (``inference.py:141-143``)."""
    if os.path.exists(model_dir):
        return []
    urls = list(remote_urls if remote_urls is not None else REMOTE_URLS)
    parent = os.path.dirname(os.path.abspath(model_dir))
    errors = []
    for url in urls:
        try:
            files = download_and_extract(url, parent, opener, timeout)
        except Exception as e:  # per-URL failures only log, like the ref
            errors.append(f"{url}: {type(e).__name__}: {e}")
            continue
        if files:
            return files
        errors.append(f"{url}: empty archive")
    raise RuntimeError(
        f"models not found locally at {model_dir} and failed to download "
        f"them: {errors}"
    )


def is_reference_format(model_dir: str) -> bool:
    """True when ``model_dir`` holds a reference run (torch ``.pt`` weights;
    its ``model_parameters.yml`` is a flat reference-args dump), False for a
    native dir (msgpack weights; the yml nests everything under ``model:``,
    ``train/checkpoints.py``)."""
    if not os.path.isdir(model_dir):
        return False  # let load_checkpoint raise its usual error
    yml = os.path.join(model_dir, "model_parameters.yml")
    has_pt = any(f.endswith(".pt") for f in os.listdir(model_dir))
    if not os.path.exists(yml):
        return has_pt
    from diffdock_tpu_torch.utils import simple_yaml

    with open(yml) as f:
        meta = simple_yaml.load(f.read()) or {}
    return not (isinstance(meta, dict) and "model" in meta) and has_pt


def prepare_model_dir(
    model_dir: str,
    ckpt: Optional[str] = None,
    confidence_mode: bool = False,
    old: bool = False,
) -> str:
    """Return a dir loadable by ``train.checkpoints.load_checkpoint``.

    Native dirs pass through unchanged. A reference-format dir (e.g. one
    just downloaded by :func:`ensure_downloaded`) is converted once into
    ``<model_dir>/tpu_native/`` via the torch importer and that subdir is
    returned; the conversion is cached on disk, so subsequent runs skip it.
    """
    if not is_reference_format(model_dir):
        return model_dir
    # The conversion cache is keyed by (checkpoint file, importer flags):
    # a different --ckpt (or architecture flag) converts into a different
    # subdir, so a cached default conversion is never silently served for
    # a non-default request.
    import re

    ckpt_name = ckpt or DEFAULT_CKPT
    sub = NATIVE_SUBDIR
    if ckpt_name != DEFAULT_CKPT:
        stem = re.sub(r"[^A-Za-z0-9_.-]", "_", os.path.splitext(ckpt_name)[0])
        sub += f"_{stem}"
    if confidence_mode:
        sub += "_conf"
    if old:
        sub += "_old"
    native = os.path.join(model_dir, sub)
    from diffdock_tpu_torch.train.checkpoints import WEIGHTS_FILE

    source = f"{ckpt_name} confidence={confidence_mode} old={old}\n"
    source_file = os.path.join(native, "SOURCE")
    if os.path.exists(os.path.join(native, WEIGHTS_FILE)):
        if not os.path.exists(source_file):
            # A legacy (pre-keying) cache carries no provenance: stamping
            # it with the CURRENT request's flags could mislabel a cache
            # originally converted with different flags and silently
            # serve the wrong weights later. Treat it as unverifiable:
            # warn and reconvert from the checkpoint.
            import warnings

            warnings.warn(
                f"{native} has no SOURCE provenance record (created by an "
                f"older version); reconverting from {ckpt_name} to "
                f"guarantee the cached weights match this request",
                RuntimeWarning,
            )
            import shutil

            shutil.rmtree(native)
        else:
            with open(source_file) as f:
                recorded = f.read()
            if recorded != source:
                raise RuntimeError(
                    f"{native} was converted from a different source "
                    f"({recorded.strip()!r}); delete it to reconvert as "
                    f"{source.strip()!r}"
                )
            return native

    from diffdock_tpu_torch.cli.import_weights import main as import_main

    torch_ckpt = os.path.join(model_dir, ckpt_name)
    argv = ["--torch_checkpoint", torch_ckpt, "--out_dir", native]
    if confidence_mode:
        argv.append("--confidence_mode")
    if old:
        argv.append("--old")
    rc = import_main(argv)
    if rc != 0:
        raise RuntimeError(f"weight import failed for {torch_ckpt}")
    with open(source_file, "w") as f:
        f.write(source)
    return native
