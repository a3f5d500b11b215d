"""The kernel build's library names follow the sources and the headers they include.

``utils/build.py`` names each shared library after a hash of its sources;
the kernels share device code through headers in ``csrc/`` (``tp_mma.cuh``,
``factored_tp.cuh``), so an edited header must give a new library name, or
a stale library built from the old header would load.
"""

import shutil

from diffdock_tpu_torch.utils import build

KERNELS = {"fused_tp3": ("fused_tp3.cu",), "factored_tp2": ("factored_tp2.cu",),
           "factored_tp1": ("factored_tp1.cu",)}


def test_sources_include_their_headers():
    assert build.source_files(["fused_tp3.cu"]) == ["fused_tp3.cu", "tp_mma.cuh"]
    for gen in ("factored_tp2.cu", "factored_tp1.cu"):
        assert build.source_files([gen]) == [gen, "factored_tp.cuh", "tp_mma.cuh"]


def test_an_edited_header_changes_the_library_path(tmp_path, monkeypatch):
    for src in build.CSRC_DIR.iterdir():
        shutil.copy(src, tmp_path / src.name)
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    paths = lambda: {n: build.library_path(n, s) for n, s in KERNELS.items()}  # noqa: E731
    before = paths()
    assert paths() == before
    with open(tmp_path / "factored_tp.cuh", "a") as f:
        f.write("\n// edited\n")
    after = paths()
    assert after["fused_tp3"] == before["fused_tp3"]
    assert after["factored_tp2"] != before["factored_tp2"]
    assert after["factored_tp1"] != before["factored_tp1"]
    with open(tmp_path / "tp_mma.cuh", "a") as f:
        f.write("\n// edited\n")
    last = paths()
    assert all(last[n] != after[n] for n in KERNELS)
