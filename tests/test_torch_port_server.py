"""The port's web server (``diffdock_tpu_torch/app/server.py``) on the CPU.

One server in this process (``--device cpu``, a free port) over tiny
random-weight run directories (a score model at ns 8 and an old all-atom
confidence model), with small diffusion tables: the index renders, a job
on an e2e_synth complex (2 poses, 2 steps) is submitted, polled to
``done`` and its ``rank1.sdf`` fetched; a submit without a ligand gets 400.
Each test polls under its own deadline.
"""

import json
import threading
import time
import urllib.error
import urllib.request
import uuid
from pathlib import Path

import pytest
import torch

from diffdock_tpu_torch.app import server as server_mod
from diffdock_tpu_torch.diffusion.so3 import SO3Config, get_so3_tables
from diffdock_tpu_torch.diffusion.torus import TorusConfig, get_torus_tables
from diffdock_tpu_torch.inference import pipeline as pipeline_mod
from diffdock_tpu_torch.models.config import ScoreModelConfig
from diffdock_tpu_torch.models.factory import build_model
from diffdock_tpu_torch.train.checkpoints import save_checkpoint
from diffdock_tpu_torch.utils.convert import flax_from_model

REPO = Path(__file__).resolve().parent.parent
NAME = "syn001_l24r104"  # 24 ligand atoms, 104 residues
COMPLEX = REPO / "data" / "e2e_synth" / NAME
DEADLINE_S = 45.0


def _run_dir(root: Path, name: str, cfg: ScoreModelConfig, seed: int) -> str:
    model = build_model(cfg)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    save_checkpoint(str(root / name), flax_from_model(model), cfg)
    return str(root / name)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(base URL, service) of a running server; stopped afterwards."""
    mp = pytest.MonkeyPatch()
    ps = get_so3_tables(SO3Config(n_eps=64, x_n=256, l_max=512), "cpu")
    pt = get_torus_tables(TorusConfig(x_n=256, sigma_n=128, mc_samples=2000), "cpu")
    mp.setattr(pipeline_mod, "get_so3_tables", lambda device=None: ps)
    mp.setattr(pipeline_mod, "get_torus_tables", lambda device=None: pt)
    root = tmp_path_factory.mktemp("server")
    score = _run_dir(root, "score", ScoreModelConfig(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=1), 0)
    conf = _run_dir(root, "confidence", ScoreModelConfig(
        ns=8, nv=2, num_conv_layers=2, confidence_mode=True, old_architecture=True, all_atoms=True), 1)
    args = server_mod.get_parser().parse_args([
        "--port", "0", "--out_dir", str(root / "web"), "--model_dir", score,
        "--confidence_model_dir", conf, "--device", "cpu"])
    assert args.compute_dtype == "bfloat16" and server_mod.get_parser().parse_args([]).device == "cuda"
    server = server_mod.make_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address[:2]
    yield f"http://{host}:{port}", server.service
    server.shutdown()
    server.server_close()
    thread.join(10)
    mp.undo()


def _multipart(fields):
    boundary = uuid.uuid4().hex
    body = b""
    for name, value in fields.items():
        if isinstance(value, tuple):  # (filename, bytes)
            head = f'Content-Disposition: form-data; name="{name}"; filename="{value[0]}"\r\n' \
                   "Content-Type: application/octet-stream\r\n\r\n"
            data = value[1]
        else:
            head = f'Content-Disposition: form-data; name="{name}"\r\n\r\n'
            data = str(value).encode()
        body += f"--{boundary}\r\n".encode() + head.encode() + data + b"\r\n"
    body += f"--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


class _NoRedirect(urllib.request.HTTPRedirectHandler):
    def redirect_request(self, *a, **k):
        return None


def _post(url, fields):
    body, ctype = _multipart(fields)
    req = urllib.request.Request(url + "/submit", data=body, headers={"Content-Type": ctype})
    try:
        with urllib.request.build_opener(_NoRedirect).open(req, timeout=30) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read()


def test_index_renders_and_bad_submits_get_400(served):
    url, _ = served
    status, page = _get(url + "/")
    assert status == 200 and b"diffdock-tpu-torch" in page and b'action="/submit"' in page
    assert _post(url, {"protein_path": str(COMPLEX / f"{NAME}_protein_processed.pdb")}) == 400
    assert _post(url, {"ligand": str(COMPLEX / f"{NAME}_ligand.sdf")}) == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(url + "/status/nosuchjob")
    assert e.value.code == 404


def test_a_job_is_docked_and_its_rank1_sdf_served(served):
    url, service = served
    t0 = time.monotonic()
    known = set(service.jobs)
    lig = (COMPLEX / f"{NAME}_ligand.sdf").read_bytes()
    status = _post(url, {"protein_path": str(COMPLEX / f"{NAME}_protein_processed.pdb"),
                         "ligand_file": (f"{NAME}_ligand.sdf", lig), "samples": 2, "steps": 2})
    assert status == 303
    (job_id,) = set(service.jobs) - known
    while True:
        info = json.loads(_get(f"{url}/status/{job_id}")[1])
        if info["status"] in ("done", "failed") or time.monotonic() - t0 > DEADLINE_S:
            break
        time.sleep(0.2)
    assert info["status"] == "done", info
    assert len(info["confidences"]) == 2 and info["confidences"][0] >= info["confidences"][1]
    status, listing = _get(f"{url}/results/{job_id}")
    assert status == 200 and b"rank1.sdf" in listing
    status, sdf = _get(f"{url}/results/{job_id}/rank1.sdf")
    assert status == 200 and b"V2000" in sdf
    assert service.pipeline.score_cfg.compute_dtype == "bfloat16"
    assert time.monotonic() - t0 < DEADLINE_S
    status, page = _get(url + "/")
    assert job_id.encode() in page and b"done" in page


def test_status_gives_the_queue_wait_and_the_docks_record(served):
    """``/status`` reports the wait in the job queue and the dock's record
    as host seconds per phase and its counts."""
    url, service = served
    t0 = time.monotonic()
    known = set(service.jobs)
    status = _post(url, {"protein_path": str(COMPLEX / f"{NAME}_protein_processed.pdb"),
                         "ligand": str(COMPLEX / f"{NAME}_ligand.sdf"), "samples": 2, "steps": 3})
    assert status == 303
    (job_id,) = set(service.jobs) - known
    while True:
        info = json.loads(_get(f"{url}/status/{job_id}")[1])
        if info["status"] in ("done", "failed") or time.monotonic() - t0 > DEADLINE_S:
            break
        time.sleep(0.2)
    assert info["status"] == "done", info
    job = service.jobs[job_id]
    assert info["queue_s"] == pytest.approx(job.t_start - job.t_submit) and info["queue_s"] >= 0
    seconds, counts = info["timings"]["seconds"], info["timings"]["counts"]
    assert set(seconds) == {"featurize", "prep", "steps", "confidence", "write"}
    assert all(v > 0 for v in seconds.values()), seconds
    assert sum(seconds.values()) <= job.t_done - job.t_start
    # 3 steps of the schedule, of which 2 run, in one pose batch
    assert counts["score_forwards"] == 2 and counts["pose_batches"] == 1
    assert counts["confidence_chunks"] >= 1 and 0 < counts["pair_real"] <= counts["pair_slots"]
    assert time.monotonic() - t0 < DEADLINE_S
