"""Web UI for docking jobs (port of ``diffdock_tpu/app/server.py``).

A stdlib ``http.server`` app that runs the docking pipeline in-process: one
pipeline, built at the first job through the dock CLI's ``load_pipeline``
and reused for every job (the kernels are built and the tables loaded
once), one worker thread that docks the queued jobs in turn, job status
polling and SDF downloads. The 3D viewer of the reference's Gradio app is
not served; the results are the ranked SDF files.

Routes: ``/`` (the form and the job table), ``POST /submit`` (multipart: a
protein file or server path and a ligand file or server path; 400 without
both), ``/status/<id>`` (JSON), ``/results/<id>`` (the file list) and
``/results/<id>/<file>``. A job's status JSON also gives ``queue_s``
(seconds from submission to the worker's start) and, once docked,
``timings``: its dock's record (``DockingResult.timings``) as host
seconds per phase (``featurize``, ``prep``, ``steps``, ``confidence``,
``write``) and the record's counts.

Run::

    python -m diffdock_tpu_torch.app.server --port 7860 --model_dir runs/score \\
        --confidence_model_dir runs/confidence [--device cpu]

``--compute_dtype`` defaults to ``bfloat16`` and ``--device`` to ``cuda``.
"""

from __future__ import annotations

import argparse
import dataclasses
import html
import json
import os
import queue
import threading
import time
import traceback
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

_PAGE = """<!doctype html>
<html><head><title>diffdock-tpu-torch</title>
<style>
 body {{ font-family: sans-serif; max-width: 780px; margin: 2em auto; }}
 fieldset {{ margin-bottom: 1em; }} label {{ display:block; margin:.4em 0; }}
 table {{ border-collapse: collapse; }} td,th {{ border:1px solid #ccc; padding:.3em .6em; }}
</style></head><body>
<h1>diffdock-tpu-torch</h1>
<p>Generative molecular docking on a GPU. Submit a protein and a ligand;
poses are sampled with reverse diffusion and ranked by confidence.</p>
<form method="post" action="/submit" enctype="multipart/form-data">
<fieldset><legend>Protein</legend>
 <label>PDB file <input type="file" name="protein_file"></label>
 <label>or server path <input type="text" name="protein_path" size="60"></label>
</fieldset>
<fieldset><legend>Ligand</legend>
 <label>SDF/MOL/PDB file <input type="file" name="ligand_file"></label>
 <label>or server path <input type="text" name="ligand" size="60"></label>
</fieldset>
<fieldset><legend>Sampling</legend>
 <label>poses <input type="number" name="samples" value="10" min="1" max="100"></label>
 <label>steps <input type="number" name="steps" value="20" min="2" max="40"></label>
</fieldset>
<button type="submit">Dock</button>
</form>
<h2>Jobs</h2>
<table><tr><th>id</th><th>status</th><th>runtime</th><th>results</th></tr>
{jobs}
</table>
</body></html>
"""


class Job:
    def __init__(self, job_id: str, params: Dict):
        self.id = job_id
        self.params = params
        self.status = "queued"
        self.error: Optional[str] = None
        self.t_submit = time.time()
        self.t_start: Optional[float] = None  # the worker's start
        self.t_done: Optional[float] = None
        self.result_dir: Optional[str] = None
        self.confidences = None
        self.timings: Optional[Dict] = None


class DockingService:
    """One pipeline, one worker thread, a job queue."""

    def __init__(self, args):
        self.args = args
        self.jobs: Dict[str, Job] = {}
        self.queue: "queue.Queue[Job]" = queue.Queue()
        self.pipeline = None
        self.worker = threading.Thread(target=self._run, daemon=True)
        self.worker.start()

    def _ensure_pipeline(self):
        if self.pipeline is None:
            from diffdock_tpu_torch.cli.dock import get_parser, load_pipeline

            cli_args = get_parser().parse_args([])
            cli_args.model_dir = self.args.model_dir
            cli_args.confidence_model_dir = self.args.confidence_model_dir
            cli_args.model_preset = self.args.model_preset
            cli_args.compute_dtype = self.args.compute_dtype
            cli_args.device = self.args.device
            self.pipeline = load_pipeline(cli_args)
        return self.pipeline

    def submit(self, params: Dict) -> Job:
        job = Job(uuid.uuid4().hex[:8], params)
        self.jobs[job.id] = job
        self.queue.put(job)
        return job

    def _run(self):
        while True:
            job = self.queue.get()
            job.t_start = time.time()
            job.status = "running"
            try:
                self._dock(job)
                job.status = "done"
            except Exception as e:  # noqa: BLE001 — the job fails, the server serves on
                job.status = "failed"
                job.error = f"{type(e).__name__}: {e}"
                traceback.print_exc()
            job.t_done = time.time()

    def _dock(self, job: Job):
        from diffdock_tpu_torch.data.inference_dataset import InferenceDatasetBuilder, InferenceSpec

        p = job.params
        pipeline = self._ensure_pipeline()
        steps = int(p.get("steps", 20))
        pipeline.sampler_cfg = dataclasses.replace(
            pipeline.sampler_cfg, inference_steps=steps, actual_steps=max(steps - 1, 1))
        out_dir = os.path.join(self.args.out_dir, job.id)
        builder = InferenceDatasetBuilder(workdir=out_dir, device=self.args.device)
        mol, protein, lm = builder.load(InferenceSpec(job.id, p["protein_path"], None, p["ligand"]))
        result = pipeline.dock_mol_protein(mol, protein, out_dir, num_poses=int(p.get("samples", 10)),
                                           lm_embeddings=lm)
        job.result_dir = out_dir
        if result.confidence is not None:
            job.confidences = [float(result.confidence[i]) for i in result.order]
        job.timings = timings_json(result.timings)


# a dock record's phases in the status JSON -> the spans each sums
PHASES = {"featurize": ("featurize",), "prep": ("prep", "embed_receptor"), "steps": ("step",),
          "confidence": ("confidence", "rank"), "write": ("write",)}


def timings_json(rec) -> Dict:
    """A dock's record reduced for ``/status``: host seconds per phase
    (:data:`PHASES`) and the record's counts."""
    return {"seconds": {k: sum(rec.host_seconds(n) for n in names) for k, names in PHASES.items()},
            "counts": dict(rec.counts)}


def parse_multipart(handler) -> Dict:
    """Minimal multipart/form-data parsing: name -> ("text", None, value) or
    ("file", filename, bytes)."""
    import email
    import email.policy

    length = int(handler.headers.get("Content-Length", 0))
    body = handler.rfile.read(length)
    ctype = handler.headers.get("Content-Type", "")
    msg = email.message_from_bytes(
        b"Content-Type: " + ctype.encode() + b"\r\n\r\n" + body, policy=email.policy.HTTP)
    fields: Dict = {}
    if not msg.is_multipart():
        return fields
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        filename = part.get_param("filename", header="content-disposition")
        payload = part.get_payload(decode=True)
        if filename:
            fields[name] = ("file", filename, payload)
        else:
            fields[name] = ("text", None, (payload or b"").decode().strip())
    return fields


def make_handler(service: DockingService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, code, body, ctype="text/html"):
            data = body.encode() if isinstance(body, str) else body
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            parsed = urllib.parse.urlparse(self.path)
            if parsed.path == "/":
                rows = []
                for job in sorted(service.jobs.values(), key=lambda j: -j.t_submit):
                    dt = (job.t_done or time.time()) - job.t_submit
                    link = (f'<a href="/results/{job.id}">files</a>' if job.status == "done"
                            else html.escape(job.error or ""))
                    rows.append(f"<tr><td>{job.id}</td><td>{job.status}</td>"
                                f"<td>{dt:.0f}s</td><td>{link}</td></tr>")
                self._send(200, _PAGE.format(jobs="\n".join(rows)))
            elif parsed.path.startswith("/status/"):
                job = service.jobs.get(parsed.path.split("/")[-1])
                if not job:
                    return self._send(404, "{}", "application/json")
                self._send(200, json.dumps({
                    "id": job.id, "status": job.status, "error": job.error,
                    "confidences": job.confidences,
                    "queue_s": None if job.t_start is None else job.t_start - job.t_submit,
                    "timings": job.timings,
                }), "application/json")
            elif parsed.path.startswith("/results/"):
                parts = parsed.path.split("/")
                job = service.jobs.get(parts[2] if len(parts) > 2 else "")
                if not job or not job.result_dir:
                    return self._send(404, "not found")
                if len(parts) == 3:
                    items = "".join(f'<li><a href="/results/{job.id}/{f}">{f}</a></li>'
                                    for f in sorted(os.listdir(job.result_dir)))
                    self._send(200, f"<html><body><h1>{job.id}</h1><ul>{items}</ul></body></html>")
                else:
                    path = os.path.join(job.result_dir, os.path.basename(parts[3]))
                    if not os.path.isfile(path):
                        return self._send(404, "not found")
                    with open(path, "rb") as f:
                        self._send(200, f.read(), "chemical/x-mdl-sdfile")
            else:
                self._send(404, "not found")

        def do_POST(self):
            if self.path != "/submit":
                return self._send(404, "not found")
            fields = parse_multipart(self)
            updir = os.path.join(service.args.out_dir, "uploads")

            def text(name):
                v = fields.get(name)
                return v[2] if v and v[0] == "text" else ""

            def file_path(name):
                v = fields.get(name)
                if v and v[0] == "file" and v[2]:
                    os.makedirs(updir, exist_ok=True)
                    path = os.path.join(updir, f"{uuid.uuid4().hex[:8]}_{os.path.basename(v[1])}")
                    with open(path, "wb") as f:
                        f.write(v[2])
                    return path
                return None

            protein = file_path("protein_file") or text("protein_path")
            ligand = file_path("ligand_file") or text("ligand")
            if not protein or not ligand:
                return self._send(400, "need a protein and a ligand")
            service.submit({
                "protein_path": protein,
                "ligand": ligand,
                "samples": text("samples") or "10",
                "steps": text("steps") or "20",
            })
            self.send_response(303)
            self.send_header("Location", "/")
            self.send_header("Content-Length", "0")
            self.end_headers()

    return Handler


def get_parser():
    p = argparse.ArgumentParser(description="diffdock_tpu_torch web UI")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--out_dir", default="results/web")
    p.add_argument("--model_dir", default=None)
    p.add_argument("--confidence_model_dir", default=None)
    p.add_argument("--model_preset", default="diffdock_s")
    p.add_argument("--compute_dtype", default="bfloat16", choices=["float32", "bfloat16"],
                   help="the score model's conv-layer compute dtype")
    p.add_argument("--device", default="cuda", help="torch device to dock on ('cuda' or 'cpu')")
    return p


def make_server(args) -> ThreadingHTTPServer:
    """The server for parsed ``args``, not yet serving; its ``service``
    attribute holds the :class:`DockingService` (``--port 0`` takes a free
    port: see ``server_address``)."""
    os.makedirs(args.out_dir, exist_ok=True)
    service = DockingService(args)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(service))
    server.service = service
    return server


def main(argv=None):
    args = get_parser().parse_args(argv)
    server = make_server(args)
    host, port = server.server_address[:2]
    print(f"diffdock_tpu_torch web UI on http://{host}:{port}")
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
