"""The search cells' rig: the served int8 path behind ``serving.serve`` on
port 0, an index made on the card from the seed, the window driven from
the load generator's process (``_client.py``), and the check of every
answer against the plain reference.

The index: ``index_rows`` seeded unit rows of the descriptor's width, of
which one per database view (``data/uploads/db_XX.jpg``, the query
places seen from nearby) is replaced by the program's descriptor of that
view, at seeded rows, so that K2's running lists meet real near
neighbours. The reference does not trust those rows: it reads the index
as stored and works every distance out from its own query descriptors."""

from __future__ import annotations

import json
import subprocess
import sys
import threading
from contextlib import nullcontext
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

from benchmarks.harness import SpanLog, TimingLock
from benchmarks.metrics._trace import DeviceProfiler

ROOT = Path(__file__).resolve().parents[1]
REPO = ROOT.parent


class Uploads:
    """The upload pool of a configuration (``uploads``: a directory under
    the benchmark's folder): ``uploads/q_XX.*`` and ``uploads/db_XX.*``
    and ``query_pixels.npz``, the queries' pixels as OpenCV decodes them."""

    def __init__(self, config: dict):
        self.dir = ROOT / config.get("uploads", "data")
        self.ext = config.get("upload_ext", "jpg")
        with np.load(self.dir / "query_pixels.npz") as f:
            self.pixels = f["pixels"]
        self.pool = len(self.pixels)

    def names(self, kind: str = "q") -> List[str]:
        return [f"{kind}_{i:02d}.{self.ext}" for i in range(self.pool)]

    def read(self, name: str) -> bytes:
        with open(self.dir / "uploads" / name, "rb") as f:
            return f.read()


class SearchRig:
    """Set-up of a search cell; ``window`` runs the measured window and
    ``check`` judges its answers."""

    def __init__(self, cell, images_per_request: int, k: int):
        import torch

        from benchmarks.weights import make_params
        from soft_contrastive_learning_torch import serving
        from soft_contrastive_learning_torch.core.config import ModelConfig
        from soft_contrastive_learning_torch.models.quant import calibrate_scales

        cfg = cell.config
        self.cell = cell
        self.device = cell.device
        self.k = k
        self.images_per_request = images_per_request
        self.spans = SpanLog()
        self.embed_self_s = 0.0
        self._embed_lock = threading.Lock()
        self._local = threading.local()
        model_cfg = ModelConfig(**cfg["model"])
        self.params = make_params(cell.seed, self.device, model_cfg.vlad_cores)
        self.uploads = Uploads(cfg)
        self.pixels = self.uploads.pixels
        self.calib = torch.from_numpy(self.pixels[: cfg["calibration_images"]]).to(self.device)
        scales = calibrate_scales(self.params, self.calib, self.device)
        self.service = serving.DescriptorService(
            model_cfg, self.params, batch_size=cfg["batch_size"], device=self.device,
            quant_scales=scales)
        self.index = self._index(cfg["index_rows"], model_cfg.descriptor_dim)
        self.service.index = self.index
        if cell.trace:
            self.lock = TimingLock(self.spans)
            self.service._lock = self.lock
            self.service.decode_batch = self.spans.wrap("decode", self.service.decode_batch)
            self.service.embed = self.spans.wrap("embed", self.service.embed,
                                                 on_done=self._embed_done)
        self.server = serving.serve(self.service, host="127.0.0.1", port=0)
        # the backlog a deployment gives a server that many clients connect to at once
        self.server.socket.listen(256)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        self._warm_up()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def _embed_done(self, t0: int, t1: int) -> None:
        """The embed's own time: its host span less its wait for the lock
        (this thread's waits since its last embed)."""
        seen = getattr(self._local, "seen", 0)
        self._local.seen = self.lock.thread_wait_ns()
        with self._embed_lock:
            self.embed_self_s += (t1 - t0 - (self._local.seen - seen)) / 1e9

    def _index(self, rows: int, dim: int):
        """Seeded unit rows, made on the card block by block, with the
        program's descriptors of the database views at seeded rows."""
        import torch

        gen = torch.Generator(device=self.device).manual_seed(self.cell.seed + 1)
        index = torch.empty((rows, dim), dtype=torch.float32, device=self.device)
        for s in range(0, rows, 16384):
            block = torch.randn((min(16384, rows - s), dim), generator=gen, device=self.device)
            index[s : s + len(block)] = block / block.norm(dim=1, keepdim=True)
        views = [self.uploads.read(n) for n in self.uploads.names("db")]
        desc = np.concatenate([self.service.embed(self.service.decode_batch(views[s : s + 16]))
                               for s in range(0, len(views), 16)])
        at = np.random.default_rng(self.cell.seed).choice(rows, size=len(views), replace=False)
        index[torch.as_tensor(at, device=self.device)] = torch.from_numpy(desc).to(self.device)
        return index

    def _warm_up(self) -> None:
        """Three requests of the cell's own shape, through the server."""
        import base64
        import http.client

        uploads = [base64.b64encode(self.uploads.read(n)).decode() for n in self.uploads.names()]
        for r in range(3):
            body = json.dumps({"images_b64": uploads[r : r + self.images_per_request],
                               "k": self.k}).encode()
            conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=300)
            conn.request("POST", "/search", body=body)
            resp = conn.getresponse()
            payload = resp.read()
            conn.close()
            if resp.status != 200:
                raise RuntimeError(f"warm-up request failed: {resp.status} {payload[:300]!r}")

    def window(self, spec: dict):
        """Start the load generator, wait for it to be ready, open the
        window (under the profiler on a traced run), and return (the
        window's wall-clock start, the requests' rows, the DeviceTrace or
        None)."""
        spec = dict(spec, port=self.port, uploads=str(self.uploads.dir / "uploads"),
                    names=self.uploads.names(), seconds=self.cell.seconds)
        grace = float(spec.get("grace_s", 60.0))
        proc = subprocess.Popen([sys.executable, "-m", "benchmarks.traffic._client"],
                                cwd=str(REPO), stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                text=True)
        try:
            proc.stdin.write(json.dumps(spec) + "\n")
            proc.stdin.flush()
            if proc.stdout.readline().strip() != "READY":
                raise RuntimeError("the load generator did not start")
            prof = DeviceProfiler() if self.cell.trace and self.device.type == "cuda" \
                else nullcontext()
            self.spans.spans.clear()  # the warm-up's
            self.embed_self_s = 0.0
            with prof:
                proc.stdin.write("GO\n")
                proc.stdin.flush()
                out, _ = proc.communicate(timeout=self.cell.seconds + grace + 120)
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
        if proc.returncode != 0:
            raise RuntimeError(f"the load generator exited with {proc.returncode}")
        res = json.loads(out.strip().splitlines()[-1])
        return res["t0_wall"], res["results"], getattr(prof, "trace", None)

    def close_program(self) -> int:
        """Read the peak, stop the server and free the program's state; the
        index (the benchmark's own input) stays for the reference."""
        import gc

        import torch

        peak = (int(torch.cuda.max_memory_allocated(self.device))
                if self.device.type == "cuda" else 0)
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=30)
        self.service.extractor.close()
        self.service = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return peak

    def reference_descriptors(self, levels: int = 127):
        """The plain reference's descriptor of every query upload (float64,
        on the card): its own scales from the calibration pixels, its own
        quantized weights, exact integer sums."""
        import torch

        from benchmarks.reference.model import calibrate, descriptor_int

        scales = calibrate(self.params, self.calib, levels)
        px = torch.from_numpy(self.pixels).to(self.device)
        compute = getattr(torch, self.cell.config["model"]["compute_dtype"])
        return torch.cat([descriptor_int(self.params, scales, px[s : s + 8], levels, compute)
                          for s in range(0, len(px), 8)])

    def judge(self, rows: Sequence, queries, ids_of) -> Tuple[float, float, int]:
        """(dist_gap, rank_gap, malformed) of the answered requests ``rows``
        (``[.., indices, distances]``), request r asking for the images
        ``ids_of(r)``, against ``queries`` (the reference's descriptors of
        the pool)."""
        from benchmarks.reference.search import answer_gaps, exact_topk, row_distances

        kmax = max(len(r[4][0]) for r in rows) if rows else 1
        top_d, _ = exact_topk(queries, self.index, kmax)
        cache: Dict[tuple, np.ndarray] = {}
        dist_gap = rank_gap = 0.0
        malformed = 0
        for r in rows:
            ids = ids_of(r)
            served_i, served_d = np.asarray(r[4]), np.asarray(r[5], dtype=np.float64)
            if served_i.shape != (len(ids), self.k) or served_d.shape != served_i.shape \
                    or served_i.min() < 0 or served_i.max() >= len(self.index):
                malformed += 1
                continue
            for j, img in enumerate(ids):
                key = (img, tuple(served_i[j]))
                if key not in cache:
                    cache[key] = row_distances(queries[img : img + 1], self.index,
                                               served_i[j : j + 1])[0]
                dg, rg = answer_gaps(served_d[j : j + 1], served_i[j : j + 1], cache[key][None],
                                     top_d[img : img + 1, : self.k])
                dist_gap, rank_gap = max(dist_gap, dg), max(rank_gap, rg)
        return dist_gap, rank_gap, malformed


def control_readings(cell, images_per_request: int, k: int) -> dict:
    """One seed's control readings at the cell's size, against the int8
    reference: the reference through int4 put in the program's place (its
    answers the exact top-k of its int4 descriptors), and, beside it, the
    int8 reference's descriptors searched with TF32 products (a K2 that
    gave up its 3xTF32 split)."""
    import torch

    from benchmarks.reference.search import answer_gaps, exact_topk, row_distances

    rig = SearchRig(cell, images_per_request, k)
    rig.close_program()
    q8 = rig.reference_descriptors(127)
    top_d, _ = exact_topk(q8, rig.index, k)
    out = {}
    d4, i4 = exact_topk(rig.reference_descriptors(7), rig.index, k)
    out["control_int4"] = answer_gaps(d4, i4, row_distances(q8, rig.index, i4), top_d)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        q = q8.float()
        best = []
        for s in range(0, len(rig.index), 16384):
            r = rig.index[s : s + 16384]
            sq = (q * q).sum(1, keepdim=True) + (r * r).sum(1)[None] - 2.0 * (q @ r.T)
            top = torch.topk(sq, k, dim=1, largest=False)
            best.append((top.values, top.indices + s))
        vals = torch.cat([b[0] for b in best], 1)
        ids = torch.cat([b[1] for b in best], 1)
        top = torch.topk(vals, k, dim=1, largest=False)
        dt = top.values.clamp(min=0).sqrt().double().cpu().numpy()
        it = torch.gather(ids, 1, top.indices).cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    out["control_tf32_search"] = answer_gaps(dt, it, row_distances(q8, rig.index, it), top_d)
    return {name: {"dist_gap": v[0], "rank_gap": v[1]} for name, v in out.items()}
