"""Batch descriptor-serving endpoint, the counterpart of
``soft_contrastive_learning_tpu/serving.py`` with the same protocol.

Protocol (JSON unless noted):
  GET  /healthz            -> {"status": "ok", "backend": "cuda"|"cpu", "dim": D}
  POST /embed              -> body: PNG bytes (Content-Type image/*)
                              resp: {"descriptor": [...]}
  POST /embed_batch        -> body: {"images_b64": ["...", ...]}
                              resp: {"descriptors": [[...], ...]}
  POST /search             -> body: {"images_b64": [...], "k": 5}
                              resp: {"indices": [[...]], "distances": [[...]]}
                              (requires an index loaded at startup)

``/embed`` returns the raw descriptor with ``reduction`` ``none`` and
``pca`` (``pca`` whitening is the top-N sweep's, downstream), and the
reduced output (FC, SPP) otherwise, as JAX's; ``dim`` says which.
Uploads are decoded by the port's PNG decoder (``utils/io.py::decode_img``,
no OpenCV); JPEG and the other formats it refuses get a 400 with its
reason. With ``quant_scales`` (a dict of ``models/quant.py`` scales, as
``cli quant`` writes them) the service embeds through the int8-PTQ stack
(Q1 on a CUDA device). The index is copied to the device once. A search over more than
``STREAM_MIN_ROWS`` rows with k <= 128 streams the index through K2
(``ops/topk.py::topk_l2_streamed``); smaller ones take the dense path.
With a mesh the extractor splits each batch over the ranks and every rank
gets every descriptor (``evaluation/inference.py``); the index stays whole
on each rank's device and each rank searches it, as in JAX.
"""

from __future__ import annotations

import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Mapping, Optional

import numpy as np
import torch

from soft_contrastive_learning_torch.core.config import ModelConfig, resolve_device
from soft_contrastive_learning_torch.evaluation.inference import DescriptorExtractor
from soft_contrastive_learning_torch.ops.kernels.topk import MAX_K
from soft_contrastive_learning_torch.ops.topk import topk_l2, topk_l2_streamed
from soft_contrastive_learning_torch.utils.io import decode_img

STREAM_MIN_ROWS = 65536  # as soft_contrastive_learning_tpu/serving.py:95


class DescriptorService:
    """Model + optional retrieval index behind a lock that keeps one request
    at a time on the device."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: Mapping[str, torch.Tensor],
        batch_size: int = 16,
        index=None,  # (R, D) descriptor index: numpy array or tensor
        device: str | torch.device = "cuda",
        quant_scales: Optional[Mapping[str, float]] = None,
        mesh=None,
    ):
        self.cfg = cfg
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.extractor = DescriptorExtractor(cfg, params, batch_size=batch_size,
                                             device=self.device,
                                             raw_descriptor=cfg.reduction in ("none", "pca"),
                                             quant_scales=quant_scales, mesh=mesh)
        self.index: Optional[torch.Tensor] = None
        if index is not None:
            self.index = torch.as_tensor(index, dtype=torch.float32, device=self.device)
        # the width /embed returns: the raw descriptor's or the reduced output's
        self.embed_dim = cfg.descriptor_dim if self.extractor.raw else cfg.output_dim
        self._lock = threading.Lock()

    def embed(self, images) -> np.ndarray:
        with self._lock:
            return self.extractor.extract_images(images)

    def search(self, images, k: int = 5):
        if self.index is None:
            raise ValueError("no retrieval index loaded")
        q = torch.from_numpy(self.embed(images)).to(self.device)
        n_rows = self.index.shape[0]
        k_eff = min(k, n_rows)
        with self._lock:
            if n_rows > STREAM_MIN_ROWS and k_eff <= MAX_K:
                d, i = topk_l2_streamed(q, self.index, k_eff)
            else:
                d, i = topk_l2(q, self.index, k_eff)
            return d.cpu().numpy(), i.cpu().numpy()


def make_handler(service: DescriptorService):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # quiet
            pass

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {
                    "status": "ok",
                    "backend": service.device.type,
                    "dim": service.embed_dim,
                })
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length)
                if self.path == "/embed":
                    desc = service.embed([decode_img(raw, "upload")])[0]
                    self._send(200, {"descriptor": desc.tolist()})
                elif self.path == "/embed_batch":
                    req = json.loads(raw)
                    imgs = [decode_img(base64.b64decode(s), "upload") for s in req["images_b64"]]
                    self._send(200, {"descriptors": service.embed(imgs).tolist()})
                elif self.path == "/search":
                    req = json.loads(raw)
                    imgs = [decode_img(base64.b64decode(s), "upload") for s in req["images_b64"]]
                    d, i = service.search(imgs, int(req.get("k", 5)))
                    self._send(200, {"indices": i.tolist(), "distances": d.tolist()})
                else:
                    self._send(404, {"error": "not found"})
            except Exception as e:  # the server keeps running; the client gets the reason
                self._send(400, {"error": str(e)})

    return Handler


def serve(service: DescriptorService, host: str = "127.0.0.1", port: int = 8377):
    """Construct (but do not start) the HTTP server; callers run
    ``server.serve_forever()`` themselves."""
    return ThreadingHTTPServer((host, port), make_handler(service))
