"""Batch descriptor-serving endpoint, the counterpart of
``soft_contrastive_learning_tpu/serving.py`` with the same protocol.

Protocol (JSON unless noted):
  GET  /healthz            -> {"status": "ok", "backend": "cuda"|"cpu", "dim": D}
  POST /embed              -> body: PNG/JPEG bytes (Content-Type image/*)
                              resp: {"descriptor": [...]}
  POST /embed_batch        -> body: {"images_b64": ["...", ...]}
                              resp: {"descriptors": [[...], ...]}
  POST /search             -> body: {"images_b64": [...], "k": 5}
                              resp: {"indices": [[...]], "distances": [[...]]}
                              (requires an index loaded at startup)

``/embed`` returns the raw descriptor with ``reduction`` ``none`` and
``pca`` (``pca`` whitening is the top-N sweep's, downstream), and the
reduced output (FC, SPP) otherwise, as JAX's; ``dim`` says which.
Uploads are decoded by the port's own codecs (``utils/io.py::decode_imgs``,
no OpenCV) to the pixels JAX's ``cv2.imdecode`` gives, EXIF orientation
included: a JPEG on the service's device (on the card the compiled entropy
decoder and J1, ``ops/kernels/jpeg.py``: a request's JPEGs in one launch),
read as ``cv2.imdecode`` reads bytes (a truncated JPEG is refused, where
``cv2.imread`` of a file would read it), a PNG on the host; what they
refuse gets a 400 with the reason, before any launch. An upload of another size than the
model's is resized by ``utils/cv.py::resize_linear``, as JAX's by
``cv2.resize``. With ``quant_scales`` (a dict of ``models/quant.py`` scales, as
``cli quant`` writes them) the service embeds through the int8-PTQ stack
(Q1 on a CUDA device), on a card one CUDA graph replay a batch, captured
when the service is built (``evaluation/inference.py``). The index is copied to the device once. A search over more than
``STREAM_MIN_ROWS`` rows with k <= 128 streams the index through K2
(``ops/topk.py::topk_l2_streamed``); smaller ones take the dense path.
With a mesh the extractor splits each batch over the ranks and every rank
gets every descriptor (``evaluation/inference.py``); the index stays whole
on each rank's device and each rank searches it, as in JAX.

The service's ``timer`` (``core/logging.py::StepTimer``) spans each POST
under a request id of its own: ``serve.read`` (the body, the JSON parse
and the base64 decode), ``serve.decode`` (the whole of ``decode`` /
``decode_batch``), ``serve.lock_wait`` (each wait for the lock: the
embed's, then the search's), ``serve.embed`` (the lock held: the
extractor's work), ``serve.upload`` (the descriptors' way back to the
device, between the two), ``serve.search`` (the lock held: the search and
its download), ``serve.respond`` (the answer's ``tolist``, its JSON and
the write), and counts ``serve.requests`` once each is served (answered
200). The extractor's and the codecs' timers span their parts under the
same request id.
"""

from __future__ import annotations

import base64
import itertools
import json
import threading
from contextlib import contextmanager
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Mapping, Optional

import numpy as np
import torch

from soft_contrastive_learning_torch.core.config import (
    ModelConfig, indexed_device, resolve_device)
from soft_contrastive_learning_torch.core.logging import StepTimer, request_scope
from soft_contrastive_learning_torch.evaluation.inference import DescriptorExtractor
from soft_contrastive_learning_torch.ops.kernels.topk import MAX_K
from soft_contrastive_learning_torch.ops.topk import topk_l2, topk_l2_streamed
from soft_contrastive_learning_torch.utils.io import decode_img, decode_imgs

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
        # indexed: the HTTP handler threads' current device is cuda:0
        self.device = mesh.device if mesh is not None else indexed_device(resolve_device(device))
        self.timer = StepTimer()
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
        self.request_ids = itertools.count(1)

    @contextmanager
    def _held(self, span: str):
        """The lock held under ``span``; the wait for it a ``serve.lock_wait``."""
        with self.timer.span("serve.lock_wait"):
            self._lock.acquire()
        try:
            with self.timer.span(span):
                yield
        finally:
            self._lock.release()

    def decode(self, data: bytes) -> np.ndarray:
        """An upload's bytes -> (H, W, 3) RGB uint8, a JPEG decoded on the
        service's device as ``cv2.imdecode`` reads bytes: one that ends
        before its decode does is refused."""
        with self.timer.span("serve.decode"):
            return decode_img(data, "upload", self.device, source="buffer")

    def decode_batch(self, datas) -> list:
        """A request's uploads -> their images, decoded as ``decode`` decodes
        one, the JPEGs in one J1 launch; a refused upload raises, naming it
        (``upload <i>``), before any launch."""
        with self.timer.span("serve.decode"):
            return decode_imgs(datas, [f"upload {i}" for i in range(len(datas))], self.device,
                               source="buffer")

    def embed(self, images) -> np.ndarray:
        with self._held("serve.embed"):
            return self.extractor.extract_images(images)

    def search(self, images, k: int = 5):
        if self.index is None:
            raise ValueError("no retrieval index loaded")
        desc = self.embed(images)
        with self.timer.span("serve.upload"):
            q = torch.from_numpy(desc).to(self.device)
        n_rows = self.index.shape[0]
        k_eff = min(k, n_rows)
        with self._held("serve.search"):
            if n_rows > STREAM_MIN_ROWS and k_eff <= MAX_K:
                d, i = topk_l2_streamed(q, self.index, k_eff)
            else:
                d, i = topk_l2(q, self.index, k_eff)
            return d.cpu().numpy(), i.cpu().numpy()


def make_handler(service: DescriptorService):
    timer = service.timer

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict) -> None:
            """The answer, its arrays as lists, under ``serve.respond``."""
            with timer.span("serve.respond"):
                body = json.dumps({k: v.tolist() if isinstance(v, np.ndarray) else v
                                   for k, v in payload.items()}).encode()
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

        def _answer(self):
            """(status, payload) of this POST."""
            with timer.span("serve.read"):
                raw = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                if self.path in ("/embed_batch", "/search"):
                    req = json.loads(raw)
                    datas = [base64.b64decode(s) for s in req["images_b64"]]
            if self.path == "/embed":
                return 200, {"descriptor": service.embed([service.decode(raw)])[0]}
            if self.path == "/embed_batch":
                return 200, {"descriptors": service.embed(service.decode_batch(datas))}
            if self.path == "/search":
                d, i = service.search(service.decode_batch(datas), int(req.get("k", 5)))
                return 200, {"indices": i, "distances": d}
            return 404, {"error": "not found"}

        def do_POST(self):
            with request_scope(next(service.request_ids)):
                try:
                    code, payload = self._answer()
                except Exception as e:  # the server keeps running; the client gets the reason
                    code, payload = 400, {"error": str(e)}
                self._send(code, payload)
                if code == 200:
                    timer.count("serve.requests")

    return Handler


def serve(service: DescriptorService, host: str = "127.0.0.1", port: int = 8377):
    """Construct (but do not start) the HTTP server; callers run
    ``server.serve_forever()`` themselves."""
    return ThreadingHTTPServer((host, port), make_handler(service))
