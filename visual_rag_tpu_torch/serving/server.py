"""HTTP search service with dynamic batching onto the port's engine.

Port of ``visual_rag_tpu/serving/server.py`` (``DynamicBatcher`` :86,
``SearchServer`` :251) for precomputed query embeddings. That module loads
no jax, and it drives any engine that has ``search_embedded_batch`` and
``index.manifest`` -- the port's engine included, which the tests check. The
port keeps this copy so that a program on the card can serve without
importing the JAX package. Differences: no ``query`` text (the port has no
embedder yet), no ``embedding_b64`` wire, and the batcher runs each batch
synchronously instead of overlapping one batch's device work with the next
one's collection (later performance work).

  POST /search   {"embedding": [[...dim floats...], ...], "mode": "two_stage",
                  "top_k": 10, "prefetch_k": 200}
  GET  /healthz  liveness + corpus size
  GET  /stats    request/batch counters
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np

logger = logging.getLogger(__name__)

SEARCH_OPTIONS = ("mode", "top_k", "prefetch_k", "stage1_mode", "stage1_k", "stage2_k")


@dataclass
class _Pending:
    embedding: np.ndarray
    options: Dict[str, Any]
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[List[Dict[str, Any]]] = None
    error: Optional[str] = None


def decode_embedding_request(req: Dict[str, Any]) -> np.ndarray:
    if "embedding" not in req:
        raise ValueError("request needs 'embedding': [[...dim floats...], ...]")
    emb = np.asarray(req["embedding"], dtype=np.float32)
    if emb.ndim != 2:
        raise ValueError(f"embedding must be [n_tokens, dim], got shape {emb.shape}")
    return emb


class DynamicBatcher:
    """Coalesces concurrent search requests into engine batches.

    The worker drains what has queued (at most ``max_batch``), waiting at
    most ``max_wait_ms`` after the first request for stragglers. Requests
    share a batch only when their search options match.
    """

    def __init__(self, engine, max_batch: int = 256, max_wait_ms: float = 5.0):
        self.engine = engine
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait_ms) / 1e3
        self._q: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        self.stats = {"requests": 0, "batches": 0, "max_batch_seen": 0}
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, embedding: np.ndarray, options: Dict[str, Any],
               timeout: float = 30.0) -> List[Dict[str, Any]]:
        p = _Pending(embedding=embedding, options=options)
        self._q.put(p)
        if not p.done.wait(timeout):
            raise TimeoutError("search timed out in batcher")
        if p.error is not None:
            raise RuntimeError(p.error)
        return p.result  # type: ignore[return-value]

    def close(self):
        self._q.put(None)
        self._worker.join(timeout=5)

    def _drain(self, first: _Pending) -> List[Optional[_Pending]]:
        batch = [first]
        deadline = time.monotonic() + self.max_wait
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            batch.append(item)
            if item is None:
                break
        return batch

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            batch = self._drain(item)
            stop = batch[-1] is None
            batch = [p for p in batch if p is not None]
            self.stats["requests"] += len(batch)
            self.stats["batches"] += 1
            self.stats["max_batch_seen"] = max(self.stats["max_batch_seen"], len(batch))
            groups: Dict[str, List[_Pending]] = {}
            for p in batch:
                groups.setdefault(json.dumps(p.options, sort_keys=True), []).append(p)
            for group in groups.values():
                self._run_group(group)
            if stop:
                return

    def _run_group(self, group: List[_Pending]):
        try:
            results = self.engine.search_embedded_batch(
                [p.embedding for p in group], **group[0].options)
            for p, r in zip(group, results):
                p.result = r
        except Exception as ex:  # boundary: report to every waiting request
            logger.exception("batch search failed")
            for p in group:
                p.error = f"{type(ex).__name__}: {ex}"
        finally:
            for p in group:
                p.done.set()


class SearchServer:
    """Threaded HTTP server over a RetrievalEngine."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 max_batch: int = 256, max_wait_ms: float = 5.0):
        self.engine = engine
        self.batcher = DynamicBatcher(engine, max_batch=max_batch, max_wait_ms=max_wait_ms)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"  # keep-alive; every response has a length
            disable_nagle_algorithm = True  # small request/response pairs

            def log_message(self, *a):
                logger.debug("http: " + a[0], *a[1:])

            def _send(self, code: int, payload: Dict[str, Any]):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, {"status": "ok",
                                     "num_docs": len(outer.engine.index.manifest)})
                elif self.path == "/stats":
                    self._send(200, dict(outer.batcher.stats))
                else:
                    self._send(404, {"error": f"unknown path {self.path}"})

            def do_POST(self):
                if self.path != "/search":
                    self._send(404, {"error": f"unknown path {self.path}"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    emb = decode_embedding_request(req)
                except (ValueError, TypeError) as ex:
                    self._send(400, {"error": str(ex)})
                    return
                opts = {k: req[k] for k in SEARCH_OPTIONS if k in req}
                try:
                    results = outer.batcher.submit(emb, opts)
                except (TimeoutError, RuntimeError) as ex:
                    self._send(500, {"error": str(ex)})
                    return
                self._send(200, {"results": results})

        class Server(ThreadingHTTPServer):
            request_queue_size = 128  # bursts of concurrent clients
            daemon_threads = True

        self._httpd = Server((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)

    def start(self) -> "SearchServer":
        self._thread.start()
        logger.info("search server on http://%s:%d", self.host, self.port)
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self.batcher.close()
        self._thread.join(timeout=5)
