"""REST front end over the Engine (nann_tpu/serving/server.py).

The exported model's request schema (inputs `comm_seq` [1, L*d] or [L, d]
and an optional int32 `level_topn`; output `top_k`) over JSON:

  POST /v1/models/nann:predict
    {"inputs": {"comm_seq": [[...]], "level_topn": [...]}}
  -> {"outputs": {"top_k": [[...]], "scores": [[...]]}}

  GET /v1/models/nann          -> model status
  POST /v1/models/nann:reload  -> hot swap from an export directory
    {"export_dir": "..."}

Standard library only (ThreadingHTTPServer) in front of the engine's
micro-batching dispatcher; concurrency and deadlines are the engine's.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from ..delivery.verify_export import load_serving_bundle
from .engine import Engine, RequestRejected

logger = logging.getLogger("nann_tpu_torch.server")


class NannServer:
    def __init__(self, engine: Engine, host: str = "127.0.0.1",
                 port: int = 8501):
        self.engine = engine
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _reply(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.startswith("/v1/models/"):
                    self._reply(200, {"model_version_status": [
                        {"state": "AVAILABLE"}]})
                else:
                    self._reply(404, {"error": "not found"})

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                try:
                    req = json.loads(self.rfile.read(length) or b"{}")
                except json.JSONDecodeError:
                    self._reply(400, {"error": "invalid json"})
                    return
                if self.path.endswith(":predict"):
                    self._predict(req)
                elif self.path.endswith(":reload"):
                    self._reload(req)
                else:
                    self._reply(404, {"error": "not found"})

            def _reload(self, req):
                export_dir = req.get("export_dir")
                if not export_dir:
                    self._reply(400, {"error": "export_dir required"})
                    return
                eng = outer.engine
                try:
                    # the bundle's own table type, on the engine's device
                    params, state, _mcfg, index = load_serving_bundle(
                        export_dir, eng.scfg, device=eng.device)
                    eng.swap_model(params, state, index)
                except Exception as e:  # noqa: BLE001
                    self._reply(500, {"error": str(e)})
                    return
                self._reply(200, {"status": "reloaded",
                                  "export_dir": export_dir})

            def _predict(self, req):
                try:
                    inputs = req["inputs"]
                    comm_seq = np.asarray(inputs["comm_seq"], np.float32)
                    mcfg = outer.engine.mcfg
                    L, d = mcfg.max_seq_length, mcfg.user_emb_dim
                    comm_seq = comm_seq.reshape(L, d)  # [1, L*d] or [L, d]
                    ltn = inputs.get("level_topn")
                    ltn = np.asarray(ltn, np.int32) if ltn is not None else None
                except (KeyError, ValueError) as e:
                    self._reply(400, {"error": f"bad inputs: {e}"})
                    return
                try:
                    items, scores = outer.engine.search_sync(comm_seq, ltn)
                except RequestRejected as e:
                    self._reply(429, {"error": str(e)})
                    return
                except Exception as e:  # noqa: BLE001
                    self._reply(500, {"error": str(e)})
                    return
                self._reply(200, {"outputs": {
                    "top_k": [items.tolist()],
                    "scores": [np.asarray(scores, np.float64).tolist()],
                }})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_port
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="nann-rest", daemon=True)
        self._thread.start()
        logger.info("serving on :%d", self.port)

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=2)
