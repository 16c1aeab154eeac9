"""HTTP inference server (the reference's cog `predict.py` deployment as a
self-contained stdlib server).

Counterpart of the JAX package's `serve/server.py`: a
`ThreadingHTTPServer` around `EmbodiedPredictor` (ref: cog's HTTP wrapper
around Detic/predict.py:30-97):

  GET  /healthz            -> {"status": "ok"}
  POST /predict            body {"image": [[...rgb u8...]],
                                 "proj_indices": optional [H,W] ints,
                                 "reset_memory": optional bool}
                           -> {"boxes": [[x1,y1,x2,y2]...], "scores": [...],
                               "classes": [...]}
  POST /set_vocabulary     body {"zs_weight": [[...]], "names": [...]}

A malformed request gets 400, an unknown path 404, a failure of the
predictor 500. The memory persists across /predict calls until
reset_memory; one lock serialises the requests on the predictor.

Run: python -m embodied_object_detection_tpu_torch.serve.server --port 8080
     [--weights model.pth] [--device cpu]
(`--weights`: a detectron2 .pth converted by `convert/torch_weights.py`,
which must match the model, or a checkpoint of the port.)
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

__all__ = ["make_server"]


def make_server(predictor, host: str = "127.0.0.1", port: int = 8080
                ) -> ThreadingHTTPServer:
    """Build (not start) the server; call .serve_forever(), in a thread
    for tests. `predictor` is EmbodiedPredictor-like: callable(image,
    proj_indices=None) -> Detections, reset_memory(), and
    set_vocabulary(zs_weight, names)."""
    lock = threading.Lock()     # one device stream: one request at a time

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _reply(self, code: int, payload: dict):
            blob = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok"})
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            replied = False

            def reply(code, payload):
                nonlocal replied
                self._reply(code, payload)
                replied = True

            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/predict":
                    image = np.asarray(body["image"], np.float32)
                    proj = body.get("proj_indices")
                    proj = None if proj is None else np.asarray(proj,
                                                                np.int32)
                    with lock:
                        if body.get("reset_memory"):
                            predictor.reset_memory()
                        dets = predictor(image, proj_indices=proj)
                    valid = np.asarray(dets.valid)
                    reply(200, {
                        "boxes": np.asarray(dets.boxes)[valid].tolist(),
                        "scores": np.asarray(dets.scores)[valid].tolist(),
                        "classes": np.asarray(dets.classes)[valid].tolist(),
                    })
                elif self.path == "/set_vocabulary":
                    zs = np.asarray(body["zs_weight"], np.float32)
                    with lock:
                        predictor.set_vocabulary(zs, body.get("names"))
                    reply(200, {"num_classes": int(zs.shape[1] - 1)})
                else:
                    reply(404, {"error": "not found"})
            except (KeyError, ValueError, TypeError) as e:
                if not replied:         # malformed request
                    self._reply(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:
                if not replied:         # never a second status line
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return ThreadingHTTPServer((host, port), Handler)


def main(argv: Optional[list] = None) -> int:  # pragma: no cover
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--weights", default="")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default; raises without a card) or "
                        "'cpu'")
    p.add_argument("--opts", nargs="*", default=[])
    args = p.parse_args(argv)

    from ..config import DetectorConfig, apply_opts
    from ..demo.predictor import EmbodiedPredictor
    from ..models.detector import build_detector, resolve_device
    from ..run import load_weights
    device = resolve_device(args.device)
    cfg = apply_opts(DetectorConfig(), args.opts)
    model = build_detector(cfg, seed=0, device=device)
    # a .pth's zs_weight buffer is the classifier it was trained against;
    # without one every class scores sigmoid(0) until /set_vocabulary
    zs_weight = load_weights(model, cfg, args.weights) if args.weights \
        else None
    if zs_weight is None:
        print("WARNING: no classifier loaded (no --weights, or the "
              "checkpoint has no zs_weight buffer); /predict scores "
              "nothing useful until a client posts /set_vocabulary")
    predictor = EmbodiedPredictor(cfg, model=model, zs_weight=zs_weight,
                                  device=device)
    server = make_server(predictor, args.host, args.port)
    print(f"serving on http://{args.host}:{args.port}")
    server.serve_forever()
    return 0


if __name__ == "__main__":  # pragma: no cover
    import sys
    sys.exit(main())
