"""Slice 9 of the torch port, on the CPU: the HTTP server and the frame
step's export against the JAX package.

  * the server's routes, status codes and memory contract with a fake
    predictor (the cases of tests/test_serve_http.py)
  * the port's server around the port's `EmbodiedPredictor`, and the JAX
    package's server around its predictor, sent the same requests at the
    64x96 oracle miniature (one JAX model, its parameters carried over,
    the mask logits shifted by +2 in both so that few pasted pixels sit at
    0.5): equal counts and classes, scores within the frame tests'
    tolerances (rtol 1e-4 on a fresh memory, 1e-3 once the memory was
    written in another summation order), boxes within 5e-3 / 1e-2 px
  * the export round trip (`torch.export`, `.pt2`): on the CPU the loaded
    program equals the eager frame step bit for bit, launches the kernel
    wrappers' custom ops, and is within the frame tolerances (scores rtol
    1e-4, boxes 5e-3 px, memory rtol/atol 1e-3, counts equal) of the JAX
    package's exported StableHLO step on the same inputs
"""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodied_object_detection_tpu.demo.predictor import (
    EmbodiedPredictor as JaxPredictor)
from embodied_object_detection_tpu.models.detector import (
    EmbodiedDetector as JaxDetector)
from embodied_object_detection_tpu.serve import export as jexport
from embodied_object_detection_tpu.serve.server import (
    make_server as jax_make_server)
from embodied_object_detection_tpu.structures import (
    Detections as JaxDetections)

from embodied_object_detection_tpu_torch.convert.from_jax import (
    load_jax_params)
from embodied_object_detection_tpu_torch.demo.predictor import (
    EmbodiedPredictor)
from embodied_object_detection_tpu_torch.models.detector import (
    build_detector)
from embodied_object_detection_tpu_torch.serve import export as texport
from embodied_object_detection_tpu_torch.serve.server import make_server
from embodied_object_detection_tpu_torch.structures import Detections

from test_torch_frame import (_blocky_proj, _check_detections, _jax_config,
                              _port_config)
from test_torch_slice9 import _shift_mask_logits


class FakeDets:
    def __init__(self, n):
        self.boxes = np.tile([1.0, 2, 3, 4], (n, 1))
        self.scores = np.linspace(1, 0.5, n)
        self.classes = np.arange(n)
        self.valid = np.array([True] * (n - 1) + [False])


class FakePredictor:
    def __init__(self):
        self.calls = 0
        self.resets = 0
        self.zs = None

    def __call__(self, image, proj_indices=None):
        assert image.shape[-1] == 3
        self.calls += 1
        return FakeDets(3)

    def reset_memory(self):
        self.resets += 1

    def set_vocabulary(self, zs_weight, names=None):
        self.zs = zs_weight


class FailingPredictor(FakePredictor):
    def __call__(self, image, proj_indices=None):
        raise RuntimeError("kernel launch failed")


def _post(url, payload, timeout=60):
    req = urllib.request.Request(
        url, json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class _Serving:
    """A server in a thread, shut down and closed on exit."""

    def __init__(self, make, predictor):
        self.srv = make(predictor, port=0)
        self.base = f"http://127.0.0.1:{self.srv.server_address[1]}"

    def __enter__(self):
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()
        return self.base

    def __exit__(self, *exc):
        self.srv.shutdown()
        self.srv.server_close()


@pytest.fixture
def server():
    pred = FakePredictor()
    with _Serving(make_server, pred) as base:
        yield pred, base


def test_healthz_and_unknown_get(server):
    _, base = server
    with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
        assert json.loads(r.read()) == {"status": "ok"}
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(base + "/nope", timeout=10)
    assert e.value.code == 404


def test_predict_and_reset(server):
    pred, base = server
    img = np.zeros((4, 5, 3), np.uint8).tolist()
    code, out = _post(base + "/predict", {"image": img})
    assert code == 200
    assert len(out["boxes"]) == 2      # the invalid row is dropped
    assert out["classes"] == [0, 1]
    assert pred.calls == 1 and pred.resets == 0
    code, _ = _post(base + "/predict", {"image": img, "reset_memory": True})
    assert code == 200 and pred.resets == 1


def test_set_vocabulary(server):
    pred, base = server
    code, out = _post(base + "/set_vocabulary",
                      {"zs_weight": np.ones((8, 4)).tolist()})
    assert code == 200 and out["num_classes"] == 3
    assert pred.zs.shape == (8, 4)


def test_bad_request_is_400_and_failure_500(server):
    _, base = server
    code, out = _post(base + "/predict", {"no_image": 1})
    assert code == 400 and "KeyError" in out["error"]
    code, _ = _post(base + "/nope", {})
    assert code == 404
    with _Serving(make_server, FailingPredictor()) as failing:
        code, out = _post(failing + "/predict",
                          {"image": np.zeros((2, 2, 3)).tolist()})
    assert code == 500 and "kernel launch failed" in out["error"]


@pytest.fixture(scope="module")
def fx():
    cfg = _jax_config()
    h, w = cfg.input.height, cfg.input.width
    cells, d = cfg.memory.max_cells, cfg.memory.memory_dim
    model = JaxDetector(cfg)
    params = _shift_mask_logits(jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((h, w, 3)),
        jnp.zeros((cfg.roi.zs_weight_dim, cfg.roi.num_classes + 1)),
        jnp.zeros((cells, d)), jnp.zeros((cells,)),
        jnp.zeros((h, w), jnp.int32), jnp.zeros((h, w), bool)))
    pcfg = _port_config(cfg)
    port = build_detector(pcfg, seed=1, device="cpu")
    port.load_state_dict(load_jax_params(
        jax.tree_util.tree_map(np.asarray, params)))
    rng = np.random.RandomState(9)
    zs = rng.randn(cfg.roi.zs_weight_dim, cfg.roi.num_classes + 1)
    zs = zs.astype(np.float32)
    zs[:, -1] = 0.0
    zs[:, :-1] /= np.linalg.norm(zs[:, :-1], axis=0, keepdims=True)
    images = rng.randint(0, 255, (4, h, w, 3)).astype(np.uint8)
    projs = np.stack([_blocky_proj(rng, h, w, cells) for _ in range(4)])
    return dict(cfg=cfg, pcfg=pcfg, model=model, params=params, port=port,
                zs=zs, images=images, projs=projs)


def _reply_detections(out):
    n = len(out["scores"])
    return (np.asarray(out["boxes"], np.float32).reshape(n, 4),
            np.asarray(out["scores"], np.float32),
            np.asarray(out["classes"], np.int32), np.ones(n, bool))


def test_port_server_replies_vs_jax_server(fx):
    """The same requests through both packages' servers: 3 frames, a
    reset, a vocabulary swap, one more frame."""
    requests = [("/predict", dict(image=fx["images"][0].tolist(),
                                  proj_indices=fx["projs"][0].tolist())),
                ("/predict", dict(image=fx["images"][1].tolist(),
                                  proj_indices=fx["projs"][1].tolist())),
                ("/predict", dict(image=fx["images"][2].tolist(),
                                  proj_indices=fx["projs"][2].tolist(),
                                  reset_memory=True)),
                ("/set_vocabulary",
                 dict(zs_weight=np.roll(fx["zs"], 2, axis=1).tolist())),
                ("/predict", dict(image=fx["images"][3].tolist(),
                                  proj_indices=fx["projs"][3].tolist()))]
    fresh = {0, 2}
    replies = {}
    for name, make, pred in (
            ("port", make_server,
             EmbodiedPredictor(fx["pcfg"], model=fx["port"],
                               zs_weight=fx["zs"], device="cpu")),
            ("jax", jax_make_server,
             JaxPredictor(fx["cfg"], fx["params"], fx["zs"]))):
        with _Serving(make, pred) as base:
            replies[name] = [_post(base + path, body)
                             for path, body in requests]
    n_det = 0
    for i, ((cg, got), (cw, want)) in enumerate(zip(replies["port"],
                                                    replies["jax"])):
        assert cg == cw == 200, (i, got, want)
        if requests[i][0] != "/predict":
            assert got == want
            continue
        k = sum(p == "/predict" for p, _ in requests[:i])
        tol = ((1e-4, 1e-5), 5e-3) if k in fresh else ((1e-3, 1e-4), 1e-2)
        _check_detections(Detections(*map(torch.from_numpy,
                                          _reply_detections(got))),
                          JaxDetections(*_reply_detections(want)), *tol)
        n_det += len(got["scores"])
    assert n_det > 0, "no detection in any reply: weak fixture"


def _inputs(fx, t=0, memory=None):
    cfg = fx["pcfg"]
    h, w = cfg.input.height, cfg.input.width
    cells, d = cfg.memory.max_cells, cfg.memory.memory_dim
    memf, memo = memory if memory is not None else (
        np.zeros((cells, d), np.float32), np.zeros((cells,), np.float32))
    outl = np.zeros((h, w), bool)
    outl[-3:] = True
    return (fx["images"][t].astype(np.float32), fx["zs"], memf, memo,
            fx["projs"][t], outl)


def test_export_round_trip_vs_eager_and_jax(fx, tmp_path):
    from embodied_object_detection_tpu_torch.ops import segment_sum
    path = texport.save_frame_step(str(tmp_path / "frame_step.pt2"),
                                   fx["port"], fx["pcfg"])
    step = texport.load_frame_step(path)
    ops = {str(n.target) for n in
           torch.export.load(path).graph_module.graph.nodes
           if n.op == "call_function"}
    for op in ("eodt.nms_keep.default", "eodt.memory_read.default",
               "eodt.paste_masks_observed.default",
               "eodt.write_select.default", "eodt.segment_sum.default"):
        assert op in ops, op

    jstep = jexport.load_frame_step(jexport.export_frame_step(
        fx["model"], fx["params"], fx["cfg"], platforms=("cpu",)))
    memory = None
    for t in range(2):          # frame 1 reads what frame 0 wrote
        args = _inputs(fx, t, memory)
        targs = [torch.from_numpy(np.asarray(a)) for a in args]
        before = segment_sum.segment_sum.launches
        got = step(*targs)
        assert segment_sum.segment_sum.launches == before  # plain on a CPU
        out = fx["port"].frame_step(*targs)
        d = out.detections
        eager = (d.boxes, d.scores, d.classes, d.valid,
                 targs[2] + out.write.features_update,
                 targs[3] + out.write.obs_update)
        for g, e in zip(got, eager):
            assert g.dtype == e.dtype and torch.equal(g, e)
        want = [np.asarray(x) for x in jstep(*map(jnp.asarray, args))]
        tol = ((1e-4, 1e-5), 5e-3) if t == 0 else ((1e-3, 1e-4), 1e-2)
        _check_detections(Detections(*got[:4]), JaxDetections(*want[:4]),
                          *tol)
        np.testing.assert_allclose(got[4].numpy(), want[4], rtol=1e-3,
                                   atol=1e-3)
        assert np.array_equal(got[5].numpy(), want[5])
        memory = (got[4].numpy(), got[5].numpy())
    assert float(np.abs(memory[0]).max()) > 0, "nothing written"
    # the vocabulary is an input of the program
    zs2 = targs[1].roll(1, dims=1)
    assert not torch.equal(step(targs[0], zs2, *targs[2:])[1], got[1])
