"""Built-in inference HTTP server for the port: the same protocol, limits
and error codes as ``triplegan_tpu/serve.py``.

    python -m triplegan_tpu_torch.cli serve --config cifar10_4k --workdir runs
    python -m triplegan_tpu_torch.cli serve --classifier runs/cifar10_4k/export/classify.pt2

Protocol (stdlib ``http.server``):

  * ``GET /healthz`` → JSON: status, torch device and its name, endpoints,
    serving batch sizes, request counters.
  * ``GET /metrics`` → Prometheus text of the counters.
  * ``POST /classify``: body is an ``.npy`` of uint8 NHWC images (any
    leading batch size); response is an ``.npy`` of float32 logits
    ``[N, num_classes]``.
  * ``POST /generate``: JSON ``{"n": int, "y": [labels]?, "seed": int?,
    "pixels": bool?}`` (the server draws z) or an ``.npz`` body with
    explicit ``z``/``y``; response is an ``.npy`` of images.
  * ``POST /reload`` (a server of a run dir's checkpoints): serve the
    newest checkpoint from now on.

Requests of any size run in chunks of the static serving batch, the last
chunk padded, as the JAX server does. One device lock serializes device
work while the threaded server keeps accepting connections. The sources:
a restored state (``app_from_state``, with a checkpoint reloader:
``make_checkpoint_reloader``) or exported ``.pt2`` artifacts
(``app_from_artifacts``).
"""

from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

import numpy as np
import torch

# Reject request bodies above this before buffering them.
MAX_BODY_BYTES = 256 * 1024 * 1024


def batched_apply(fn: Callable, batch: int, *arrays: np.ndarray) -> np.ndarray:
    """Run ``fn`` (served at static batch ``batch``) over ``arrays`` of any
    common leading size: chunk, pad the tail chunk by repeating its last row
    (values are discarded; only shapes must match), concatenate the
    un-padded outputs."""
    n = int(arrays[0].shape[0])
    if n == 0:
        raise ValueError("empty batch")
    if any(int(a.shape[0]) != n for a in arrays):
        raise ValueError("mismatched leading dimensions")
    outs = []
    for i in range(0, n, batch):
        chunk = [a[i : i + batch] for a in arrays]
        m = int(chunk[0].shape[0])
        if m < batch:
            chunk = [
                np.concatenate([c, np.repeat(c[-1:], batch - m, axis=0)])
                for c in chunk
            ]
        out = np.asarray(fn(*chunk))
        outs.append(out[:m])
    return np.concatenate(outs) if len(outs) > 1 else outs[0]


def numpy_fn(fn: Callable, device: torch.device) -> Callable:
    """Wrap a tensor function of ``export.make_serving_fns`` for
    ``batched_apply``: numpy arrays in, numpy array out."""

    def run(*arrays: np.ndarray) -> np.ndarray:
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]
        return fn(*args).cpu().numpy()

    return run


class ServingApp:
    """The servable state behind the HTTP handler: the serving functions
    (numpy in, numpy out), their static batch sizes, input contracts, and a
    device lock."""

    def __init__(
        self,
        classify: Optional[Callable] = None,
        generate: Optional[Callable] = None,
        *,
        device: torch.device,
        classify_batch: int = 0,
        generate_batch: int = 0,
        image_shape: Optional[tuple] = None,  # (H, W, C) for /classify
        z_dim: int = 0,
        num_classes: int = 0,
        meta: Optional[dict] = None,
        reloader: Optional[Callable] = None,  # () -> {"classify", "generate", "step"}
    ):
        if classify is None and generate is None:
            raise ValueError("nothing to serve: no classify or generate fn")
        self.classify = classify
        self.generate = generate
        self.device = torch.device(device)
        self.classify_batch = classify_batch
        self.generate_batch = generate_batch
        self.image_shape = tuple(image_shape) if image_shape else None
        self.z_dim = int(z_dim)
        self.num_classes = int(num_classes)
        self.meta = dict(meta or {})
        self.reloader = reloader
        self.device_lock = threading.Lock()
        self.counters = {"classify": 0, "generate": 0, "reload": 0, "errors": 0}
        # Cumulative seconds per endpoint: device-lock wait + compute, and
        # the wait alone.
        self.latency_s = {"classify": 0.0, "generate": 0.0}
        self.lock_wait_s = {"classify": 0.0, "generate": 0.0}
        self._counter_lock = threading.Lock()

    def count(self, key: str, seconds: float = None, wait: float = 0.0):
        with self._counter_lock:
            self.counters[key] += 1
            if seconds is not None:
                self.latency_s[key] += seconds
                self.lock_wait_s[key] += wait

    def _serve(self, endpoint: str, fn: Callable, batch: int, *arrays: np.ndarray) -> np.ndarray:
        """``batched_apply`` under the device lock, counted with its time and
        its wait for the lock."""
        t0 = time.perf_counter()
        with self.device_lock:
            t1 = time.perf_counter()
            out = batched_apply(fn, batch, *arrays)
        self.count(endpoint, seconds=time.perf_counter() - t0, wait=t1 - t0)
        return out

    # ---- endpoint implementations (numpy in / numpy|dict out) ----

    def health(self) -> dict:
        with self._counter_lock:
            requests = dict(self.counters)
        dev = self.device
        return {
            "status": "ok",
            "backend": dev.type,
            "device": str(dev),
            "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "endpoints": [
                e
                for e, fn in (("classify", self.classify), ("generate", self.generate),
                              ("reload", self.reloader))
                if fn is not None
            ],
            "classify_batch": self.classify_batch,
            "generate_batch": self.generate_batch,
            "image_shape": list(self.image_shape) if self.image_shape else None,
            "z_dim": self.z_dim,
            "num_classes": self.num_classes,
            "requests": requests,
            **self.meta,
        }

    def do_classify(self, images: np.ndarray) -> np.ndarray:
        if self.classify is None:
            raise ValueError("this server has no classifier endpoint")
        if images.dtype != np.uint8:
            raise ValueError(f"images must be uint8, got {images.dtype}")
        if images.ndim != 4:
            raise ValueError(f"images must be [N,H,W,C], got shape {images.shape}")
        if self.image_shape and tuple(images.shape[1:]) != self.image_shape:
            raise ValueError(
                f"images must be [N,{','.join(map(str, self.image_shape))}], "
                f"got {tuple(images.shape)}"
            )
        return self._serve("classify", self.classify, self.classify_batch, images)

    def do_generate(self, z: np.ndarray, y: np.ndarray, pixels: bool = False) -> np.ndarray:
        if self.generate is None:
            raise ValueError("this server has no generator endpoint")
        z = np.asarray(z, np.float32)
        y = np.asarray(y, np.int32)
        if z.ndim != 2 or (self.z_dim and z.shape[1] != self.z_dim):
            raise ValueError(f"z must be [N,{self.z_dim or '?'}], got {z.shape}")
        if y.shape != (z.shape[0],):
            raise ValueError(f"y must be [N]={z.shape[0]}, got {y.shape}")
        if self.num_classes and ((y < 0).any() or (y >= self.num_classes).any()):
            raise ValueError(f"labels must be in [0,{self.num_classes})")
        imgs = self._serve("generate", self.generate, self.generate_batch, z, y)
        if pixels:  # [-1,1] → uint8, the mapping of the JAX server
            imgs = np.clip((np.asarray(imgs, np.float32) + 1.0) * 127.5, 0, 255)
            imgs = imgs.astype(np.uint8)
        return imgs

    def metrics_text(self) -> str:
        """Prometheus text exposition of the request counters."""
        with self._counter_lock:
            counters = dict(self.counters)
            latency = dict(self.latency_s)
            wait = dict(self.lock_wait_s)
        lines = [
            "# HELP triplegan_requests_total Requests served, by endpoint.",
            "# TYPE triplegan_requests_total counter",
        ]
        for k, v in sorted(counters.items()):
            lines.append(f'triplegan_requests_total{{endpoint="{k}"}} {v}')
        lines += [
            "# HELP triplegan_request_seconds_total Cumulative device-side "
            "request time (lock wait + compute), by endpoint.",
            "# TYPE triplegan_request_seconds_total counter",
        ]
        for k, v in sorted(latency.items()):
            lines.append(f'triplegan_request_seconds_total{{endpoint="{k}"}} {v:.6f}')
        lines += [
            "# HELP triplegan_device_lock_wait_seconds_total Cumulative time requests "
            "waited for the device lock, by endpoint (a part of triplegan_request_seconds_total).",
            "# TYPE triplegan_device_lock_wait_seconds_total counter",
        ]
        for k, v in sorted(wait.items()):
            lines.append(f'triplegan_device_lock_wait_seconds_total{{endpoint="{k}"}} {v:.6f}')
        lines += [
            "# HELP triplegan_serving_batch Static serving batch size.",
            "# TYPE triplegan_serving_batch gauge",
            f'triplegan_serving_batch{{fn="classify"}} {self.classify_batch}',
            f'triplegan_serving_batch{{fn="generate"}} {self.generate_batch}',
        ]
        step = self.meta.get("step")
        if step is not None:
            lines += [
                "# HELP triplegan_checkpoint_step Step of the served checkpoint.",
                "# TYPE triplegan_checkpoint_step gauge",
                f"triplegan_checkpoint_step {int(step)}",
            ]
        return "\n".join(lines) + "\n"

    def do_reload(self) -> dict:
        """Serve the newest checkpoint: the reloader restores it and builds
        new serving functions outside the lock (requests go on being
        served), then they are swapped in under the device lock, so that a
        request in flight finishes on the old weights and a later one sees
        the new, never a mix."""
        if self.reloader is None:
            raise ValueError("this server has no reload source (artifacts are immutable; "
                             "reload serves a run dir's checkpoints)")
        fresh = self.reloader()
        with self.device_lock:
            self.classify = fresh.get("classify", self.classify)
            self.generate = fresh.get("generate", self.generate)
            if "step" in fresh:
                self.meta["step"] = int(fresh["step"])
        self.count("reload")
        return {"reloaded": True, "step": self.meta.get("step")}

    def generate_from_json(self, req: dict) -> np.ndarray:
        n = int(req.get("n", 0) or (len(req["y"]) if "y" in req else 0))
        if n <= 0:
            raise ValueError('JSON generate needs "n" or a "y" list')
        if not self.z_dim:
            raise ValueError("server does not know z_dim; POST an .npz with z")
        rng = np.random.RandomState(int(req.get("seed", 0)))
        z = rng.normal(size=(n, self.z_dim)).astype(np.float32)
        if "y" in req:
            y = np.asarray(req["y"], np.int32)
            if y.shape != (n,):
                raise ValueError(f'"y" must have length n={n}')
        elif self.num_classes:
            y = (np.arange(n) % self.num_classes).astype(np.int32)
        else:
            raise ValueError('server does not know num_classes; provide an explicit "y" list')
        return self.do_generate(z, y, pixels=bool(req.get("pixels", False)))


def _npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(arr), allow_pickle=False)
    return buf.getvalue()


def _load_npy(body: bytes) -> np.ndarray:
    arr = np.load(io.BytesIO(body), allow_pickle=False)
    if not isinstance(arr, np.ndarray):  # e.g. an .npz posted to /classify
        raise ValueError("body must be a single .npy array")
    return arr


def make_server(app: ServingApp, host: str = "127.0.0.1", port: int = 0):
    """Build (not start) a ``ThreadingHTTPServer`` for ``app``. Callers run
    ``server.serve_forever()`` (the CLI does) or drive it from a thread and
    ``shutdown()`` it. ``port=0`` binds an ephemeral port, read back from
    ``server.server_address``."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet: the CLI prints its own line
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj: dict):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def _body(self) -> bytes:
            """Read the request body, even on error routes: an unread body
            under HTTP/1.1 keep-alive is parsed as the next request line."""
            if "chunked" in (self.headers.get("Transfer-Encoding") or "").lower():
                raise ValueError("chunked transfer-encoding is not supported")
            try:
                length = int(self.headers.get("Content-Length", 0))
            except (TypeError, ValueError):
                raise ValueError("malformed Content-Length")
            if length < 0:
                raise ValueError("malformed Content-Length")
            if length > MAX_BODY_BYTES:  # cap before buffering, not after
                raise ValueError(
                    f"request body {length} bytes exceeds the {MAX_BODY_BYTES}-byte limit"
                )
            return self.rfile.read(length) if length else b""

        def do_GET(self):
            route = self.path.split("?")[0]
            if route in ("/healthz", "/"):
                self._send_json(200, app.health())
            elif route == "/metrics":
                self._send(200, app.metrics_text().encode(), "text/plain; version=0.0.4")
            else:
                self._send_json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            route = self.path.split("?")[0]
            try:
                body = self._body()  # drain first: keep-alive correctness
                if route == "/classify":
                    out = app.do_classify(_load_npy(body))
                    self._send(200, _npy_bytes(out), "application/x-npy")
                elif route == "/reload":
                    self._send_json(200, app.do_reload())
                elif route == "/generate":
                    ctype = (self.headers.get("Content-Type") or "").lower()
                    if "json" in ctype:
                        out = app.generate_from_json(json.loads(body.decode()))
                    else:  # .npz with explicit z / y arrays
                        with np.load(io.BytesIO(body), allow_pickle=False) as f:
                            if "z" not in f or "y" not in f:
                                raise ValueError(".npz body must contain z and y")
                            out = app.do_generate(f["z"], f["y"])
                    self._send(200, _npy_bytes(out), "application/x-npy")
                else:
                    self._send_json(404, {"error": f"no route {route}"})
            except (ValueError, KeyError, json.JSONDecodeError) as e:
                app.count("errors")
                self._send_json(400, {"error": str(e)})
                self.close_connection = True  # body may be partly unread
            except Exception as e:  # device/runtime failure: report, keep serving
                app.count("errors")
                self._send_json(500, {"error": f"{type(e).__name__}: {e}"})

    server = ThreadingHTTPServer((host, port), Handler)
    server.daemon_threads = True  # shutdown() must not wait on live requests
    return server


def app_from_state(cfg, nets, state, zca_stats=None, batch_size: int = 0, meta=None,
                   device=None, quantize=None, reloader=None) -> ServingApp:
    """Serve an in-memory state (a ``TrainState`` or ``{"gen", "clf"}``
    state dicts, see ``bridge.py``) through :func:`export.make_serving_fns`
    at a static batch size (default ``cfg.batch_size``) on ``device``
    (default the card). ``quantize="int8"`` serves the weight-only PTQ
    variant; ``reloader`` (:func:`make_checkpoint_reloader`) enables
    ``POST /reload``."""
    from triplegan_tpu_torch.export import make_serving_fns
    from triplegan_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    b = int(batch_size or cfg.batch_size)
    classify, generate = make_serving_fns(cfg, nets, state, zca_stats=zca_stats, device=dev,
                                          quantize=quantize)
    return ServingApp(
        classify=numpy_fn(classify, dev),
        generate=numpy_fn(generate, dev),
        device=dev,
        classify_batch=b,
        generate_batch=b,
        image_shape=(cfg.image_size, cfg.image_size, cfg.channels),
        z_dim=cfg.z_dim,
        num_classes=cfg.num_classes,
        meta=meta,
        reloader=reloader,
    )


def make_checkpoint_reloader(cfg, nets, ckpt, template, zca_stats=None, quantize=None,
                             device=None) -> Callable:
    """A :class:`ServingApp` reloader: restore the newest checkpoint of
    ``ckpt`` (``ckpt/manager.py``, which lists the directory afresh, so a
    live training run's new checkpoints are seen) into ``template``'s
    layout and build new serving functions on ``device``."""
    from triplegan_tpu_torch.export import make_serving_fns
    from triplegan_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(device)

    def reload():
        ckpt.refresh()
        fresh = ckpt.restore(template, step=None)
        if fresh is None:
            raise ValueError("no checkpoint to reload")
        classify, generate = make_serving_fns(cfg, nets, fresh, zca_stats=zca_stats, device=dev,
                                              quantize=quantize)
        return {"classify": numpy_fn(classify, dev), "generate": numpy_fn(generate, dev),
                "step": int(fresh.step)}

    return reload


def app_from_artifacts(classifier_path: Optional[str] = None, generator_path: Optional[str] = None,
                       meta=None, device=None) -> ServingApp:
    """Serve exported ``.pt2`` artifacts (``export.py``) on ``device``
    (default the card): the serving shapes, dtypes and batch sizes come from
    the artifacts' own input specs, no config needed. An artifact of the
    wrong kind (by its input count: a classifier takes 1, a generator 2)
    raises ``ValueError``."""
    from triplegan_tpu_torch.export import load_pt2
    from triplegan_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    kw = dict(meta=meta, device=dev)
    if classifier_path:
        art = load_pt2(classifier_path, device=dev)
        if len(art.in_specs) != 1:
            raise ValueError(f"{classifier_path} is not a classifier artifact (takes "
                             f"{len(art.in_specs)} inputs; a classifier takes 1: uint8 images)")
        (shape, _), = art.in_specs
        kw.update(classify=numpy_fn(art, dev), classify_batch=shape[0], image_shape=shape[1:])
    if generator_path:
        art = load_pt2(generator_path, device=dev)
        if len(art.in_specs) != 2:
            raise ValueError(f"{generator_path} is not a generator artifact (takes "
                             f"{len(art.in_specs)} inputs; a generator takes 2: z, y)")
        (z_shape, _), _ = art.in_specs
        kw.update(generate=numpy_fn(art, dev), generate_batch=z_shape[0], z_dim=z_shape[1])
    return ServingApp(**kw)
