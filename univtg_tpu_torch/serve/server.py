"""Grounding service: HTTP front-end with dynamic micro-batching.

Counterpart of ``univtg_tpu/serve/server.py`` over the port's
GroundingPipeline:

  * videos are registered once (``PUT /videos/<id>``) and grounded many
    times; the host-side prep (L2-norm + TEF + bucket padding) happens at
    registration, not per request;
  * concurrent ``POST /ground`` requests are coalesced by a batcher thread
    into ONE forward on the card (GroundingPipeline.ground_prepared_many),
    across videos and across clients;
  * stdlib-only (ThreadingHTTPServer + threading + queue).

With a pipeline that holds a clip_encoder, ``PUT /videos/<id>`` also takes
raw video bytes (decoded on the host, encoded by the CLIP image tower on
the card) and ``POST /ground`` a text ``query``; without one both answer
400, as the JAX server does.

Request latency under load is bounded by ``max_wait_ms`` (the batching
window) plus one forward; an idle server dispatches immediately.
"""
from __future__ import annotations

import io
import json
import queue
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np


class VideoStore:
    """Bounded LRU of PreparedVideo tensors keyed by video id."""

    def __init__(self, pipeline, max_videos: int = 64):
        self._pipeline = pipeline
        self._max = max_videos
        self._lock = threading.Lock()
        self._videos: OrderedDict = OrderedDict()

    def put(self, video_id: str, vid_feats: np.ndarray) -> dict:
        pv = self._pipeline.prepare_video(vid_feats)
        with self._lock:
            self._videos[video_id] = pv
            self._videos.move_to_end(video_id)
            while len(self._videos) > self._max:
                self._videos.popitem(last=False)
        return {"video": video_id, "clips": pv.ctx_l, "bucket": pv.bucket}

    def get(self, video_id: str):
        with self._lock:
            pv = self._videos.get(video_id)
            if pv is not None:
                self._videos.move_to_end(video_id)
            return pv

    def delete(self, video_id: str) -> bool:
        with self._lock:
            return self._videos.pop(video_id, None) is not None

    def ids(self):
        with self._lock:
            return list(self._videos)


class _Request:
    __slots__ = (
        "pv", "txt", "top_k", "event", "result", "error", "t_enqueue",
        "abandoned",
    )

    def __init__(self, pv, txt, top_k):
        self.pv = pv
        self.txt = txt
        self.top_k = top_k
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.t_enqueue = time.perf_counter()
        self.abandoned = False  # waiter gave up; worker must not dispatch it


class MicroBatcher:
    """Coalesces concurrent grounding requests into batched dispatches.

    One worker thread drains the queue: the first pending request opens a
    batching window of ``max_wait_ms``; everything that arrives inside the
    window (up to ``max_batch``) rides the same device dispatch. Requests
    are grouped by top_k (the pipeline groups by shape bucket internally).
    """

    def __init__(
        self,
        pipeline,
        max_batch: int = 32,
        max_wait_ms: float = 4.0,
        request_timeout_s: float = 600.0,
    ):
        # The default timeout must survive the first forward of a process,
        # which builds the CUDA kernel (seconds), not only a warm dispatch.
        self._pipeline = pipeline
        self._max_batch = max_batch
        self._max_wait_s = max_wait_ms / 1e3
        self._timeout_s = request_timeout_s
        self._q: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self.stats = {
            "requests": 0,
            "batches": 0,
            "errors": 0,
            "max_batch_size": 0,
            "latency_ms": [],  # ring buffer, last 1024
        }
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, pv, txt, top_k: int, timeout_s: Optional[float] = None) -> dict:
        req = _Request(pv, txt, top_k)
        self._q.put(req)
        if not req.event.wait(self._timeout_s if timeout_s is None else timeout_s):
            req.abandoned = True  # worker skips it instead of dispatching
            raise TimeoutError("grounding request timed out")
        if req.error is not None:
            raise req.error
        with self._lock:
            self.stats["requests"] += 1
            lat = (time.perf_counter() - req.t_enqueue) * 1e3
            buf = self.stats["latency_ms"]
            buf.append(lat)
            del buf[:-1024]
        return req.result

    def _drain(self):
        """Block for one request, then sweep the batching window."""
        try:
            first = self._q.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.perf_counter() + self._max_wait_s
        while len(batch) < self._max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                batch.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _run(self):
        while not self._stop.is_set():
            batch = [r for r in self._drain() if not r.abandoned]
            if not batch:
                continue
            with self._lock:
                self.stats["batches"] += 1
                self.stats["max_batch_size"] = max(
                    self.stats["max_batch_size"], len(batch)
                )
            by_topk: dict = {}
            for r in batch:
                by_topk.setdefault(r.top_k, []).append(r)
            for top_k, reqs in by_topk.items():
                try:
                    results = self._pipeline.ground_prepared_many(
                        [(r.pv, r.txt) for r in reqs], top_k
                    )
                    for r, res in zip(reqs, results):
                        r.result = res
                except BaseException as e:  # propagate to every waiter
                    with self._lock:
                        self.stats["errors"] += 1
                    for r in reqs:
                        r.error = e
                finally:
                    for r in reqs:
                        r.event.set()

    def close(self, drain_s: float = 2.0):
        """Stop the worker; wait up to drain_s for the in-flight batch.
        Pass a large drain_s (e.g. the request timeout) for a graceful
        shutdown that lets a mid-dispatch batch finish."""
        self._stop.set()
        self._thread.join(timeout=drain_s)


def _json_default(o):
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, (np.floating, np.integer)):
        return o.item()
    raise TypeError(type(o).__name__)


class GroundingServer:
    """HTTP grounding service over a GroundingPipeline.

    Endpoints:
      GET    /healthz           -> {"ok": true, "platform": "cuda"|"cpu"}
      GET    /stats             -> batching/latency counters (JSON)
      GET    /metrics           -> same counters, Prometheus text format
      GET    /videos            -> {"videos": [ids...]}
      PUT    /videos/<id>       -> register clip features. Body: .npz bytes
                                   (key "features" or the first array) or
                                   JSON {"features": [[...]]} -- or RAW
                                   VIDEO bytes (Content-Type: video/*) when
                                   the pipeline has a clip_encoder: decoded
                                   on the host (ffmpeg/cv2), encoded by the
                                   CLIP image tower, then registered
      DELETE /videos/<id>       -> evict
      POST   /ground            -> {"video": id, "query_feats": [[...]],
                                   "top_k": 5} or {"query": "text"} when the
                                   pipeline has a clip_encoder. Returns the
                                   grounding dict (saliency included).
      POST   /reload            -> hot-swap the serving weights from
                                   {"checkpoint": path} (default: the
                                   startup checkpoint, typically the
                                   model_latest.ckpt a trainer keeps
                                   rewriting). No restart; a bad
                                   checkpoint leaves the old weights
                                   serving (400).
    """

    def __init__(
        self,
        pipeline,
        host: str = "127.0.0.1",
        port: int = 0,
        max_batch: int = 32,
        max_wait_ms: float = 4.0,
        max_videos: int = 64,
        request_timeout_s: float = 600.0,
        max_body_bytes: int = 512 * 1024 * 1024,
        param_loader=None,
        checkpoint_path: Optional[str] = None,
        reload_token: Optional[str] = None,
    ):
        """param_loader(path) -> state_dict enables POST /reload: the
        server restores a (possibly rewritten-in-place) checkpoint and
        hot-swaps the pipeline weights without restart
        (GroundingPipeline.swap_params). checkpoint_path is the default
        reload source -- typically the same --resume path a trainer keeps
        overwriting with model_latest.ckpt. reload_token (recommended
        whenever the server binds beyond localhost) gates /reload behind an
        X-Reload-Token header -- it swaps model behavior from a
        client-chosen filesystem path, unlike the other mutating endpoints
        which only touch the in-memory video store."""
        self.pipeline = pipeline
        self.store = VideoStore(pipeline, max_videos)
        self.batcher = MicroBatcher(pipeline, max_batch, max_wait_ms,
                                    request_timeout_s)
        self.max_body_bytes = max_body_bytes
        self.param_loader = param_loader
        self.checkpoint_path = checkpoint_path
        self.reload_token = reload_token
        self.last_loaded_checkpoint = checkpoint_path
        self.reload_count = 0
        self._reload_lock = threading.Lock()
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        service = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet by default
                pass

            def _reply(self, code: int, payload: dict):
                body = json.dumps(payload, default=_json_default).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _body(self) -> bytes:
                n = int(self.headers.get("Content-Length", 0))
                return self.rfile.read(n) if n else b""

            def _body_checked(self):
                """Read the body, or reply 413 + close and return None when
                it exceeds the size cap (one oversized PUT must not OOM the
                host; the connection closes because the body is unread)."""
                n = int(self.headers.get("Content-Length", 0))
                if n > service.max_body_bytes:
                    self.close_connection = True
                    self._reply(413, {
                        "error": f"body {n} bytes exceeds cap "
                                 f"{service.max_body_bytes}"
                    })
                    return None
                return self.rfile.read(n) if n else b""

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply(
                        200,
                        {
                            "ok": True,
                            "platform": service.pipeline.device.type,
                            "videos": len(service.store.ids()),
                        },
                    )
                elif self.path == "/stats":
                    with service.batcher._lock:
                        s = dict(service.batcher.stats)
                        lat = sorted(s.pop("latency_ms"))
                    if lat:
                        s["latency_p50_ms"] = round(lat[len(lat) // 2], 3)
                        s["latency_p95_ms"] = round(lat[int(len(lat) * 0.95)], 3)
                    s["reload_count"] = service.reload_count
                    if service.last_loaded_checkpoint:
                        s["checkpoint"] = service.last_loaded_checkpoint
                    self._reply(200, s)
                elif self.path == "/metrics":
                    body = service._prometheus_metrics().encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/videos":
                    self._reply(200, {"videos": service.store.ids()})
                else:
                    self._reply(404, {"error": f"unknown path {self.path}"})

            def do_PUT(self):
                if not self.path.startswith("/videos/"):
                    self._body()  # drain: keep-alive clients reuse the socket
                    self._reply(404, {"error": f"unknown path {self.path}"})
                    return
                video_id = self.path[len("/videos/"):]
                body = self._body_checked()
                if body is None:
                    return
                try:
                    ctype = self.headers.get("Content-Type", "")
                    if ctype.startswith("video/"):
                        feats = service._extract_video(body, ctype)
                    else:
                        feats = service._parse_features(body, ctype)
                    self._reply(200, service.store.put(video_id, feats))
                except Exception as e:
                    self._reply(400, {"error": str(e)})

            def do_DELETE(self):
                self._body()  # drain any body: keep-alive socket stays in sync
                if not self.path.startswith("/videos/"):
                    self._reply(404, {"error": f"unknown path {self.path}"})
                    return
                video_id = self.path[len("/videos/"):]
                if service.store.delete(video_id):
                    self._reply(200, {"deleted": video_id})
                else:
                    self._reply(404, {"error": f"unknown video {video_id}"})

            def _json_body(self):
                """Read + parse a JSON-object body; replies 413/400 and
                returns None AFTER replying on any failure (shared by
                /reload and /ground). `None` therefore always means 'a
                response was already sent' -- a bare `null` body is
                rejected as 400 rather than returned (which would leave the
                keep-alive client hanging with no response at all)."""
                body = self._body_checked()
                if body is None:
                    return None
                try:
                    obj = json.loads(body or b"{}")
                except json.JSONDecodeError as e:
                    self._reply(400, {"error": f"bad json: {e}"})
                    return None
                if not isinstance(obj, dict):
                    self._reply(400, {"error": "body must be a JSON object"})
                    return None
                return obj

            def do_POST(self):
                if self.path.startswith("/videos/"):
                    self.do_PUT()
                    return
                if self.path == "/reload":
                    # auth BEFORE touching the body: an unauthenticated
                    # client must not be able to make the server read and
                    # parse a near-cap body (pre-auth memory/CPU burn).
                    # Closing the connection skips the body drain safely.
                    if service.reload_token is not None and (
                        self.headers.get("X-Reload-Token")
                        != service.reload_token
                    ):
                        self.close_connection = True
                        self._reply(403, {"error": "bad or missing "
                                                   "X-Reload-Token"})
                        return
                    req = self._json_body()
                    if req is None:
                        return
                    code, payload = service.reload_checkpoint(
                        req.get("checkpoint")
                    )
                    self._reply(code, payload)
                    return
                if self.path != "/ground":
                    self._body()  # drain: keep-alive clients reuse the socket
                    self._reply(404, {"error": f"unknown path {self.path}"})
                    return
                req = self._json_body()
                if req is None:
                    return
                try:
                    top_k = int(req.get("top_k", 5))
                except (TypeError, ValueError):
                    top_k = -1
                if not 1 <= top_k <= 1000:
                    self._reply(400, {"error": f"top_k must be in [1, 1000], "
                                               f"got {req.get('top_k')!r}"})
                    return
                video_id = req.get("video")
                pv = service.store.get(video_id) if video_id else None
                if pv is None:
                    self._reply(404, {"error": f"unknown video {video_id!r}"})
                    return
                try:
                    txt = service._query_features(req)
                except Exception as e:
                    self._reply(400, {"error": str(e)})
                    return
                with service._inflight_lock:
                    service._inflight += 1
                try:
                    result = service.batcher.submit(pv, txt, top_k)
                    self._reply(200, result)
                except Exception as e:
                    self._reply(500, {"error": str(e)})
                finally:
                    with service._inflight_lock:
                        service._inflight -= 1

        class Server(ThreadingHTTPServer):
            # TCPServer's default listen backlog is 5; a burst of concurrent
            # clients (the whole point of micro-batching) overflows it and
            # the kernel RSTs the excess connections (observed under a
            # 64-client load test). Match the backlog to the batching model.
            request_queue_size = 128
            daemon_threads = True

        self._httpd = Server((host, port), Handler)
        self._serve_thread: Optional[threading.Thread] = None

    def reload_checkpoint(self, path: Optional[str] = None):
        """Hot-reload the serving weights from `path` (default: the
        checkpoint the server started from). Returns (http_code, payload).

        The load + validation happen BEFORE the swap, so a bad checkpoint
        (missing file, wrong architecture, truncated write) leaves the old
        weights serving and returns 400. The swap itself is one attribute
        assignment; requests already dispatched finish on the old weights,
        later ones use the new — no restart (shapes/dtypes are validated
        unchanged). Serialized under a lock so concurrent
        reloads cannot interleave."""
        if self.param_loader is None:
            return 400, {"error": "server started without a param_loader; "
                                  "reload is disabled"}
        if path is not None and not isinstance(path, str):
            # open() treats an int as an OS file descriptor and CLOSES it
            # on exit -- {"checkpoint": 3} would shut the listening socket
            return 400, {"error": "checkpoint must be a string path"}
        path = path or self.checkpoint_path
        if not path:
            return 400, {"error": "no checkpoint path: pass {\"checkpoint\": "
                                  "...} or start with checkpoint_path"}
        with self._reload_lock:
            try:
                params = self.param_loader(path)
                self.pipeline.swap_params(params)
            except FileNotFoundError:
                return 400, {"error": f"checkpoint not found: {path}"}
            except Exception as e:
                return 400, {"error": f"reload failed, still serving the "
                                      f"previous weights: {e}"}
            self.reload_count += 1
            # a one-off override must NOT become the new default -- bare
            # reloads keep following the startup checkpoint (the trainer's
            # model_latest.ckpt); stats report what was actually loaded
            self.last_loaded_checkpoint = path
            return 200, {"ok": True, "checkpoint": path,
                         "reload_count": self.reload_count}

    def _parse_features(self, body: bytes, content_type: str) -> np.ndarray:
        if "json" in content_type:
            feats = np.asarray(json.loads(body)["features"], np.float32)
        else:  # .npz / .npy bytes
            loaded = np.load(io.BytesIO(body))
            if isinstance(loaded, np.lib.npyio.NpzFile):
                with loaded as z:
                    key = "features" if "features" in z.files else z.files[0]
                    feats = np.asarray(z[key], np.float32)
            else:  # np.save bytes give a plain ndarray (no context manager)
                feats = np.asarray(loaded, np.float32)
        if feats.ndim != 2 or len(feats) == 0:
            raise ValueError(f"features must be (T, D), got {feats.shape}")
        return feats

    def _extract_video(self, body: bytes, content_type: str) -> np.ndarray:
        """Raw video bytes -> (T, embed_dim) clip features: host decode
        (extract/video.decode_frames, ffmpeg or cv2) feeding the CLIP image
        tower in uint8 batches (extract/pipeline.vid2clip). Decoders need a
        real file path, so the body lands in a temp file for the call."""
        if self.pipeline.clip_encoder is None:
            raise ValueError(
                "raw-video registration needs the pipeline constructed "
                "with a clip_encoder; send pre-extracted features instead"
            )
        import tempfile

        from univtg_tpu_torch.extract.pipeline import vid2clip

        suffix = "." + (content_type.split("/", 1)[1].split(";")[0] or "mp4")
        with tempfile.NamedTemporaryFile(suffix=suffix) as f:
            f.write(body)
            f.flush()
            return vid2clip(
                self.pipeline.clip_encoder, f.name,
                clip_len=self.pipeline.clip_len,
            )

    def _query_features(self, req: dict) -> np.ndarray:
        if "query_feats" in req:
            txt = np.asarray(req["query_feats"], np.float32)
            if txt.ndim != 2 or len(txt) == 0:
                raise ValueError(f"query_feats must be (L, D), got {txt.shape}")
            return txt
        if "query" in req:
            if self.pipeline.clip_encoder is None:
                raise ValueError(
                    "text queries need a clip_encoder; send query_feats"
                )
            from univtg_tpu_torch.extract.pipeline import txt2clip

            return txt2clip(self.pipeline.clip_encoder, req["query"])
        raise ValueError("request needs query_feats or query")

    def _prometheus_metrics(self) -> str:
        """GET /metrics: the batcher counters in Prometheus text format, so
        the service plugs into standard scrape-based monitoring (the JSON
        /stats endpoint stays for humans)."""
        with self.batcher._lock:
            s = dict(self.batcher.stats)
            lat = sorted(s.pop("latency_ms"))
        with self._inflight_lock:
            inflight = self._inflight
        lines = [
            "# TYPE univtg_requests_total counter",
            f"univtg_requests_total {s['requests']}",
            "# TYPE univtg_batches_total counter",
            f"univtg_batches_total {s['batches']}",
            "# TYPE univtg_request_errors_total counter",
            f"univtg_request_errors_total {s['errors']}",
            "# TYPE univtg_max_batch_size gauge",
            f"univtg_max_batch_size {s['max_batch_size']}",
            "# TYPE univtg_inflight_requests gauge",
            f"univtg_inflight_requests {inflight}",
            "# TYPE univtg_registered_videos gauge",
            f"univtg_registered_videos {len(self.store.ids())}",
        ]
        if lat:
            lines.append("# TYPE univtg_request_latency_ms summary")
            for q, idx in (("0.5", len(lat) // 2),
                           ("0.95", int(len(lat) * 0.95)),
                           ("0.99", int(len(lat) * 0.99))):
                lines.append(
                    f'univtg_request_latency_ms{{quantile="{q}"}} '
                    f"{lat[min(idx, len(lat) - 1)]:.3f}"
                )
        return "\n".join(lines) + "\n"

    def warmup(self, video_lengths=None, log=print):
        """Run the batch ladder once BEFORE taking traffic.

        The first forward of a process builds the CUDA kernel and warms
        cuBLAS/cuDNN for each new shape; this moves that cost off the first
        clients. Runs every pow-2 batch size up to max_batch for each given
        video length's bucket (default: the smallest bucket), for BOTH text
        buckets (32 and 77 tokens)."""
        pipe = self.pipeline
        lengths = list(video_lengths or [pipe.buckets[0]])
        rng = np.random.default_rng(0)
        d_raw = pipe.cfg.vid_dim - 2  # prepare_video appends 2 TEF dims
        for length in lengths:
            pv = pipe.prepare_video(
                rng.standard_normal((int(length), d_raw)).astype(np.float32)
            )
            # the dispatcher pads to the next pow-2, so a full batch of a
            # non-pow-2 max_batch runs the program ABOVE max_batch — warm
            # up to that one, not just max_batch
            top = 1 << (self.batcher._max_batch - 1).bit_length()
            for n_tok in (12, 40):  # _prepare_txt buckets: 32 and 77
                b = 1
                while b <= top:
                    txts = [
                        rng.standard_normal((n_tok, pipe.cfg.txt_dim)).astype(
                            np.float32
                        )
                    ] * b
                    t0 = time.perf_counter()
                    pipe.ground_prepared_many([(pv, t) for t in txts])
                    log(
                        f"warmup bucket={pv.bucket} "
                        f"Lt<={32 if n_tok <= 32 else 77} B={b}: "
                        f"{time.perf_counter() - t0:.1f}s"
                    )
                    b *= 2

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self):
        """Serve in a background thread (returns immediately)."""
        self._serving = True
        self._serve_thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.05},
            daemon=True,
        )
        self._serve_thread.start()
        return self

    def serve_forever(self):
        self._serving = True
        self._httpd.serve_forever()

    def close(self, drain_s: float = 2.0):
        """Stop accepting, then wait up to drain_s for in-flight /ground
        requests to get their responses (the batcher worker keeps running
        through the drain window, so queued requests still dispatch),
        then stop the worker."""
        if getattr(self, "_serving", False):
            # shutdown() blocks on serve_forever's exit event — which is
            # never set if the serve loop never ran (warmup-only servers)
            self._httpd.shutdown()  # stop accepting; handlers continue
        deadline = time.perf_counter() + drain_s
        while time.perf_counter() < deadline:
            with self._inflight_lock:
                if self._inflight == 0:
                    break
            time.sleep(0.02)
        self._httpd.server_close()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=2.0)
        self.batcher.close(max(0.1, deadline - time.perf_counter()))
