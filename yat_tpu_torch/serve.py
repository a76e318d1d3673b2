"""Batching text-to-image inference server on the PyTorch port.

Counterpart of ``yat_tpu/serve.py``: it builds the family's sampling
pipeline once, then serves HTTP requests through it.  Requests are
micro-batched: the sampler thread collects up to ``--max-batch`` prompts
(waiting at most ``--batch-window-ms`` after the first arrival) and runs
them as one CFG-batched sampling run.  Sampling settings are
server-global.

    python -m yat_tpu_torch.serve --config config.yaml \
        --family sana|pixart|sd15|sdxl|sd35|flux|pixeldit \
        --port 8000 --max-batch 4 --batch-window-ms 50 \
        [--sampler auto|dpm] [--cache-interval N] [--device cuda]

    curl -X POST localhost:8000/generate -d '{"prompt": "a red fox"}'
    # → image/png bytes
    curl localhost:8000/healthz
    # → {"status": "ok", "requests": N, "batches": M, ...}
"""

from __future__ import annotations

import json
import queue
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from yat_tpu_torch.generate import FAMILIES, configure_pipeline, \
    family_module, png_bytes


class _Request:
    __slots__ = ("prompt", "done", "image", "error", "cancelled")

    def __init__(self, prompt: str):
        self.prompt = prompt
        self.done = threading.Event()
        self.image: Optional[np.ndarray] = None
        self.error: Optional[str] = None
        # set when the submitting client gave up (timeout): the sampler
        # skips it instead of spending a batch slot on it
        self.cancelled = threading.Event()


class BatchingSampler:
    """Single sampler thread draining a request queue in micro-batches.

    All device work stays on ONE thread; HTTP handler threads only enqueue
    and wait.  ``pipeline(prompts)`` returns ``{"validation/{i}/{prompt}":
    image}`` for the prompts in order (``train/validation.py``)."""

    def __init__(self, pipeline: Callable[[List[str]], Dict[str, np.ndarray]],
                 max_batch: int = 4, batch_window_ms: float = 50.0):
        if pipeline is None:
            raise RuntimeError("no sampling pipeline — cannot serve")
        self.pipeline = pipeline
        self.max_batch = max(1, int(max_batch))
        self.window_s = max(0.0, batch_window_ms / 1000.0)
        self.queue: "queue.Queue[_Request]" = queue.Queue()
        self.stats = {"requests": 0, "batches": 0, "images": 0,
                      "errors": 0, "shed": 0}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serve-sampler")
        self._thread.start()

    # ------------------------------------------------------------------
    def submit(self, prompt: str, timeout: Optional[float] = None
               ) -> np.ndarray:
        """Enqueue a prompt and block until its image is sampled."""
        req = _Request(prompt)
        self.queue.put(req)
        if not req.done.wait(timeout):
            req.cancelled.set()
            raise TimeoutError("sampling timed out")
        if req.error is not None:
            raise RuntimeError(req.error)
        return req.image

    def warmup(self) -> None:
        """Run the batch sizes a request would hit before serving (the full
        batch and the singleton), so first-use costs (kernel builds,
        library initialisation) do not land on a client.  The full-batch
        requests are enqueued under a temporarily widened window so they
        coalesce into one max_batch run."""
        if self.max_batch > 1:
            saved = self.window_s
            self.window_s = max(saved, 1.0)
            try:
                reqs = [_Request(f"warmup {i}")
                        for i in range(self.max_batch)]
                for r in reqs:
                    self.queue.put(r)
                for r in reqs:
                    r.done.wait()
            finally:
                self.window_s = saved
            for r in reqs:
                if r.error is not None:
                    raise RuntimeError(r.error)
        self.submit("warmup")

    def stop(self) -> None:
        self._stop.set()
        self.queue.put(None)          # wake the drain loop
        self._thread.join(timeout=10)

    # ------------------------------------------------------------------
    def _shed(self, req: _Request) -> None:
        self.stats["shed"] += 1
        req.done.set()

    def _collect(self) -> List[_Request]:
        while True:
            first = self.queue.get()
            if first is None or self._stop.is_set():
                return []
            if first.cancelled.is_set():   # client gave up while queued
                self._shed(first)
                continue
            break
        batch = [first]
        deadline = time.monotonic() + self.window_s
        while len(batch) < self.max_batch:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                nxt = self.queue.get(timeout=left)
            except queue.Empty:
                break
            if nxt is None:
                break
            if nxt.cancelled.is_set():
                self._shed(nxt)
                continue
            batch.append(nxt)
        return batch

    def _loop(self) -> None:
        while not self._stop.is_set():
            batch = self._collect()
            # cancellation may land during the batch window: re-filter so
            # a fully-abandoned batch never reaches the device
            live = [r for r in batch if not r.cancelled.is_set()]
            for r in batch:
                if r not in live:
                    self._shed(r)
            batch = live
            if not batch:
                continue
            self.stats["batches"] += 1
            self.stats["requests"] += len(batch)
            try:
                images = self._sample([r.prompt for r in batch])
                for req, img in zip(batch, images):
                    req.image = img
                    self.stats["images"] += 1
            except Exception as e:  # noqa: BLE001 — report to waiters
                self.stats["errors"] += len(batch)
                for req in batch:
                    req.error = f"{type(e).__name__}: {e}"
            finally:
                for req in batch:
                    req.done.set()

    def _sample(self, prompts: List[str]) -> List[np.ndarray]:
        """One pipeline pass over the batch; results ordered like
        ``prompts`` (tags carry the prompt index)."""
        tagged = self.pipeline(list(prompts))
        by_idx = {int(tag.split("/", 2)[1]): img
                  for tag, img in tagged.items()}
        return [by_idx[i] for i in range(len(prompts))]


def build_sampler(params, family: str, max_batch: int = 4,
                  batch_window_ms: float = 50.0,
                  steps: Optional[int] = None,
                  guidance_scale: Optional[float] = None,
                  seed: Optional[int] = None,
                  cache_interval: Optional[int] = None,
                  device=None,
                  sampler: Optional[str] = None) -> BatchingSampler:
    """Build the family's pipeline and start the sampler thread.  A
    defaulted ``validation_batch`` aligns to ``--max-batch`` (one sampling
    run per micro-batch); an explicit one is an operator's memory cap and
    is kept."""
    mod = family_module(family)
    if not getattr(params, "low_vram", False):
        explicit = ("validation_batch"
                    in getattr(params, "explicit_keys", frozenset()))
        if explicit and params.validation_batch < max_batch:
            print(f"[serve] config validation_batch="
                  f"{params.validation_batch} caps the sampling run; "
                  f"--max-batch {max_batch} micro-batches will be chunked")
        else:
            params.validation_batch = max(1, int(max_batch))
    vp = mod.make_pipeline(params, device)
    configure_pipeline(vp, steps, guidance_scale, seed, sampler,
                       cache_interval)
    return BatchingSampler(vp, max_batch=max_batch,
                           batch_window_ms=batch_window_ms)


def make_server(sampler: BatchingSampler, host: str = "127.0.0.1",
                port: int = 8000, request_timeout: float = 600.0):
    """ThreadingHTTPServer: POST /generate {"prompt": ...} → image bytes;
    GET /healthz → JSON stats.  Handler threads block on the sampler."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # noqa: N802 — quiet by default
            pass

        def _json(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            if self.path != "/healthz":
                return self._json(404, {"error": "not found"})
            self._json(200, {"status": "ok", **sampler.stats})

        def do_POST(self):  # noqa: N802
            if self.path != "/generate":
                return self._json(404, {"error": "not found"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n).decode("utf-8", "replace")
                try:
                    prompt = json.loads(raw)["prompt"]
                except (json.JSONDecodeError, TypeError, KeyError):
                    prompt = raw                 # plain-text body
                if not isinstance(prompt, str) or not prompt.strip():
                    return self._json(400, {"error": "empty prompt"})
            except Exception as e:  # noqa: BLE001 — a bad request body
                return self._json(400, {"error": str(e)})
            try:
                img = sampler.submit(prompt, timeout=request_timeout)
            except TimeoutError:
                return self._json(504, {"error": "sampling timed out"})
            except Exception as e:  # noqa: BLE001 — report to the client
                return self._json(500, {"error": str(e)})
            body, ctype = png_bytes(np.asarray(img))
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return ThreadingHTTPServer((host, port), Handler)


def main(argv: Optional[list] = None) -> None:
    import argparse

    from yat_tpu_torch.config import TrainingParameters

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", required=True, type=str)
    p.add_argument("--family", default="sana", choices=sorted(FAMILIES))
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-batch", type=int, default=4,
                   help="max prompts per sampling run")
    p.add_argument("--batch-window-ms", type=float, default=50.0,
                   help="how long to hold a batch open after the first "
                        "request arrives")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--guidance-scale", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--sampler", default=None, choices=("auto", "dpm"),
                   help="auto: the family's ladder; dpm: DPM-Solver++(2M) "
                        "(not flux)")
    p.add_argument("--cache-interval", type=int, default=None,
                   help="flow families: evaluate the denoiser every Nth "
                        "step and extrapolate the velocity in between")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    params = TrainingParameters.read_yaml(args.config)
    sampler = build_sampler(params, args.family, max_batch=args.max_batch,
                            batch_window_ms=args.batch_window_ms,
                            steps=args.steps,
                            guidance_scale=args.guidance_scale,
                            seed=args.seed,
                            cache_interval=args.cache_interval,
                            device=args.device, sampler=args.sampler)
    print("[serve] warming the sampler...")
    sampler.warmup()
    server = make_server(sampler, args.host, args.port)
    print(f"[serve] {args.family} listening on "
          f"http://{args.host}:{args.port}  (max_batch={args.max_batch}, "
          f"window={args.batch_window_ms}ms)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        sampler.stop()


if __name__ == "__main__":
    main()
