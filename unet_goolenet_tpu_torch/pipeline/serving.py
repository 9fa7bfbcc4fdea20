"""Serving host: a micro-batching HTTP server over the two-stage grader.

Counterpart of `unet_goolenet_tpu/pipeline/serving.py:48-432`:

    server = GradingServer(PipelineGrader(pipe), max_batch=64,
                           meta={"raw_hw": [400, 500]})
    server.serve(port=8000)        # blocking; or .start() for a thread

    POST /v1/grade   body = .npy bytes, (H, W) or (N, H, W) float/uint8
                     -> {"grades": [g0, ...]}
    GET  /healthz    -> {"ok": true, "meta": {...}, "device_calls": N, ...}

  * Micro-batching: one dispatcher thread coalesces concurrent requests
    into one device call (the queue drained up to max_batch, or whatever
    arrived within max_wait_ms of the first item).
  * Bounded shapes: every device call is padded up to the next power of two
    (<= max_batch) by repeating a real image, whose grades are dropped.
  * One owner of the device: every device call happens on the dispatcher
    thread, `GradingServer.warmup` included (it queues its zero batches as
    a job the dispatcher runs, so the thread that serves is the one that
    was warmed). HTTP threads only enqueue and wait. So the process-wide
    TF32 flags that each pipeline call sets and restores
    (two_stage.py:inference) are never raced by a second thread.
  * Double buffering (overlap=True): batch k+1 is drained and dispatched
    before batch k's grades are fetched, unless batch k is already done.
    `PipelineGrader` keeps the host free for that on the card: the batch is
    staged in pinned host memory and copied with non_blocking=True, the
    grades come back into pinned memory behind a CUDA event, and only the
    fetch waits on it. The price: a batch still running when the next is
    drained releases its waiters only after that drain window and that
    dispatch, which on a pipeline whose launches take longer on the host
    than its work on the card is about one more call of host time.

Two faults of the reference are not carried over:
  * under overlap it timed a batch from its dispatch to the fetch, which
    waits for the next batch's drain (reference serving.py:249); here
    `call_ms` is each call's own time: the grade_fn result's `call_ms()`
    where it has one (PipelineGrader: CUDA events from the upload to the
    grades' download), else the host time spent in the call and in the
    fetch;
  * a padded size that had not run yet was dispatched while the previous
    batch was in flight, so that batch's waiters waited out the cold call
    (reference serving.py:263); here the in-flight batch is fetched first.
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from collections import Counter, deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer as _ThreadingHTTPServer
from typing import Callable, Sequence

import numpy as np
import torch

__all__ = ["GradingServer", "MicroBatcher", "PipelineGrader"]


def _pow2_bucket(n: int, cap: int, mult: int = 1) -> int:
    """Next power of two >= n (capped), rounded up to a multiple of `mult`."""
    b = 1
    while b < n and b < cap:
        b *= 2
    b = -(-b // mult) * mult
    return min(b, cap)


class _Pending:
    """One enqueued image awaiting its grade."""

    __slots__ = ("image", "event", "grade", "error")

    def __init__(self, image: np.ndarray):
        self.image = image
        self.event = threading.Event()
        self.grade = None
        self.error: Exception | None = None


class _Job:
    """A function the dispatcher runs between batches (warmup)."""

    __slots__ = ("fn", "event", "result", "error")

    def __init__(self, fn: Callable[[], object]):
        self.fn = fn
        self.event = threading.Event()
        self.result = None
        self.error: Exception | None = None

    def run(self) -> None:
        try:
            self.result = self.fn()
        except Exception as e:
            self.error = e
        self.event.set()


class _Graded:
    """A dispatched batch's grades on the card, fetched on demand:
    np.asarray waits for the download's event; ready() says whether it has
    completed; call_ms() is the device time from the start of the upload to
    the end of the download."""

    def __init__(self, host: torch.Tensor, start: torch.cuda.Event, end: torch.cuda.Event):
        self.host, self.start, self.end = host, start, end

    def __array__(self, dtype=None, copy=None):
        self.end.synchronize()
        return self.host.numpy() if dtype is None else self.host.numpy().astype(dtype)

    def ready(self) -> bool:
        return self.end.query()

    def call_ms(self) -> float:
        return self.start.elapsed_time(self.end)


class PipelineGrader:
    """A TwoStagePipeline's `infer_grades` as MicroBatcher's grade_fn, or a
    loaded serving artifact's (pipeline/export.py:ServingArtifact, which
    has the same `infer_grades` and `device`).

    On the card the call returns before the device finishes: the batch is
    copied into a pinned host buffer (two per size, used in turn, each
    reused only after its last upload's event) and uploaded with
    non_blocking=True, the pipeline's launches are queued, and the grades
    are copied back into pinned memory behind a CUDA event (`_Graded`).
    Everything runs with the pipeline's card as the current device, so the
    events are recorded on the stream that does the work whatever the
    calling thread's current device is. On the CPU the call is synchronous
    and returns numpy."""

    def __init__(self, pipe):
        self.pipe = pipe
        self.cuda = pipe.device.type == "cuda"
        self._slots: dict = {}     # shape -> [(pinned buffer, upload event)] * 2
        self._turn = 0

    def __call__(self, batch: np.ndarray):
        if not self.cuda:
            return self.pipe.infer_grades(torch.from_numpy(batch)).numpy()
        with torch.inference_mode(), torch.cuda.device(self.pipe.device):
            stream = torch.cuda.current_stream()
            if batch.shape not in self._slots:
                self._slots[batch.shape] = [
                    (torch.empty(batch.shape, dtype=torch.float32, pin_memory=True),
                     torch.cuda.Event()) for _ in range(2)]
            staged, uploaded = self._slots[batch.shape][self._turn]
            self._turn ^= 1
            uploaded.synchronize()             # its previous upload has finished
            staged.numpy()[...] = batch
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record(stream)
            x = staged.to(self.pipe.device, non_blocking=True)
            uploaded.record(stream)
            grades = self.pipe.infer_grades(x)
            host = torch.empty(grades.shape, dtype=grades.dtype, pin_memory=True)
            host.copy_(grades, non_blocking=True)
            end.record(stream)
            return _Graded(host, start, end)


class MicroBatcher:
    """Coalesce single-image requests into padded device batches.

    grade_fn: (N, H, W) float32 -> (N,) int grades, for any N <= max_batch,
    or an object that np.asarray turns into them (an asynchronous call); if
    that object has call_ms(), it gives the call's own time, and if it has
    ready(), the dispatcher fetches it before the next dispatch once ready()
    is true. Every call runs on ONE dispatcher thread.
    """

    # how long close() waits for the dispatcher to finish in-flight work
    join_s = 10.0

    def __init__(self, grade_fn: Callable[[np.ndarray], Sequence[int]], *,
                 max_batch: int = 64, max_wait_ms: float = 5.0,
                 pad_multiple: int = 1, grade_timeout_s: float = 600.0,
                 overlap: bool = True):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if max_batch % pad_multiple:
            raise ValueError(f"max_batch ({max_batch}) must be a multiple of "
                             f"pad_multiple ({pad_multiple})")
        self._grade_fn = grade_fn
        self.max_batch = max_batch
        self.pad_multiple = pad_multiple
        self.max_wait_s = max_wait_ms / 1e3
        # double-buffered dispatch: batch k's fetch rides under batch k+1's
        # drain and dispatch, so the device is not idle between batches
        self.overlap = overlap
        self.grade_timeout_s = grade_timeout_s
        self._queue: queue.Queue[_Pending | None] = queue.Queue()
        self._closed = False
        # makes the closed-check atomic with the enqueue (grade_many) and with
        # setting _closed + the sentinel (close), so a request racing shutdown
        # either lands BEFORE the sentinel (graded in flight) or gets the fast
        # RuntimeError, never a stranded _Pending waiting out grade_timeout_s
        self._close_lock = threading.Lock()
        # padded sizes that have run (or were warmed): a size not in it is
        # dispatched only with no batch in flight
        self.warm: set = set()
        # jobs (_Job) that arrived during a drain window, run after its batch
        self._jobs: deque = deque()
        # bounded metrics; _stats_lock orders dispatcher updates against
        # stats() reads
        self._stats_lock = threading.Lock()
        self.device_calls = 0             # batches dispatched
        self.images_total = 0             # real (unpadded) images graded
        self.batch_hist: Counter = Counter()      # padded device batch size -> count
        self.call_ms: deque = deque(maxlen=4096)  # recent device-call times
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="microbatcher")
        self._thread.start()

    def grade(self, image: np.ndarray, timeout: float | None = None) -> int:
        """Block until `image` is graded; returns the int grade."""
        return self.grade_many([image], timeout=timeout)[0]

    def grade_many(self, images: Sequence[np.ndarray],
                   timeout: float | None = None) -> list[int]:
        """Enqueue all images, then wait: one request's images coalesce into
        the same device batch. timeout=None uses grade_timeout_s."""
        if timeout is None:
            timeout = self.grade_timeout_s
        pending = [_Pending(np.asarray(im, np.float32)) for im in images]
        with self._close_lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            for p in pending:
                self._queue.put(p)
        out = []
        for p in pending:
            if not p.event.wait(timeout):
                raise TimeoutError("grade request timed out")
            if p.error is not None:
                raise p.error
            out.append(p.grade)
        return out

    def run_on_dispatcher(self, fn: Callable[[], object],
                          timeout: float | None = None):
        """Run fn() on the dispatcher thread between batches (any batch in
        flight is fetched first) and return its result."""
        job = _Job(fn)
        with self._close_lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._queue.put(job)
        if not job.event.wait(self.grade_timeout_s if timeout is None else timeout):
            raise TimeoutError("dispatcher job timed out")
        if job.error is not None:
            raise job.error
        return job.result

    def close(self) -> None:
        """Grade in-flight items, stop the dispatcher, fail stragglers fast."""
        with self._close_lock:
            if self._closed:       # idempotent; only the first close signals
                self._thread.join(timeout=self.join_s)
                return
            self._closed = True
            self._queue.put(None)
        self._thread.join(timeout=self.join_s)
        # The lock above guarantees no _Pending sits behind the sentinel, so
        # what is left is a pre-sentinel item a still-busy dispatcher has not
        # graded yet, or the sentinel itself. If the dispatcher is still alive
        # (a device call outlasted the join), re-arm its sentinel rather than
        # swallow it, or it would block on get() forever.
        while True:
            try:
                p = self._queue.get_nowait()
            except queue.Empty:
                break
            if p is None:
                if self._thread.is_alive():
                    self._queue.put(None)
                    break
                continue
            p.error = RuntimeError("batcher is closed")
            p.event.set()

    def stats(self) -> dict:
        """Serving metrics: percentiles over the last <= 4096 device calls,
        counters over the whole lifetime."""
        with self._stats_lock:
            ms = sorted(self.call_ms)
            calls = self.device_calls
            images = self.images_total
            hist = dict(self.batch_hist)

        def pct(p):
            return round(ms[min(len(ms) - 1, int(p * len(ms)))], 3) if ms else None

        return {
            "device_calls": calls,
            "images": images,
            "call_ms_p50": pct(0.50),
            "call_ms_p99": pct(0.99),
            "call_ms_max": round(ms[-1], 3) if ms else None,
            "batch_size_histogram": {str(s): c for s, c in sorted(hist.items())},
        }

    # -- dispatcher ---------------------------------------------------------

    def _drain(self, first: _Pending) -> tuple[list[_Pending], bool]:
        """Gather up to max_batch items arriving within max_wait_s of `first`.
        Returns (items, closing)."""
        batch = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:       # close() sentinel: grade in-flight, then stop
                return batch, True
            if isinstance(item, _Job):     # ends the window; runs after the batch
                self._jobs.append(item)
                break
            batch.append(item)
        return batch, False

    def _dispatch(self, items: list, padded_n: int) -> tuple | None:
        """Stack and pad `items` and issue the device call without fetching.
        Returns an in-flight record for _finish, or None if the dispatch
        itself failed (items already failed)."""
        try:
            real = np.stack([p.image for p in items])
            n = real.shape[0]
            if padded_n > n:   # replicate a real image; grades dropped
                pad = np.broadcast_to(real[:1], (padded_n - n, *real.shape[1:]))
                real = np.concatenate([real, pad])
            t0 = time.monotonic()
            result = self._grade_fn(real)
            self.warm.add(padded_n)
            return items, n, padded_n, result, (time.monotonic() - t0) * 1e3
        except Exception as e:
            for p in items:
                p.error = e
                p.event.set()
            return None

    def _finish(self, inflight: tuple) -> None:
        """Fetch an in-flight batch's grades and release its waiters."""
        items, n, padded_n, result, dispatch_ms = inflight
        try:
            t0 = time.monotonic()
            grades = np.asarray(result)
            own = getattr(result, "call_ms", None)
            ms = own() if own is not None else dispatch_ms + (time.monotonic() - t0) * 1e3
            with self._stats_lock:
                self.call_ms.append(ms)
                self.device_calls += 1
                self.images_total += n
                self.batch_hist[padded_n] += 1
            for p, g in zip(items, grades[:n]):
                p.grade = int(g)
                p.event.set()
        except Exception as e:
            for p in items:
                p.error = e
                p.event.set()

    @staticmethod
    def _ready(inflight: tuple) -> bool:
        ready = getattr(inflight[3], "ready", None)
        return ready is not None and ready()

    def _settle(self, inflight: tuple | None) -> None:
        """Fetch the in-flight batch, if any, then run the queued jobs."""
        if inflight is not None:
            self._finish(inflight)
        while self._jobs:
            self._jobs.popleft().run()

    def _loop(self) -> None:
        # At most ONE batch in flight while the next drains and dispatches.
        # Its fetch comes after the next dispatch is issued, so with a busy
        # queue its waiters also wait out the next batch's drain window and
        # dispatch; it is fetched before that dispatch if its result says it
        # is ready, or if the next batch's padded size has not run yet (a
        # cold call). When the queue is idle it is fetched at once. A job
        # runs with no batch in flight.
        inflight = None
        while True:
            if inflight is None:
                first = self._queue.get()
            else:
                try:
                    first = self._queue.get_nowait()
                except queue.Empty:
                    self._finish(inflight)
                    inflight = None
                    continue
            if first is None:
                if inflight is not None:
                    self._finish(inflight)
                return
            if isinstance(first, _Job):
                self._jobs.append(first)
                self._settle(inflight)
                inflight = None
                continue
            items, closing = self._drain(first)
            padded_n = _pow2_bucket(len(items), self.max_batch, self.pad_multiple)
            if inflight is not None and (padded_n not in self.warm or self._ready(inflight)):
                self._finish(inflight)
                inflight = None
            nxt = self._dispatch(items, padded_n)
            if inflight is not None:
                self._finish(inflight)
            inflight = nxt
            if closing or not self.overlap or self._jobs:
                self._settle(inflight)
                inflight = None
            if closing:
                return


class ThreadingHTTPServer(_ThreadingHTTPServer):
    """stdlib ThreadingHTTPServer with a production listen backlog: the
    default request_queue_size of 5 resets connections under concurrent
    load long before the batcher or the card saturates."""

    request_queue_size = 128
    daemon_threads = True


class GradingServer:
    """HTTP front over a MicroBatcher. grade_fn: (N, H, W) -> (N,) grades
    (PipelineGrader for a live pipeline); meta["raw_hw"] fixes the
    per-image shape that requests must have."""

    def __init__(self, grade_fn, *, max_batch: int = 64,
                 max_wait_ms: float = 5.0, pad_multiple: int = 1,
                 grade_timeout_s: float = 600.0, meta: dict | None = None,
                 overlap: bool = True):
        self.meta = dict(meta or {})
        raw_hw = self.meta.get("raw_hw")
        self._expect_shape = tuple(raw_hw) if raw_hw else None
        self.batcher = MicroBatcher(grade_fn, max_batch=max_batch,
                                    max_wait_ms=max_wait_ms,
                                    pad_multiple=pad_multiple,
                                    grade_timeout_s=grade_timeout_s,
                                    overlap=overlap)
        self._httpd: ThreadingHTTPServer | None = None

    # -- request handling ---------------------------------------------------

    def _grade_npy(self, body: bytes) -> list[int]:
        try:
            arr = np.load(io.BytesIO(body), allow_pickle=False)
        except Exception as e:   # a malformed body is the client's fault: 400
            raise ValueError(f"body is not a valid .npy array: {e}") from e
        if not isinstance(arr, np.ndarray):   # e.g. .npz bytes -> NpzFile
            raise ValueError("body must be a single .npy array, not "
                             f"{type(arr).__name__} (.npz archives are not "
                             "accepted)")
        if arr.ndim == 2:
            arr = arr[None]
        if arr.ndim != 3:
            want = self._expect_shape or "(H, W)"
            raise ValueError(f"expected per-image shape {want} (optionally "
                             f"batched), got {arr.shape}")
        if self._expect_shape and tuple(arr.shape[1:]) != self._expect_shape:
            raise ValueError(f"the server was built for raw_hw={self.meta.get('raw_hw')}, "
                             f"got images of {tuple(arr.shape[1:])}")
        return self.batcher.grade_many(list(arr.astype(np.float32)))

    def _handler(server_self):
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):   # quiet; the caller owns logging
                pass

            def _send(self, code: int, obj: dict) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, {"ok": True, "meta": server_self.meta,
                                     **server_self.batcher.stats()})
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/v1/grade":
                    self._send(404, {"error": "not found"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    grades = server_self._grade_npy(self.rfile.read(n))
                    self._send(200, {"grades": grades})
                except ValueError as e:
                    self._send(400, {"error": str(e)})
                except Exception as e:    # a device failure: report, keep serving
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})
        return Handler

    # -- lifecycle ----------------------------------------------------------

    def warmup(self) -> list[int]:
        """Run every pow2/pad_multiple batch bucket once on zero batches, on
        the dispatcher thread, and mark them warm, so that no request pays a
        size's first call (on the card: the kernels' build and load, the
        thread's library handles, the caching allocator's growth). Returns
        the bucket sizes. Needs meta raw_hw. Warmup calls are not counted
        in stats()."""
        if self._expect_shape is None:
            raise ValueError("warmup needs meta['raw_hw'] to build inputs")
        mb = self.batcher
        buckets, b = [], 1
        while True:
            padded = _pow2_bucket(b, mb.max_batch, mb.pad_multiple)
            if padded not in buckets:
                buckets.append(padded)
            if padded >= mb.max_batch:
                break
            b = padded + 1

        def run():
            for size in buckets:
                np.asarray(mb._grade_fn(np.zeros((size, *self._expect_shape), np.float32)))
                mb.warm.add(size)

        mb.run_on_dispatcher(run)
        return buckets

    def start(self, port: int = 0, host: str = "127.0.0.1") -> int:
        """Serve on a background thread; returns the bound port."""
        self._httpd = ThreadingHTTPServer((host, port), self._handler())
        threading.Thread(target=self._httpd.serve_forever, daemon=True,
                         name="grading-http").start()
        return self._httpd.server_address[1]

    def serve(self, port: int = 8000, host: str = "0.0.0.0") -> None:
        """Blocking serve (the CLI entry)."""
        self._httpd = ThreadingHTTPServer((host, port), self._handler())
        self._httpd.serve_forever()

    def close(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        self.batcher.close()
