"""The port's serving host (pipeline/serving.py) and `apps/serve.py`.

The MicroBatcher tests mirror tests/test_serving.py with fake grade
functions (no model, no JAX): coalescing, pow2 padding and its cap,
concurrent threads, the double-buffered dispatcher, close, the sentinel's
re-arm, warmup buckets and pad_multiple. Two tests hold the faults of the
reference's dispatcher that the port repairs: `call_ms` must not count the
next batch's drain window, and a size's first (cold) call must not hold up
the waiters of the batch in flight. The HTTP tests serve a CPU pipeline at
S = 32, built by the serve CLI's builder from reference-named checkpoints,
and hold its grades equal to `infer_grades` on the same images.
"""

import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from unet_goolenet_tpu_torch.apps import serve
from unet_goolenet_tpu_torch.models import GoogLeNetClassifier, UNetTaskAligWeight
from unet_goolenet_tpu_torch.pipeline.serving import GradingServer, MicroBatcher, _pow2_bucket
from torch_threads import torch_threads  # noqa: F401  (autouse)

S = 32
RAW = (40, 48)
RNG = np.random.default_rng(7)


class Lazy:
    """An asynchronous call's result: the grades only at np.asarray, after
    `delay` seconds of "device" time."""

    def __init__(self, arr, delay=0.01):
        self._arr, self._delay = arr, delay

    def __array__(self, dtype=None, copy=None):
        time.sleep(self._delay)
        return self._arr


def routed(batch):
    """grade = the image's first pixel, so every grade names its request."""
    return batch[:, 0, 0].astype(np.int64)


def images(values):
    return [np.full((2, 2), v, np.float32) for v in values]


# ---------------------------------------------------------------- batcher --

def test_batcher_coalesces_and_routes():
    calls = []

    def grade_fn(batch):
        calls.append(batch.shape[0])
        return routed(batch)

    mb = MicroBatcher(grade_fn, max_batch=8, max_wait_ms=50.0)
    try:
        assert mb.grade_many(images(range(5))) == [0, 1, 2, 3, 4]
        assert mb.device_calls <= 2              # coalesced, not 5 calls
        assert all(c in (1, 2, 4, 8) for c in calls)
    finally:
        mb.close()


def test_batcher_pads_to_pow2_and_caps():
    sizes = []

    def grade_fn(batch):
        sizes.append(batch.shape[0])
        return np.zeros(batch.shape[0], np.int64)

    mb = MicroBatcher(grade_fn, max_batch=4, max_wait_ms=20.0)
    try:
        mb.grade_many([np.zeros((2, 2), np.float32)] * 7)
        assert mb.images_total == 7
        assert all(s in (1, 2, 4) for s in sizes)      # never above max_batch
        assert max(sizes) == 4
    finally:
        mb.close()


def test_batcher_concurrent_threads_one_batch():
    barrier = threading.Barrier(4)
    mb = MicroBatcher(routed, max_batch=8, max_wait_ms=100.0)
    results = {}

    def worker(i):
        barrier.wait()
        results[i] = mb.grade(np.full((2, 2), i, np.float32))

    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert results == {i: i for i in range(4)}
        assert mb.device_calls <= 2   # 4 threads coalesced (usually 1 call)
    finally:
        mb.close()


@pytest.mark.parametrize("overlap", [True, False])
def test_batcher_overlap_stream_parity(overlap):
    """With batch k+1 dispatched before batch k's grades are fetched, and
    without, every grade reaches its request across waves of batches."""
    calls = []

    def grade_fn(batch):
        calls.append(batch.shape[0])
        return Lazy(routed(batch))

    mb = MicroBatcher(grade_fn, max_batch=4, max_wait_ms=20.0, overlap=overlap)
    try:
        for wave in range(3):
            want = [10 * wave + i for i in range(6)]
            assert mb.grade_many(images(want)) == want
        assert mb.images_total == 18
        assert all(c in (1, 2, 4) for c in calls)
        assert mb.stats()["call_ms_p50"] >= 10.0    # the fetch's "device" time counts
    finally:
        mb.close()


def test_batcher_overlap_close_flushes_inflight():
    """close() delivers a batch whose fetch is still pending."""
    dispatched, done = threading.Event(), threading.Event()

    class Blocked:
        def __array__(self, dtype=None, copy=None):
            done.wait(5.0)
            return np.zeros(1, np.int64)

    def grade_fn(batch):
        dispatched.set()
        return Blocked()

    mb = MicroBatcher(grade_fn, max_batch=4, max_wait_ms=5.0, overlap=True)
    got = []
    t = threading.Thread(target=lambda: got.append(mb.grade(np.zeros((2, 2), np.float32))))
    t.start()
    assert dispatched.wait(10)
    done.set()
    t.join(timeout=10)
    mb.close()
    assert got == [0]


def test_close_semantics_and_stress():
    """close() rejects new work fast; heavy concurrent traffic all routes
    correctly through coalesced batches."""
    mb = MicroBatcher(routed, max_batch=8, max_wait_ms=2.0)
    results = {}

    def worker(i):
        results[i] = mb.grade(np.full((2, 2), i % 50, np.float32))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(32)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert results == {i: i % 50 for i in range(32)}
    assert mb.device_calls < 32
    assert mb.images_total == 32
    mb.close()
    with pytest.raises(RuntimeError, match="closed"):
        mb.grade(np.zeros((2, 2), np.float32))
    mb.close()   # idempotent


def test_close_rearms_sentinel_for_stuck_dispatcher():
    """close() racing a device call that outlasts its join window must not
    swallow the shutdown sentinel: the dispatcher finds it once the call
    returns, grades the in-flight item and exits."""
    release = threading.Event()
    entered = threading.Event()

    def grade_fn(batch):
        entered.set()
        assert release.wait(30)   # a device call longer than close's join
        return routed(batch)

    mb = MicroBatcher(grade_fn, max_batch=4, max_wait_ms=1.0)
    mb.join_s = 0.1
    got = {}
    w = threading.Thread(target=lambda: got.update(
        g=mb.grade(np.full((2, 2), 7, np.float32), timeout=60)))
    w.start()
    assert entered.wait(10)
    closer = threading.Thread(target=mb.close)   # its join will expire
    closer.start()
    closer.join(timeout=20)
    assert not closer.is_alive()
    release.set()
    w.join(timeout=10)
    assert got.get("g") == 7
    mb._thread.join(timeout=10)
    assert not mb._thread.is_alive()


def test_warmup_covers_all_buckets():
    """Warmup runs every bucket once on the dispatcher thread, the thread
    that then serves, and counts none of it as traffic."""
    calls, threads = [], set()

    def grade_fn(batch):
        calls.append(batch.shape[0])
        threads.add(threading.current_thread().name)
        return np.zeros(batch.shape[0], np.int64)

    srv = GradingServer(grade_fn, max_batch=16, max_wait_ms=1.0,
                        pad_multiple=8, meta={"raw_hw": [4, 4]})
    try:
        assert srv.warmup() == [8, 16] == calls
        assert threads == {"microbatcher"}
        assert srv.batcher.device_calls == 0      # warmup isn't traffic
        assert srv.batcher.warm == {8, 16}
        assert srv.batcher.grade(np.zeros((4, 4), np.float32)) == 0
        assert calls[-1] == 8
    finally:
        srv.close()
    srv2 = GradingServer(grade_fn, meta={})
    try:
        with pytest.raises(ValueError, match="raw_hw"):
            srv2.warmup()
    finally:
        srv2.close()


def test_job_ends_the_drain_window_and_runs_on_the_dispatcher():
    """A job queued while a batch's 5 s drain window is open closes the
    window: the batch is graded, then the job runs, on the dispatcher."""
    mb = MicroBatcher(routed, max_batch=4, max_wait_ms=5000.0)
    got = []
    try:
        t0 = time.monotonic()
        a = threading.Thread(target=lambda: got.append(mb.grade(np.full((2, 2), 3, np.float32))))
        a.start()
        while mb._queue.qsize() and time.monotonic() - t0 < 10:
            time.sleep(0.001)          # the dispatcher holds the image in its window
        assert mb.run_on_dispatcher(lambda: (threading.current_thread().name,
                                             mb.images_total)) == ("microbatcher", 1)
        a.join(timeout=10)
        assert got == [3] and time.monotonic() - t0 < 4.0
        assert mb.device_calls == 1
    finally:
        mb.close()
    with pytest.raises(RuntimeError, match="closed"):
        mb.run_on_dispatcher(lambda: None)


def test_pad_multiple_validation_and_bucketing():
    with pytest.raises(ValueError, match="pad_multiple"):
        MicroBatcher(lambda b: [0] * len(b), max_batch=10, pad_multiple=4)
    assert _pow2_bucket(3, 16, 8) == 8
    assert _pow2_bucket(9, 16, 8) == 16
    assert _pow2_bucket(1, 16, 1) == 1
    assert _pow2_bucket(5, 8, 1) == 8


# ------------------------------------------------- the reference's faults --

def test_call_ms_excludes_the_next_drain():
    """Under overlap, batch 1 (4 images, the cap) is in flight while batch 2
    (1 image) waits out its 200 ms drain window, and batch 1 is fetched
    after batch 2's dispatch. Its call_ms is its own call and fetch (~10
    ms), not the window: the reference timed dispatch -> fetch and read
    >= 200 ms."""
    mb = MicroBatcher(lambda batch: Lazy(routed(batch)), max_batch=4, max_wait_ms=200.0,
                      overlap=True)
    mb.warm.update({1, 2, 4})          # no cold size: batch 1 stays in flight
    try:
        assert mb.grade_many(images(range(5))) == list(range(5))
        assert mb.stats()["batch_size_histogram"] == {"1": 1, "4": 1}
        assert max(mb.call_ms) < 150.0
    finally:
        mb.close()


def test_cold_bucket_does_not_delay_the_batch_in_flight():
    """Batch 1 (4 images, a warm size) is in flight when batch 2 (1 image,
    a size not run yet, whose first call takes 0.3 s) is drained. Batch 1's
    waiters get their grades before that cold call ends: the reference
    dispatched it first and fetched batch 1 after it."""
    in_call, release, cold_end = threading.Event(), threading.Event(), []

    def grade_fn(batch):
        if batch.shape[0] == 4:
            in_call.set()
            assert release.wait(10)
        else:
            time.sleep(0.3)
            cold_end.append(time.monotonic())
        return Lazy(routed(batch), delay=0.0)

    mb = MicroBatcher(grade_fn, max_batch=4, max_wait_ms=1.0, overlap=True)
    mb.warm.add(4)
    first_done, second = [], []
    try:
        a = threading.Thread(target=lambda: first_done.append(
            (mb.grade_many(images(range(4))), time.monotonic())))
        a.start()
        assert in_call.wait(10)
        b = threading.Thread(target=lambda: second.append(mb.grade(np.full((2, 2), 9, np.float32))))
        b.start()
        deadline = time.monotonic() + 10
        while mb._queue.qsize() < 1 and time.monotonic() < deadline:
            time.sleep(0.001)          # batch 2's image is queued behind batch 1
        release.set()
        a.join(timeout=10)
        b.join(timeout=10)
        assert first_done[0][0] == [0, 1, 2, 3] and second == [9]
        assert first_done[0][1] < cold_end[0]
        assert mb.warm == {1, 4}
    finally:
        mb.close()


def test_ready_batch_is_fetched_before_the_next_dispatch():
    """Under overlap, batch 1 (4 images) is done (its result's ready() is
    true) when batch 2 (1 image) is drained. Its waiters get their grades
    while batch 2's dispatch still runs: a result without ready() would be
    fetched only after that dispatch."""
    in_second, release = threading.Event(), threading.Event()

    class Done(Lazy):
        def ready(self):
            return True

    def grade_fn(batch):
        if batch.shape[0] == 1:
            in_second.set()
            assert release.wait(10)
        return Done(routed(batch), delay=0.0)

    mb = MicroBatcher(grade_fn, max_batch=4, max_wait_ms=50.0, overlap=True)
    mb.warm.update({1, 4})
    first = []
    try:
        a = threading.Thread(target=lambda: first.append(mb.grade_many(images(range(5)))[:4]))
        b = threading.Thread(target=lambda: first.append(mb.grade_many(images(range(4)))))
        b.start()
        b.join(timeout=10)             # one batch of 4, fetched at once (idle queue)
        a.start()                      # 4 + 1: batch 2 blocks in its dispatch
        assert in_second.wait(10)
        deadline = time.monotonic() + 10
        while mb.images_total < 8 and time.monotonic() < deadline:
            time.sleep(0.001)
        assert mb.images_total == 8    # batch 1's grades are out during batch 2's dispatch
        release.set()
        a.join(timeout=10)
        assert first == [[0, 1, 2, 3], [0, 1, 2, 3]]
    finally:
        release.set()
        mb.close()


# ------------------------------------------------------------------- http --

@pytest.fixture(scope="module")
def server(tmp_path_factory):
    """serve --live --device cpu on seeded default-init weights."""
    torch.manual_seed(3)
    d = tmp_path_factory.mktemp("serve")
    torch.save(UNetTaskAligWeight(1, img_size=S).state_dict(), d / "unet.pt")
    torch.save({"net": GoogLeNetClassifier(6).state_dict()}, d / "gnet.pt")
    args = serve.parse_args(["--live", "--device", "cpu", "--unet-checkpoint", str(d / "unet.pt"),
                             "--gnet-checkpoint", str(d / "gnet.pt"), "--raw-hw", *map(str, RAW),
                             "--img-size", str(S), "--max-batch", "8"])
    srv = serve.build_server(args)
    port = srv.start()
    yield srv, port
    srv.close()


def _post_npy(port, arr, path="/v1/grade"):
    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=buf.getvalue(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_http_grade_parity_and_healthz(server):
    srv, port = server
    gray = RNG.uniform(0, 255, (3, *RAW)).astype(np.float32)
    want = srv.batcher._grade_fn.pipe.infer_grades(torch.from_numpy(gray)).tolist()
    assert _post_npy(port, gray)["grades"] == want
    assert _post_npy(port, gray[0])["grades"] == want[:1]   # one (H, W) image
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
        h = json.loads(r.read())
    assert h["ok"] and h["meta"]["raw_hw"] == list(RAW) and h["meta"]["device"] == "cpu"
    assert h["device_calls"] == srv.batcher.device_calls >= 2
    assert h["images"] == srv.batcher.images_total >= 4
    assert h["call_ms_p50"] > 0
    assert sum(h["batch_size_histogram"].values()) == h["device_calls"]
    assert all(int(k) & (int(k) - 1) == 0 for k in h["batch_size_histogram"])


@pytest.mark.parametrize("body,code,says", [
    (np.zeros((2, 10, 10), np.float32), 400, "raw_hw"),
    (np.zeros((1, 2, *RAW), np.float32), 400, "per-image shape"),
    (b"not an npy body", 400, "valid .npy"),
    (np.zeros(RAW, np.float32), 404, "not found"),
])
def test_http_errors(server, body, code, says):
    _, port = server
    data = body if isinstance(body, bytes) else None
    with pytest.raises(urllib.error.HTTPError) as e:
        if data is None:
            _post_npy(port, body, "/v1/grade" if code == 400 else "/v1/other")
        else:
            urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/grade", data=data, method="POST"), timeout=30)
    assert e.value.code == code
    assert says in json.loads(e.value.read())["error"]


@pytest.mark.cuda
def test_pipeline_grader_on_a_second_card():
    """PipelineGrader on cuda:1, called from a thread whose current device
    is cuda:0: its events must be recorded on cuda:1's stream, so the
    grades are read only after the download (a slow pipe leaves the pinned
    buffer unwritten if they were not)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: the grader serves on a non-zero device index")
    from unet_goolenet_tpu_torch.pipeline.serving import PipelineGrader

    class SlowPipe:
        device = torch.device("cuda:1")

        def infer_grades(self, x):
            w = torch.randn(2048, 2048, device=x.device)
            for _ in range(100):       # queued ahead of the grades on cuda:1's stream
                w = torch.tanh(w @ w)
            return x[:, 0, 0].long()

    grader = PipelineGrader(SlowPipe())
    got = []
    t = threading.Thread(target=lambda: got.extend(
        (np.asarray(r).tolist(), r.call_ms()) for r in [
            grader(np.full((4, 8, 8), v, np.float32) + np.arange(4)[:, None, None])
            for v in (5, 9)]))
    t.start()
    t.join(timeout=120)
    assert [g for g, _ in got] == [[5, 6, 7, 8], [9, 10, 11, 12]]
    assert all(ms > 1.0 for _, ms in got)


@pytest.mark.parametrize("argv,says", [
    (["--artifact", "export_dir"], "no export_serving artifact"),
    (["--live", "--artifact", "export_dir"], "exactly one"),
    ([], "exactly one"),
    (["--live", "--device", "cpu", "--raw-hw", "40", "48"], "--unet-checkpoint"),
])
def test_serve_refusals(argv, says):
    with pytest.raises(SystemExit, match=says):
        serve.build_server(serve.parse_args(argv))
