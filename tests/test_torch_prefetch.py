"""``prefetch_to_device`` of the port against the JAX package's, on the
CPU: ``tests/utils/test_data.py``'s round trip and its producer-thread
contract run on both packages (the same batches in the same order, the
read-ahead bound, the producer's error after the batches before it,
``break`` and ``close()`` joining the thread, the ``data.wait`` spans
and the ``host_prefetch`` memory category), and what the port does
differently: ``device=``, ``PREFETCH_DEPTH`` and ``sharding=``."""

import threading
import time

import numpy as np
import pytest
import torch

from sparkdl_tpu import observe as jax_observe
from sparkdl_tpu.observe import mem as jax_mem
from sparkdl_tpu.utils import data as jax_data
from sparkdl_tpu_torch import observe as pt_observe
from sparkdl_tpu_torch.observe import mem as pt_mem
from sparkdl_tpu_torch.utils import data as pt_data

torch.set_num_threads(2)


class _Jax:
    name = "jax"
    data, observe, mem = jax_data, jax_observe, jax_mem

    @staticmethod
    def prefetch(it, size=2):
        return jax_data.prefetch_to_device(it, size=size)

    @staticmethod
    def set_depth(monkeypatch, n):
        monkeypatch.setenv(jax_data.PREFETCH_DEPTH_ENV, str(n))

    @staticmethod
    def telemetry_on(monkeypatch, path):
        monkeypatch.setenv(jax_observe.TELEMETRY_DIR_ENV, str(path))


class _Torch:
    name = "torch"
    data, observe, mem = pt_data, pt_observe, pt_mem

    @staticmethod
    def prefetch(it, size=2):
        return pt_data.prefetch_to_device(it, size=size, device="cpu")

    @staticmethod
    def set_depth(monkeypatch, n):
        monkeypatch.setattr(pt_data, "PREFETCH_DEPTH", n)

    @staticmethod
    def telemetry_on(monkeypatch, path):
        monkeypatch.setattr(pt_observe, "TELEMETRY_DIR", str(path))


@pytest.fixture(params=[_Jax, _Torch], ids=["jax", "torch"])
def pkg(request):
    return request.param


def _np(x):
    return np.asarray(x)


def _prefetch_threads():
    # both packages name the producer thread alike
    assert jax_data._PREFETCH_THREAD_NAME == pt_data._PREFETCH_THREAD_NAME
    return [t for t in threading.enumerate()
            if t.name == pt_data._PREFETCH_THREAD_NAME and t.is_alive()]


def _data():
    rng = np.random.default_rng(0)
    return {"x": rng.standard_normal((10, 2)).astype(np.float32),
            "y": np.arange(10, dtype=np.int32)}


def test_roundtrip_gives_the_jax_batches():
    """tests/utils/test_data.py's round trip: the port's batches are
    torch tensors on the device, equal to JAX's in value and dtype."""
    data = _data()
    jx = list(jax_data.prefetch_to_device(jax_data.batched(data, 4), size=2))
    pt = list(pt_data.prefetch_to_device(pt_data.batched(data, 4), size=2,
                                         device="cpu"))
    assert len(pt) == len(jx) == 2  # drop_last
    for a, b in zip(jx, pt):
        for k in ("x", "y"):
            assert isinstance(b[k], torch.Tensor)
            assert b[k].device.type == "cpu"
            assert b[k].numpy().dtype == np.asarray(a[k]).dtype
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]))
    shuffled = [
        np.concatenate([_np(b["y"]) for b in pf]) for pf in (
            jax_data.prefetch_to_device(
                jax_data.batched(data, 5, shuffle=True, seed=1)),
            pt_data.prefetch_to_device(
                pt_data.batched(data, 5, shuffle=True, seed=1),
                device="cpu"))]
    np.testing.assert_array_equal(shuffled[0], shuffled[1])
    assert sorted(shuffled[1].tolist()) == list(range(10))


def test_production_runs_on_the_background_thread(pkg):
    seen = []

    def gen():
        for i in range(4):
            seen.append(threading.current_thread().name)
            yield {"x": np.full((2,), i, np.float32)}

    batches = list(pkg.prefetch(gen(), size=2))
    assert [float(_np(b["x"])[0]) for b in batches] == [0.0, 1.0, 2.0, 3.0]
    assert set(seen) == {pt_data._PREFETCH_THREAD_NAME}
    assert _prefetch_threads() == []


@pytest.mark.parametrize("size", [1, 3])
def test_ordering_preserved(pkg, size):
    def gen():
        for i in range(7):
            yield {"x": np.full((3,), i, np.float32), "t": (np.int64(i),)}

    out = [(int(_np(b["x"])[0]), int(_np(b["t"][0])))
           for b in pkg.prefetch(gen(), size=size)]
    assert out == [(i, i) for i in range(7)]


def test_queue_depth_bounds_readahead(pkg, monkeypatch):
    """After one batch is consumed, at most consumed + size + depth + 1
    batches were ever pulled (the device buffer, the host queue and the
    one in the producer's hand)."""
    pkg.set_depth(monkeypatch, 2)
    pulled = []

    def gen():
        for i in range(100):
            pulled.append(i)
            yield {"x": np.zeros((1,), np.float32)}

    pf = pkg.prefetch(gen(), size=2)
    try:
        next(pf)
        time.sleep(0.3)  # room for an unbounded producer to run ahead
        assert len(pulled) <= 1 + 2 + 2 + 1, pulled
    finally:
        pf.close()
    assert _prefetch_threads() == []


def test_prefetch_depth_is_read_at_call_time(monkeypatch):
    """PREFETCH_DEPTH widens the host queue alone: with 6 and size 1, a
    stalled consumer lets the producer pull 1 + 6 + 1 batches (JAX's
    SPARKDL_TPU_PREFETCH_DEPTH the same)."""
    counts = {}
    for pkg in (_Jax, _Torch):
        pkg.set_depth(monkeypatch, 6)
        pulled = []

        def gen(pulled=pulled):
            for i in range(100):
                pulled.append(i)
                yield {"x": np.zeros((1,), np.float32)}

        pf = pkg.prefetch(gen(), size=1)
        try:
            next(pf)
            deadline = time.monotonic() + 5.0
            while len(pulled) < 9 and time.monotonic() < deadline:
                time.sleep(0.02)
            time.sleep(0.2)
            counts[pkg.name] = len(pulled)
        finally:
            pf.close()
    assert counts["torch"] == counts["jax"]
    assert 1 + 6 + 1 <= counts["torch"] <= 1 + 1 + 6 + 1, counts


def test_producer_exception_raised_at_consumption_point(pkg):
    def gen():
        yield {"x": np.zeros((1,), np.float32)}
        yield {"x": np.ones((1,), np.float32)}
        raise RuntimeError("disk on fire")

    got = []
    with pytest.raises(RuntimeError, match="disk on fire"):
        for b in pkg.prefetch(gen(), size=2):
            got.append(float(_np(b["x"])[0]))
    assert got == [0.0, 1.0]
    assert _prefetch_threads() == []


def test_break_joins_thread_and_closes_iterator(pkg):
    closed = {"flag": False}

    def gen():
        try:
            i = 0
            while True:
                yield {"x": np.full((1,), i, np.float32)}
                i += 1
        finally:
            closed["flag"] = True

    pf = pkg.prefetch(gen(), size=2)
    for _ in pf:
        break
    pf.close()
    assert closed["flag"], "the underlying iterator leaked"
    assert _prefetch_threads() == []


def test_close_is_safe_started_or_not(pkg):
    pf = pkg.prefetch(iter([{"x": np.zeros((1,))}]), size=2)
    pf.close()
    assert _prefetch_threads() == []
    pf = pkg.prefetch(({"x": np.full((1,), i, np.float32)}
                       for i in range(50)), size=2)
    next(pf)
    assert _prefetch_threads(), "the producer thread never started"
    pf.close()
    assert _prefetch_threads() == []


@pytest.fixture
def telemetry(pkg, monkeypatch, tmp_path):
    pkg.telemetry_on(monkeypatch, tmp_path)
    pkg.observe._reset_for_tests()
    yield pkg
    pkg.observe._reset_for_tests()


def test_starved_pipeline_emits_data_wait_spans(telemetry):
    pkg = telemetry

    def slow_gen():
        for i in range(3):
            time.sleep(0.05)
            yield {"x": np.full((1,), i, np.float32)}

    list(pkg.prefetch(slow_gen(), size=1))
    waits = [e for e in pkg.observe.timeline().drain()
             if e["name"] == "data.wait"]
    # the prime, then a refill at each of the 3 batches (the last one
    # dequeues the end)
    assert len(waits) == 4
    assert waits[0]["args"].get("phase") == "prime"
    assert all(e["cat"] == "data" for e in waits)
    me = threading.get_ident() & 0x7FFFFFFF
    assert all(e["tid"] == me for e in waits)
    assert sum(e["dur"] for e in waits) > 20_000  # us


def test_host_prefetch_memory_category(telemetry):
    pkg = telemetry

    def gen():
        for i in range(6):
            yield {"x": np.full((256,), i, np.float32)}

    pf = pkg.prefetch(gen(), size=1)
    try:
        next(pf)
        time.sleep(0.3)  # the producer parks batches
        parked = pkg.mem.sample_now()["categories"].get("host_prefetch", 0)
        # the same accounting: whole batches of 1 KiB each
        assert parked > 0 and parked % 1024 == 0
        list(pf)
        assert pkg.mem.sample_now()["categories"]["host_prefetch"] == 0
    finally:
        pf.close()


def test_torch_leaves_device_and_refusals(monkeypatch):
    """A torch leaf passes through, a scalar leaf becomes a tensor;
    ``sharding=`` is refused by name; without a card the default device
    raises, and a bound rank's device is the default."""
    src = [{"t": torch.arange(3), "s": np.float32(2.5), "n": "tag"}]
    (b,) = pt_data.prefetch_to_device(iter(src), device="cpu")
    assert torch.equal(b["t"], torch.arange(3)) and b["n"] == "tag"
    assert b["s"].dtype == torch.float32 and float(b["s"]) == 2.5
    with pytest.raises(NotImplementedError, match="shard_for_rank"):
        next(pt_data.prefetch_to_device(iter(src), sharding=object()))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(pt_data.prefetch_to_device(iter(src)))
    from sparkdl_tpu_torch.hvd import _state

    with _state.local_mode():
        monkeypatch.setattr(_state.state(), "device", torch.device("cpu"))
        (b,) = pt_data.prefetch_to_device(iter(src))
    assert b["t"].device.type == "cpu"
    assert _prefetch_threads() == []
