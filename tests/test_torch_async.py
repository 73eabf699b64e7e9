"""``SLAMSystem(run_async=True)`` on the CPU at 120x160 with the in-repo
prior: extracts in the worker thread give the synchronous run's triangles
and state, on the per-frame and the chunked path; an extract's error is
raised, not lost; and kernel launch counts kept by one thread's graph
capture take no launch of another thread."""
import threading

import numpy as np
import pytest
import torch

from difusion_tpu_torch.core import hash_map as HM
from difusion_tpu_torch.core import map as M
from difusion_tpu_torch.core import tracker as T
from difusion_tpu_torch.ops import _build
from difusion_tpu_torch.ops.imgproc import Intrinsic
from difusion_tpu_torch.slam import SLAMSystem, load_prior
from test_torch_optimize_slam import LIGHT
from test_torch_scan import CALIB, HASH, HYPER, MAP, W, _pack, _sequence


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs in several workers at once: two threads each keep
    them from crowding the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port():
    dec, enc, _ = load_prior(HYPER, 300, device="cpu")

    def make(hash_map=False, **kw):
        return SLAMSystem(HM.HashMapConfig(**HASH) if hash_map else M.MapConfig(**MAP),
                          T.TrackerConfig(**LIGHT),
                          dec, enc, Intrinsic(*CALIB), integrate_interval=2,
                          device="cpu", **kw)
    return list(_sequence(n=6)), make


def _same_run(a, b):
    np.testing.assert_array_equal(a.mesher.triangles()[0], b.mesher.triangles()[0])
    np.testing.assert_array_equal(a.mesher.triangles()[1], b.mesher.triangles()[1])
    for x, y in zip(a.tracker.pose_history(), b.tracker.pose_history()):
        assert torch.equal(x, y)
    for f in a.state._fields:
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f


@pytest.mark.parametrize("hash_map,fast", [(False, False), (True, False), (False, True)])
def test_async_per_frame_equals_sync(port, hash_map, fast):
    """Six frames per frame, fusion and an extract every 2: the worker's
    extracts (one in flight at a time, each over a snapshot whose dirty
    flags cleared at submission) leave the synchronous run's triangles,
    poses and state."""
    frames, make = port
    sync = make(hash_map=hash_map, mesh_fast=fast)
    run = make(hash_map=hash_map, mesh_fast=fast, run_async=True)
    for frame in frames:
        sync.process_frame(frame)
        run.process_frame(frame)
    assert run._mesh_future is not None
    run.finish_meshing()
    assert run._mesh_future is None
    assert len(sync.mesher.triangles()[0]) > 100
    _same_run(run, sync)


def test_async_then_chunk_and_run_sequence(port):
    """Frame 0's extract runs in the worker; a chunk then joins it before
    its own (synchronous) extract; ``run_sequence`` joins the last one: the
    triangles equal the synchronous runs'."""
    frames, make = port
    sync, run = make(), make(run_async=True)
    for system in (sync, run):
        system.process_frame(frames[0])
        system.process_chunk(torch.from_numpy(_pack(frames[1:6])), W)
    _same_run(run, sync)
    a, b = make(), make(run_async=True)
    ra, rb = a.run_sequence(_sequence(n=6)), b.run_sequence(_sequence(n=6))
    assert b._mesh_future is None and ra["n_voxels"] == rb["n_voxels"]
    _same_run(b, a)


def test_async_extract_error_is_raised(port):
    """An extract that fails in the worker raises at the next submission or
    at ``finish_meshing``; the system goes on afterwards."""
    frames, make = port
    system = make(run_async=True)
    inner = system.mesher.extract
    calls = []

    def failing(state, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("extract failed")
        return inner(state, **kw)
    system.mesher.extract = failing
    system.process_frame(frames[0])
    system.process_frame(frames[1])
    with pytest.raises(RuntimeError, match="extract failed"):
        system.process_frame(frames[2])              # submits the next: joins the first
    system.process_frame(frames[3])
    system.process_frame(frames[4])
    system.finish_meshing()
    assert len(calls) == 2 and len(system.mesher.triangles()[0]) > 100


def test_launch_counts_are_per_thread_while_recording():
    """While one thread records a graph's launches, another thread's
    launches go to the totals, and concurrent counts add up."""
    _build.reset_launch_counts()
    started, release = threading.Event(), threading.Event()
    recorded = {}

    def capture():
        with _build.recording() as rec:
            _build.count_launch("kernel_a")
            started.set()
            release.wait(10)
            recorded.update(rec)
    t = threading.Thread(target=capture)
    t.start()
    started.wait(10)
    workers = [threading.Thread(target=lambda: [_build.count_launch("kernel_b")
                                                for _ in range(1000)]) for _ in range(4)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    release.set()
    t.join()
    assert recorded == {"kernel_a": 1}
    counts = _build.launch_counts()
    assert counts.get("kernel_b") == 4000 and "kernel_a" not in counts
    _build.reset_launch_counts()
