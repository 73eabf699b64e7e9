"""The port's span recorder (``utils/tracing.py``) on the CPU: off it records
nothing and changes no value; on, the spans of the SLAM loop and the mesher
nest with their frame or extract, the feeder's on its own thread; under
``torch.profiler`` each span is an annotation at its recorded time; the
tracker's graph program times its segments; ``SLAMSystem.timings`` reads
the stage spans."""
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from difusion_tpu_torch.core import hash_map as HM
from difusion_tpu_torch.core import map as M
from difusion_tpu_torch.core import tracker as T
from difusion_tpu_torch.data.production import SyntheticSequence
from difusion_tpu_torch.ops.imgproc import Intrinsic
from difusion_tpu_torch.slam import SLAMSystem, load_prior
from difusion_tpu_torch.utils import tracing
from difusion_tpu_torch.utils.cudagraph import GraphProgram

HYPER = Path(__file__).resolve().parents[1] / "di-checkpoints/study_mixed/hyper.json"
CALIB = (300.0, 300.0, 79.5, 59.5, 5000.0)
MAP = dict(bound_min=(-2.0, -2.0, -0.5), n_xyz=(40, 40, 40), voxel_size=0.1,
           latent_dim=29, capacity=1 << 14, prune_min_vox_obs=4,
           ignore_count_th=1.0, encoder_count_th=600.0)
HASH = dict(voxel_size=0.1, latent_dim=29, capacity=1 << 14, table_size=1 << 16,
            prune_min_vox_obs=4, ignore_count_th=1.0, encoder_count_th=600.0)
ITERS = ((3, (("rgb", 2),)), (3, (("sdf",), ("rgb", 1))),
         (6, (("sdf",), ("rgb", 0))))
N = 8                      # frame 0 + chunks of 3, 3, 1
SLAM_SPANS = {"slam.run_sequence", "slam.wait_feed", "slam.feed.pack", "slam.feed.stack",
              "slam.feed.upload", "slam.process_frame", "slam.process_chunk",
              "slam.frame.pack", "slam.frame.upload", "slam.track", "slam.fuse",
              "slam.mesh"}
MESH_SPANS = {"mesh.extract", "mesh.prep", "mesh.prep.sync", "mesh.grid", "mesh.decode",
              "mesh.mc", "mesh.splice", "mesh.splice.download"}
WAITS = {"slam.frame.upload", "mesh.prep.sync", "mesh.splice.download"}


@pytest.fixture(autouse=True)
def _recorder():
    """Each test starts with the recorder off and empty, and leaves it so."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def make():
    dec, enc, _ = load_prior(HYPER, 300, device="cpu")

    def make(hash_map=False, meshing=True):
        return SLAMSystem(HM.HashMapConfig(**HASH) if hash_map else M.MapConfig(**MAP),
                          T.TrackerConfig(point_budget=4096, iter_config=ITERS),
                          dec, enc, Intrinsic(*CALIB), integrate_interval=2,
                          mesh_resolution=3, meshing=meshing, device="cpu")
    return make


def _sequence(n=N):
    return SyntheticSequence(n_frames=n, h=120, w=160, calib=Intrinsic(*CALIB),
                             corrugation=0.1, motion_scale=0.6)


def _run(make, path, on):
    if on:
        tracing.enable()
    system = make(meshing=path == "frame")
    if path == "chunk":
        system.run_sequence(_sequence(), chunk=3)
    else:
        for frame in _sequence(4):
            system.process_frame(frame)
    tracing.disable()
    Rs, ts = system.tracker.pose_history()
    return Rs, ts, system.state.latents, tracing.spans()


@pytest.mark.parametrize("path", ["chunk", "frame"])
def test_off_records_nothing_and_on_changes_no_value(make, path):
    """With the recorder off a run records no span; switched on, the same run
    gives the same poses and latents bit for bit."""
    off = _run(make, path, on=False)
    assert off[3] == []
    on = _run(make, path, on=True)
    assert len(on[3]) > 10
    for a, b in zip(off[:3], on[:3]):
        assert torch.equal(a, b)


def test_spans_nest_with_their_frames(make):
    """``run_sequence(chunk=3)`` with meshing: every name of the SLAM loop and
    the mesher appears (the frames are the camera's uint8 / uint16 arrays,
    so the feeder packs them on the device and stacks nothing), each child
    in its parent's interval with its item; the feeder's spans are on the
    feeder thread, one pack a frame."""
    tracing.enable()
    system = make()
    system.run_sequence(_sequence(), chunk=3)
    spans = tracing.spans()
    main = threading.get_ident()
    assert {s.name for s in spans} == SLAM_SPANS - {"slam.frame.pack", "slam.frame.upload",
                                                    "slam.feed.stack"} | MESH_SPANS
    assert all(s.end_ns >= s.start_ns for s in spans)
    for k, s in enumerate(spans):
        assert s.wait == (s.name in WAITS)
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns and p.thread == s.thread
            if p.name == "slam.run_sequence":          # the frame waited for
                assert s.item >= p.item
            elif p.name == "slam.process_chunk":       # a frame of the chunk
                assert p.item <= s.item < p.item + 3
            elif s.name != "mesh.extract":             # an extract has its number
                assert s.item == p.item, (s, p)
    feed = [s for s in spans if s.name.startswith("slam.feed.")]
    assert feed and all(s.thread != main and s.parent == -1 for s in feed)
    assert all(s.thread == main for s in spans if not s.name.startswith("slam.feed."))
    assert sorted(s.item for s in feed if s.name == "slam.feed.pack") == list(range(N))
    # chunks start at frames 1, 4, 7; each frame tracked once, frame 0 by process_frame
    assert [s.item for s in spans if s.name == "slam.process_chunk"] == [1, 4, 7]
    assert [s.item for s in spans if s.name == "slam.feed.upload"] == [0, 1, 4, 7]
    tracks = [s for s in spans if s.name == "slam.track"]
    assert [s.item for s in tracks] == list(range(N))
    assert {spans[s.parent].name for s in tracks} == {"slam.process_frame",
                                                      "slam.process_chunk"}
    assert [s.item for s in spans if s.name == "slam.fuse"] == [0, 2, 4, 6]
    top = [s for s in spans if s.parent == -1 and s.thread == main]
    assert [s.name for s in top] == ["slam.run_sequence"]
    # an extract a chunk (frame 0's too), numbered by the extractor
    extracts = [s for s in spans if s.name == "mesh.extract"]
    assert [s.item for s in extracts] == [0, 1, 2]
    assert all(spans[s.parent].name == "slam.mesh" for s in extracts)


def _mapped(make, hash_map):
    system = make(hash_map=hash_map, meshing=True)
    for frame in _sequence(3):
        system.process_frame(frame)
    return system


@pytest.mark.parametrize("hash_map", [False, True], ids=["dense", "hash"])
def test_extract_children_cover_it(make, hash_map):
    """A full extract's children (prep, grid, decode, one mc a chunk,
    splice) cover at least 90% of ``mesh.extract``, and its device waits sit
    where the module says: two in the prep, none in the chunk loop, and the
    extract's one count read and download in the splice."""
    system = _mapped(make, hash_map)
    system.mesher.max_eval_points = 1 << 12         # several mc chunks
    tracing.enable()
    system.mesher.extract(system.state, max_std=system.mesh_max_std, no_cache=True)
    spans = tracing.spans()
    root = [k for k, s in enumerate(spans) if s.name == "mesh.extract"]
    assert len(root) == 1 and spans[root[0]].parent == -1
    kids = [s for s in spans if s.parent == root[0]]
    names = [s.name for s in kids]
    assert names[:3] == ["mesh.prep", "mesh.grid", "mesh.decode"]
    assert names[-1] == "mesh.splice"
    assert names[3:-1] == ["mesh.mc"] * system.mesher.last_stats["mc_chunks"]
    assert len(names) > 5
    ext = spans[root[0]]
    covered = sum(s.end_ns - s.start_ns for s in kids)
    assert covered >= 0.9 * (ext.end_ns - ext.start_ns)
    waits = [(spans[s.parent].name, s.name) for s in spans if s.wait]
    assert waits.count(("mesh.prep", "mesh.prep.sync")) == 2
    assert waits.count(("mesh.splice", "mesh.splice.download")) == 1
    assert not [w for w in waits if w[0] == "mesh.mc"]
    assert len(waits) == 3 and system.mesher.last_stats["host_reads"] == 1


def test_annotations_match_the_records(make):
    """Under ``torch.profiler`` (CPU activity) each span is a user
    annotation of its name; laid on the profiler's clock by the recorder's
    offset, each record starts within 100 us of its annotation."""
    from torch.profiler import ProfilerActivity, profile
    system = _mapped(make, False)
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        system.process_frame(next(iter(_sequence(4))))
        system.mesher.extract(system.state, no_cache=True)
    events = list(prof.profiler.kineto_results.events())
    offset = tracing.clock_offset_ns((e.name(), e.start_ns()) for e in events)
    # one mark (after a warm-up annotation of the same name), at the first span
    assert offset is not None and [e.name() for e in events].count(tracing.MARK) == 2
    spans = tracing.spans()
    assert len(spans) > 10
    names = {s.name for s in spans}
    ann = sorted((e.start_ns(), e.name()) for e in events if e.name() in names)
    assert len(ann) == len(spans)
    for (t, name), s in zip(ann, sorted(spans, key=lambda s: s.start_ns)):
        assert name == s.name
        assert abs(s.start_ns + offset - t) < 100_000, (name, s.start_ns + offset - t)


def test_site_costs_under_a_microsecond_off():
    """A span site with the recorder off: one flag test, no allocation."""
    import tracemalloc
    n = 200_000

    def site():
        s = tracing.begin("x") if tracing.ON else -1
        if s >= 0:
            tracing.end(s)

    def sites():
        for _ in range(n):
            s = tracing.begin("x") if tracing.ON else -1
            if s >= 0:
                tracing.end(s)
    site()
    tracemalloc.start()
    before = tracemalloc.get_traced_memory()[0]
    sites()
    grown = tracemalloc.get_traced_memory()[0] - before
    tracemalloc.stop()
    assert grown < 1024 and tracing.n_spans() == 0
    t0 = time.perf_counter()
    sites()
    assert (time.perf_counter() - t0) / n < 1e-6


def test_program_times_its_segments_where_the_recorder_was_on_at_build():
    """On the CPU a program built with the recorder on times each segment
    (a loop: all its passes) on the host clock; built with it off, it times
    nothing, whatever the recorder does later."""
    def program(on):
        (tracing.enable if on else tracing.disable)()
        x = torch.zeros(())
        done = torch.zeros((), dtype=torch.bool)
        prog = GraphProgram("cpu")
        prog.add(lambda: x.zero_(), name="init")
        prog.add(lambda: (time.sleep(1e-3), x.add_(1), done.copy_(x >= 3)), done=done,
                 name="loop")
        prog.add(lambda: x.mul_(2))
        prog.build()
        tracing.enable()
        prog.run()
        prog.run()
        return prog, x
    prog, x = program(True)
    ns = prog.segment_ns()
    assert list(ns) == ["init", "loop", "2"] and all(v > 0 for v in ns.values())
    assert ns["loop"] >= 6e6 and float(x) == 6.0      # 2 launches x 3 passes x 1 ms
    assert prog.loop_passes() == [] and prog.n_flag_reads == 6
    assert program(False)[0].segment_ns() == {}
    with pytest.raises(ValueError, match="taken"):
        prog.add(lambda: None, name="init")


def test_profile_timings_are_the_stage_spans(make):
    """``profile`` switches the recorder on; ``timings`` holds the stage
    spans recorded since, and ``run_sequence`` reports their median and
    first time."""
    system = make()
    assert not system.profile and not tracing.ON
    assert system.timings == {"track": [], "integrate": [], "mesh": []}
    system.profile = True
    assert tracing.ON
    res = system.run_sequence(_sequence(5))
    spans = tracing.spans()
    for stage, name in (("track", "slam.track"), ("integrate", "slam.fuse"),
                        ("mesh", "slam.mesh")):
        got = [s.seconds for s in spans if s.name == name]
        assert system.timings[stage] == got and len(got) == {"track": 5}.get(stage, 3)
        assert res[f"{stage}_ms"] == pytest.approx(1e3 * float(np.median(got)))
        assert res[f"{stage}_first_ms"] == pytest.approx(1e3 * got[0])
    system.profile = False
    assert system.timings["track"] == []
