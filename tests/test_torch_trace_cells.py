"""``trace_cells.py``: the readings of the port's spans, by hand on made-up
spans, and on each benchmark cell at a size the CPU runs in seconds (the
recorder on before the system is built, the check still passing)."""
import pytest
import torch

import trace_cells as TC
from benchmark.tests import tiny
from difusion_tpu_torch.utils import tracing

MS = 1_000_000
SEED = 2 ** 31 + 977
BY_CELL = {
    "lrkt-dense.track-chunk12": {"feed_wait_ms_per_frame", "feeder_ms_per_frame",
                                 "gn_device_ms_per_frame"},
    "scannet-hash.live-mesh": {"upload_ms_per_frame", "gn_device_ms_per_frame",
                               "live_extract_ms"},
    "lrkt-dense.export-r8": {"mesh_wait_ms", "host_work_idle.export"},
}


def _spans(rows):
    """rows: (name, start ms, end ms, parent, item, wait, thread)."""
    out = []
    for name, a, b, parent, item, wait, thread in rows:
        s = tracing.Span(name, a * MS, parent, thread, item, wait)
        s.end_ns = b * MS
        out.append(s)
    return out


class _Trace:
    def __init__(self, window, busy):
        self.window, self._busy = window, busy

    def busy_intervals(self):
        return self._busy


# a window of 4 frames from 100 to 200 ms: spans before it do not count
STREAM = _spans([
    ("slam.wait_feed", 90, 99, -1, 0, False, 1),
    ("slam.run_sequence", 100, 200, -1, 4, False, 1),
    ("slam.wait_feed", 100, 110, 1, 4, False, 1),
    ("slam.wait_feed", 150, 156, 1, 8, False, 1),
    ("slam.feed.pack", 101, 103, -1, 4, False, 2),
    ("slam.feed.stack", 104, 105, -1, 4, False, 2),
    ("slam.feed.upload", 105, 108, -1, 4, False, 2),
    ("slam.process_frame", 160, 190, 1, 4, False, 1),
    ("slam.frame.pack", 160, 162, 7, 4, False, 1),
    ("slam.frame.upload", 162, 166, 7, 4, True, 1),
    ("slam.mesh", 170, 180, 7, 4, False, 1),
    ("slam.mesh", 181, 185, 7, 4, False, 1),
    ("slam.mesh", 186, 189, 7, 4, False, 1),
    ("mesh.extract", 171, 179, 10, 0, False, 1),     # live: not the export's
    ("mesh.prep.sync", 172, 174, 13, 0, True, 1),
    # onet_cbn: a fusion's refresh of the conditioning table, on a thread
    # of its own so that no span above changes its self time
    ("slam.fuse", 120, 124, -1, 8, False, 3),
    ("map.cond", 121, 123, 15, 8, False, 3),
])
WINDOW = TC.Window(100 * MS, 200 * MS, {"frames": 4},
                   {"pre": 8 * MS, "group0.init": MS, "group0.gn": 6 * MS,
                    "group1.gn": 10 * MS, "finish": MS})
# two extracts from 0 to 100 ms; the card is busy 0-10, 40-60 and 90-100
EXPORT = _spans([
    ("mesh.extract", 0, 50, -1, 0, False, 1),
    ("mesh.prep", 0, 10, 0, 0, False, 1),
    ("mesh.prep.sync", 2, 8, 1, 0, True, 1),
    ("mesh.decode", 10, 20, 0, 0, False, 1),
    ("mesh.mc", 20, 50, 0, 0, False, 1),
    ("mesh.mc.download", 25, 45, 4, 0, True, 1),
    ("mesh.extract", 50, 100, -1, 1, False, 1),
    ("mesh.mc.download", 60, 95, 6, 1, True, 1),
    ("slam.track", 0, 100, -1, 0, False, 2),         # another thread
    ("mesh.cond", 10, 12, 3, 0, False, 1),           # onet_cbn's conditioning
])
EXPORT_WINDOW = TC.Window(0, 100 * MS + 1, {"extracts": 2}, {})
EXPECT = {
    "feed_wait_ms_per_frame": (STREAM, WINDOW, (10 + 6) / 4),
    "feeder_ms_per_frame": (STREAM, WINDOW, (2 + 1 + 3) / 4),
    "upload_ms_per_frame": (STREAM, WINDOW, (2 + 4) / 4),
    "gn_device_ms_per_frame": (STREAM, WINDOW, (6 + 10) / 4),
    "live_extract_ms": (STREAM, WINDOW, 4.0),
    "mesh_wait_ms": (EXPORT, EXPORT_WINDOW, (6 + 20 + 35) / 2),
    # idle 10-40 and 60-90; the host works in 10-25 and 45-60 (not in the waits)
    "host_work_idle.export": (EXPORT, EXPORT_WINDOW, 15.0),
    "map_cond_ms_per_frame": (STREAM, WINDOW, 2 / 4),
    "mesh_cond_ms": (EXPORT, EXPORT_WINDOW, 2 / 2),
}


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_reading_by_hand(name):
    spans, window, want = EXPECT[name]
    trace = _Trace((0, 100 * MS), [(0, 10 * MS), (40 * MS, 60 * MS), (90 * MS, 100 * MS)])
    got = TC.readings(spans, window, trace, 0, 1)
    assert got[name] == pytest.approx(want)
    assert set(got) == set(EXPECT)
    # the other shape of run reads nothing for it
    other = TC.readings(*((EXPORT, EXPORT_WINDOW) if spans is STREAM else (STREAM, WINDOW)),
                        trace, 0, 1)
    assert other[name] is None


def test_by_name_gives_total_and_self_time_a_frame():
    got = TC.by_name(STREAM, WINDOW)
    assert got["slam.run_sequence"] == pytest.approx((100 / 4, (100 - 10 - 6 - 30) / 4))
    assert got["slam.process_frame"] == pytest.approx((30 / 4, (30 - 2 - 4 - 10 - 4 - 3) / 4))
    assert got["slam.frame.upload"] == pytest.approx((1.0, 1.0))
    assert "slam.wait_feed" in got and got["slam.wait_feed"][0] == pytest.approx(16 / 4)


def test_the_clocks_offset_moves_the_host_spans():
    trace = _Trace((0, 100 * MS), [(0, 10 * MS), (40 * MS, 60 * MS), (90 * MS, 100 * MS)])
    # the host clock 5 ms behind the profiler's: work 13-30 and 55-65 (idle 60-65)
    got = TC.readings(EXPORT, EXPORT_WINDOW, trace, 5 * MS, 1)["host_work_idle.export"]
    assert got == pytest.approx(17.0 + 5.0)


def _spec(workload):
    spec = tiny.spec(workload, width=160, budget=1024)
    traffic = spec["traffic"]
    traffic["trace_seconds"] = 0.5
    if traffic["entry"] == "chunk":
        traffic.update(chunk=4, warm_frames=5)
    if traffic["entry"] == "frame":
        # frame k fuses and meshes where k % integrate_interval == 0.  The
        # window opens on the tracked frame before such a frame: it holds a
        # meshing frame unless that one tracked frame outlasts it, and a
        # tracked frame, whose latencies the harness's window reads (a
        # window of fusion frames alone has none); the traced window after
        # it opens on a tracked frame unless the first held 21 frames
        traffic["warm_frames"] = spec["cfg"]["integrate_interval"] - 1
    return spec


@pytest.mark.parametrize("workload", sorted(BY_CELL))
def test_each_cell_reads_its_spans(workload):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        res = TC.run(workload, SEED, 1.5 if "live" in workload else 0.3, True,
                     torch.device("cpu"), spec=_spec(workload))
    finally:
        torch.set_num_threads(n)
        tracing.reset()
    assert res["correct"], res["checks"]
    assert not tracing.ON
    for name, value in res["spans"].items():
        if name in BY_CELL[workload]:
            assert value is not None and value > 0, (name, value)
        else:
            assert value is None, (name, value)
    if "gn_device_ms_per_frame" in BY_CELL[workload]:
        gn = sum(v for k, v in res["segment_ms"].items() if k.endswith(".gn"))
        assert gn == pytest.approx(res["spans"]["gn_device_ms_per_frame"])
    assert "breakdown" in res and res["window"]["frames" if "frames" in res["window"]
                                                else "extracts"] > 0
