"""The port's acceptor telemetry (``serving/acceptor_telemetry.py``) against
the JAX package's: the telemetry header codec, the per-worker shared-memory
stats block and the stdlib histogram, case by case as
``tests/test_acceptor_telemetry.py`` holds the reference, each case run on
both modules with the same inputs; then the byte layouts across the
packages: a header one packs the other unpacks, a stats block one writes
the other reads.
"""

import pytest

from pytorch_zappa_serverless_tpu.serving import acceptor_telemetry as JT
from pytorch_zappa_serverless_tpu_torch.serving import acceptor_telemetry as PT

TP = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
BOTH = pytest.mark.parametrize("T", [JT, PT], ids=["jax", "port"])


# -- the telemetry header -----------------------------------------------------

@BOTH
def test_telem_roundtrip(T):
    buf = T.pack_telem("req-0123456789ab", 1.0, 2.0, 3.0, 4.0, TP)
    assert T.unpack_telem(buf) == {"request_id": "req-0123456789ab", "t_accept": 1.0,
                                   "t_read": 2.0, "t_validate": 3.0, "t_push": 4.0,
                                   "traceparent": TP}


@BOTH
def test_telem_roundtrip_without_traceparent(T):
    t = T.unpack_telem(T.pack_telem("r1", 1.0, 1.0, 1.0, 1.0))
    assert t["request_id"] == "r1" and t["traceparent"] == ""


@BOTH
def test_telem_long_ids_truncate_not_fail(T):
    t = T.unpack_telem(T.pack_telem("x" * 40, 0.0, 0.0, 0.0, 0.0, "y" * 400))
    assert t["request_id"] == "x" * 16
    assert t["traceparent"] == "y" * 255


@BOTH
def test_telem_garbage_downgrades_to_none(T):
    assert T.unpack_telem(b"") is None
    assert T.unpack_telem(b"\x01short") is None
    full = T.pack_telem("r", 1.0, 2.0, 3.0, 4.0, TP)
    assert T.unpack_telem(full[:-10]) is None            # the traceparent cut
    assert T.unpack_telem(bytes([T.TELEM_VERSION + 1]) + full[1:]) is None
    assert T.unpack_telem(full[:1] + b"\xff" * 16 + full[17:]) is None


# -- the per-worker stats block -----------------------------------------------

@BOTH
def test_stats_block_attach_by_name_roundtrip(T):
    owner = T.WorkerStatsBlock(create=True)
    try:
        writer = T.WorkerStatsBlock(name=owner.name)
        writer.inc("accepts", 3)
        writer.inc("bytes_in", 1024)
        writer.note_shed(429)
        writer.note_shed(599)              # an untracked code: a no-op
        writer.observe_ms(0.2)
        writer.observe_ms(30.0)
        snap = owner.snapshot()
        assert snap["accepts"] == 3 and snap["bytes_in"] == 1024
        assert snap["shed_429"] == 1
        assert snap["inworker_ms"]["count"] == 2
        assert snap["inworker_ms"]["sum"] == 30.2
        assert snap["inworker_ms"]["buckets"]["0.25"] == 1
        assert snap["inworker_ms"]["buckets"]["+Inf"] == 2
        writer.close()
    finally:
        owner.close()
        owner.unlink()


@BOTH
def test_stats_block_heartbeat_age(T):
    blk = T.WorkerStatsBlock(create=True)
    try:
        assert blk.heartbeat_age_s() is None
        assert blk.snapshot()["heartbeat_age_s"] is None
        blk.heartbeat(now=100.0)
        assert blk.heartbeat_age_s(now=100.5) == 0.5
        assert blk.heartbeat_age_s(now=99.0) == 0.0
    finally:
        blk.close()
        blk.unlink()


@BOTH
def test_stats_block_layout_is_fixed(T):
    assert T.STATS_BLOCK_BYTES == (len(T.STATS_FIELDS) * 8
                                   + (len(T.INWORKER_BUCKETS_MS) + 1) * 8 + 8 + 8 + 8)
    blk = T.WorkerStatsBlock(create=True)
    try:
        assert blk.shm.size >= T.STATS_BLOCK_BYTES
        assert bytes(blk.shm.buf[:T.STATS_BLOCK_BYTES]) == bytes(T.STATS_BLOCK_BYTES)
    finally:
        blk.close()
        blk.unlink()


@BOTH
def test_stathist_snapshot_shape_matches_metrics_renderer(T):
    h = T.StatHist((1.0, 5.0))
    for v in (0.5, 0.7, 3.0, 99.0):
        h.observe(v)
    assert h.snapshot() == {"buckets": {"1": 2, "5": 3, "+Inf": 4}, "sum": 103.2, "count": 4}


# -- across the packages ------------------------------------------------------

def test_the_layouts_and_bounds_are_the_references():
    for name in ("STATS_FIELDS", "INWORKER_BUCKETS_MS", "RING_WAIT_BUCKETS_MS",
                 "OCCUPANCY_BUCKETS_PCT", "STATS_BLOCK_BYTES", "TELEM_VERSION"):
        assert getattr(PT, name) == getattr(JT, name), name


@pytest.mark.parametrize("rid,tp", [("req-0123456789ab", TP), ("r", ""),
                                    ("x" * 40, "y" * 400)])
def test_a_header_packed_by_one_package_unpacks_in_the_other(rid, tp):
    stamps = (1.25, 2.5, 3.75, 5.0)
    j, p = JT.pack_telem(rid, *stamps, tp), PT.pack_telem(rid, *stamps, tp)
    assert j == p
    assert PT.unpack_telem(j) == JT.unpack_telem(p) == JT.unpack_telem(j)


@pytest.mark.parametrize("writer_pkg,reader_pkg", [(JT, PT), (PT, JT)],
                         ids=["jax-writes", "port-writes"])
def test_a_stats_block_written_by_one_package_reads_in_the_other(writer_pkg, reader_pkg):
    owner = reader_pkg.WorkerStatsBlock(create=True)
    try:
        w = writer_pkg.WorkerStatsBlock(name=owner.name)
        w.inc("accepts", 7)
        w.inc("bytes_out", 4096)
        for code in (400, 413, 415, 429, 504):
            w.note_shed(code)
        for ms in (0.04, 0.3, 2.0, 300.0):
            w.observe_ms(ms)
        w.heartbeat(now=50.0)
        snap = owner.snapshot()
        twin = writer_pkg.WorkerStatsBlock(name=owner.name).snapshot()
        for s in (snap, twin):
            s.pop("heartbeat_age_s")
        assert snap == twin
        assert snap["accepts"] == 7 and snap["bytes_out"] == 4096
        assert all(snap[f"shed_{c}"] == 1 for c in (400, 413, 415, 429, 504))
        assert snap["inworker_ms"]["count"] == 4 and snap["inworker_ms"]["buckets"]["0.05"] == 1
        assert owner.heartbeat_age_s(now=51.0) == 1.0
        w.close()
    finally:
        owner.close()
        owner.unlink()
