"""The port's cluster-wide scrape (``rapid_tpu_torch/profiling/scrape.py``).

Twins of the scrape tests in ``tests/test_profiling.py``: the golden scrape
frames (``tests/golden/scrape_frames.json``, which ``rapid_tpu``'s codec
wrote) through the port's codec byte for byte, old frames' defaults,
``node_series`` / ``cluster_timeseries`` / ``merge_by_series`` equal to
JAX's on the fixtures, and on clusters of each package
(``test_torch_cluster.twin``): three members scraped into a cluster-wide
timeseries, the split across a restarted member's incarnations, and no
history without profiling. Then ``chip_smoke.py``'s scrape
(``native_scrape``): three port members on the native transport answering a
native-transport scraper over real sockets."""

import importlib
import json
import sys
from pathlib import Path

import pytest
from golden.scrape_fixtures import (
    HIERARCHY_RESPONSE,
    HISTORY_LINES,
    HLC_RESPONSE,
    SCRAPE_REQUEST,
    SCRAPE_RESPONSE,
    SLO_RESPONSE,
    TCP_SCRAPES,
)
from test_torch_cluster import twin

import chip_smoke
import rapid_tpu.profiling.scrape as jax_scrape
from rapid_tpu_torch import profiling
from rapid_tpu_torch import types as ptypes
from rapid_tpu_torch.messaging.codec import HEADER, decode, encode
from rapid_tpu_torch.profiling import scrape
from tools.perfscope import parse_rendered

sys.path.insert(0, str(Path(__file__).parent / "golden"))
from torch_wire_fixtures import convert  # noqa: E402

GOLDEN = json.loads((Path(__file__).parent / "golden" / "scrape_frames.json").read_text())


def port(msg):
    return convert(msg, ptypes)


def test_profiling_exports_the_scrape():
    assert profiling.cluster_timeseries is scrape.cluster_timeseries
    assert profiling.merge_by_series is scrape.merge_by_series
    assert profiling.node_segments is scrape.node_segments
    assert {"cluster_timeseries", "merge_by_series", "node_segments"} <= set(profiling.__all__)


@pytest.mark.parametrize("name", sorted(TCP_SCRAPES))
def test_scrape_frame_bytes_golden(name):
    """Each scrape frame ``rapid_tpu`` pinned encodes byte for byte through
    the port's codec, and the pinned bytes decode to an equal message."""
    request_no, jax_msg = TCP_SCRAPES[name]
    msg = port(jax_msg)
    entry = GOLDEN["tcp_frames"][name]
    assert entry["request_no"] == request_no
    body = encode(request_no, msg)
    assert body.hex() == entry["body_hex"]
    assert (HEADER.pack(len(body)) + body).hex() == entry["framed_hex"]
    assert decode(bytes.fromhex(entry["body_hex"])) == (request_no, msg)


def test_pre_profiling_frames_parse_to_defaults():
    """An old peer's scrape request (no ``include_history``) and status
    response round-trip with the defaults filled in."""
    old_req = ptypes.ClusterStatusRequest(sender=port(SCRAPE_REQUEST.sender))
    assert old_req.include_history == 0
    assert decode(encode(3, old_req)) == (3, old_req)
    old_resp = ptypes.ClusterStatusResponse(sender=port(SCRAPE_RESPONSE.sender),
                                            configuration_id=1, membership_size=2)
    back = decode(encode(4, old_resp))[1]
    assert back == old_resp and back.history == ()
    assert back.slo_names == () and back.slo_firing == ()
    assert back.hlc_physical_ms == 0 and back.hlc_incarnation == 0
    for rich in (SLO_RESPONSE, HLC_RESPONSE, HIERARCHY_RESPONSE):
        assert decode(encode(5, port(rich)))[1] == port(rich)


def test_node_series_from_wire_lines():
    series = scrape.node_series(HISTORY_LINES)
    assert series == jax_scrape.node_series(HISTORY_LINES)
    assert series["rounds"] == [(12.0, 3.0), (13.0, 5.0)]
    hist = "profile.phase_ms{phase=fd_scan,plane=sim}"
    assert series[f"{hist}.count"] == [(12.0, 3.0), (13.0, 5.0)]
    assert series[f"{hist}.sum"] == [(12.0, 1.5), (13.0, 2.25)]
    assert series["msg.queue_depth{peer=10.9.1.3:7103}"] == [(12.0, 128.0)]


def test_cluster_timeseries_merges_and_prefers_larger_scrape():
    jax_plain = SCRAPE_RESPONSE.__class__(sender=SCRAPE_REQUEST.sender, configuration_id=1,
                                          membership_size=3)
    jax_partial = SCRAPE_RESPONSE.__class__(sender=SCRAPE_RESPONSE.sender, configuration_id=1,
                                            membership_size=3, history=HISTORY_LINES[:1])
    jax_replies = [jax_plain, jax_partial, SCRAPE_RESPONSE]
    cluster = scrape.cluster_timeseries([port(r) for r in jax_replies])
    assert cluster == jax_scrape.cluster_timeseries(jax_replies)
    assert set(cluster) == {str(jax_plain.sender), str(SCRAPE_RESPONSE.sender)}
    assert cluster[str(jax_plain.sender)] == {}  # old peer: present, empty
    assert cluster[str(SCRAPE_RESPONSE.sender)]["rounds"] == [(12.0, 3.0), (13.0, 5.0)]
    merged = scrape.merge_by_series(cluster)
    assert merged == jax_scrape.merge_by_series(cluster)
    assert merged["rounds"] == {str(SCRAPE_RESPONSE.sender): [(12.0, 3.0), (13.0, 5.0)]}


def test_node_series_does_not_interleave_restarted_incarnations():
    lines = (
        '{"counters": {"rounds": 10.0}, "gauges": {}, "histograms": {}, '
        '"seq": 1, "ts_s": 50.0}',
        '{"counters": {"rounds": 20.0}, "gauges": {}, "histograms": {}, '
        '"seq": 2, "ts_s": 60.0}',
        '{"counters": {"rounds": 1.0}, "gauges": {}, "histograms": {}, '
        '"seq": 1, "ts_s": 5.0}',
        '{"counters": {"rounds": 2.0}, "gauges": {}, "histograms": {}, '
        '"seq": 2, "ts_s": 15.0}',
    )
    segments = scrape.node_segments(lines)
    assert segments == jax_scrape.node_segments(lines)
    assert [seg["rounds"] for seg in segments] == [
        [(50.0, 10.0), (60.0, 20.0)], [(5.0, 1.0), (15.0, 2.0)]]
    assert scrape.node_series(lines)["rounds"] == [
        (50.0, 10.0), (60.0, 20.0), (5.0, 1.0), (15.0, 2.0)]
    legacy = tuple(json.dumps({k: v for k, v in json.loads(line).items() if k != "seq"},
                              sort_keys=True) for line in lines)
    assert len(scrape.node_segments(legacy)) == 2


# --------------------------------------------------------------------- #
# clusters of each package, in process on the virtual clock
# --------------------------------------------------------------------- #


def _profiled(P):
    return P.settings.Settings(profiling=P.settings.ProfilingSettings(
        enabled=True, history_interval_ms=200, history_capacity=16))


def _scrape(h, probe, target, include_history):
    p = probe.send_message(target, h.P.types.ClusterStatusRequest(
        sender=probe.address, include_history=include_history))
    assert h.scheduler.run_until(p.done, timeout_ms=60_000)
    assert p.exception() is None, p.exception()
    reply = p.peek()
    assert isinstance(reply, h.P.types.ClusterStatusResponse)
    return reply


def _probe(h, port):
    return h.P.messaging_inprocess.InProcessClient(
        h.P.types.Endpoint.from_parts("127.0.0.1", port), h.network, h.settings)


def _snapshots(series):
    """The ``profile.history_snapshots`` points of one node's series map."""
    points = []
    for name, pts in series.items():
        if parse_rendered(name)[0] == "profile.history_snapshots":
            points.extend(pts)
    return sorted(points)


def three_member_scrape(h):
    fold = importlib.import_module(f"{h.P.name}.profiling.scrape")
    h.create_cluster(3)
    h.wait_and_verify_agreement(3)
    probe = _probe(h, 9999)
    members = list(h.instances)
    for _ in range(2):  # every status call ticks the ring
        for ep in members:
            assert _scrape(h, probe, ep, 0).history == ()
        h.scheduler.run_until(lambda: False, timeout_ms=500)
    replies = [_scrape(h, probe, ep, 8) for ep in members]
    assert all(len(r.history) >= 2 for r in replies)
    cluster = fold.cluster_timeseries(replies)
    assert set(cluster) == {str(ep) for ep in members}
    for node, series in cluster.items():
        counts = [v for _, v in _snapshots(series)]
        assert len(counts) >= 2 and counts == sorted(counts), node
    merged = fold.merge_by_series(cluster)
    spanning = {parse_rendered(name)[0] for name in merged}
    assert "profile.history_snapshots" in spanning
    return cluster, merged


def test_three_node_cluster_scrape_assembles_cluster_timeseries_twin():
    """Three members with profiling on, each scraped with history: one series
    map a member, each with a monotone ``profile.history_snapshots`` series
    on the virtual clock; every series and point equal in both packages."""
    twin(three_member_scrape, seed=15, settings=_profiled)


def restarted_member_scrape(h):
    fold = importlib.import_module(f"{h.P.name}.profiling.scrape")
    h.create_cluster(3)
    h.wait_and_verify_agreement(3)
    probe = _probe(h, 9998)
    target = h.addr(2)
    for _ in range(3):
        _scrape(h, probe, target, 0)
        h.scheduler.run_until(lambda: False, timeout_ms=500)
    before = _scrape(h, probe, target, 8).history
    h.fail_nodes([target])
    h.wait_and_verify_agreement(2)
    h.blacklist.discard(target)
    h.join(2, seed_index=0)  # same endpoint, fresh incarnation
    h.wait_and_verify_agreement(3)
    for _ in range(3):
        _scrape(h, probe, target, 0)
        h.scheduler.run_until(lambda: False, timeout_ms=500)
    after = _scrape(h, probe, target, 8).history
    assert len(before) >= 2 and len(after) >= 2
    segments = fold.node_segments(before + after)
    assert len(segments) == 2  # one per incarnation
    first, second = _snapshots(segments[0]), _snapshots(segments[1])
    for points in (first, second):
        counts = [v for _, v in points]
        assert counts == sorted(counts)
    assert second[0][1] <= first[-1][1]  # the ring really restarted
    key = next(k for k in segments[0] if parse_rendered(k)[0] == "profile.history_snapshots")
    assert fold.node_series(before + after)[key] == segments[0][key] + segments[1][key]
    return segments


def test_scrape_split_across_restarted_cluster_member_twin():
    twin(restarted_member_scrape, seed=17, settings=_profiled)


def no_history_without_profiling(h):
    h.create_cluster(2)
    h.wait_and_verify_agreement(2)
    reply = _scrape(h, _probe(h, 9999), h.addr(0), 8)
    assert reply.history == () and reply.membership_size == 2
    return reply.membership_size


def test_scrape_without_profiling_returns_no_history_twin():
    twin(no_history_without_profiling, seed=16)


def test_scrape_port_members_on_the_native_transport():
    """``chip_smoke.native_scrape``: three port members on
    ``NativeTcpClientServer`` with profiling on, scraped over real sockets by
    a native-transport client and folded with ``cluster_timeseries``: one
    series map a member, each holding that member's own counters."""
    from rapid_tpu_torch.messaging.native_tcp import native_io_available

    if not native_io_available():
        pytest.skip("the port's rapid_io.cpp did not build (no g++)")
    out = chip_smoke.native_scrape("cpu")
    assert len(out["members"]) == chip_smoke.SCRAPE_MEMBERS
    for node, row in out["members"].items():
        assert row["own_series"] >= 1 and row["snapshots"] >= 2, (node, row)
        assert row["history_lines"] >= 2, (node, row)
