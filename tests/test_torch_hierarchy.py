"""The port's hierarchy plane against the JAX package's, on the CPU.

Twins of scenarios.py's hierarchy-zone-churn at 4 zones x 64 and of its
crash scenario with ``cells=4``, stepped on both simulators: the composed
rows, the global fingerprints after each view change, the parent rounds
and the virtual clock; then the pure functions of ``hierarchy/cells.py``
and ``parent.py`` (including the simulator's batched rendezvous against
the scalar ``cell_of_endpoint``), and the composed view's bookkeeping.
"""

import numpy as np
import pytest

import chip_smoke
from rapid_tpu.hierarchy import cells as jcells
from rapid_tpu.hierarchy import parent as jparent
from rapid_tpu.hierarchy.parent import cell_leaders as jax_cell_leaders
from rapid_tpu.sim.driver import Simulator as JaxSimulator
from rapid_tpu.sim.engine import SimConfig as JaxSimConfig
from rapid_tpu.sim.topology import LatencyTopology as JaxTopology
from rapid_tpu.types import Endpoint as JaxEndpoint
from rapid_tpu_torch.hierarchy import cells as pcells
from rapid_tpu_torch.hierarchy import parent as pparent
from rapid_tpu_torch.hierarchy.parent import cell_leaders
from rapid_tpu_torch.sim.driver import Simulator
from rapid_tpu_torch.sim.engine import SimConfig
from rapid_tpu_torch.sim.topology import LatencyTopology
from rapid_tpu_torch.types import Endpoint


def _port_sim(*args, **kw):
    return Simulator(*args, device="cpu", **kw)


def test_zone_churn_twin_4_zones_of_64():
    """hierarchy-zone-churn at 4 x 64: a scatter of crashes, then a whole
    cell with its leader; both packages give the same rows, fingerprints,
    parent rounds and clock, and the scenario's oracle holds."""
    got = chip_smoke.zone_churn_run(Simulator, SimConfig, LatencyTopology, Endpoint,
                                    cell_leaders, seed=19, zones=4, per_zone=64, device="cpu")
    want = chip_smoke.zone_churn_run(JaxSimulator, JaxSimConfig, JaxTopology, JaxEndpoint,
                                     jax_cell_leaders, seed=19, zones=4, per_zone=64)
    assert got == want
    assert got["fingerprint_ok"]
    assert str(got["lost_zone"]) not in got["cells"] and len(got["cells"]) == 3
    assert 0 < got["parent_rounds"] <= len(got["records"]) + 1
    cut = sorted(c for rec in got["records"] for c in rec["cut"])
    assert cut == sorted(got["scatter"] + [i for i in range(256) if (i % 8) % 4 == got["lost_zone"]])


@pytest.mark.parametrize("leaders_per_cell", [1, 3])
def test_crash_with_cells_twin(leaders_per_cell):
    """scenarios.py's crash scenario with ``cells=4`` (rendezvous cells):
    the composition after the view change, the parent round and its
    journal entry alike on both packages."""
    out = []
    for make in (JaxSimulator, _port_sim):
        rng = np.random.default_rng(5)
        sim = make(600, seed=5)
        sim.enable_hierarchy(cells=4, parent_round_ms=3, leaders_per_cell=leaders_per_cell)
        cells_of = [sim.cell_of_slot(s) for s in range(600)]
        before = sim.global_fingerprint()
        victims = rng.choice(600, size=6, replace=False)
        sim.crash(victims)
        rec = sim.run_until_decision(max_rounds=32, batch=16)
        assert rec is not None and set(int(c) for c in rec.cut) == set(int(v) for v in victims)
        rows = [(r.cell, r.epoch, r.size, r.leader, r.fingerprint) for r in sim.hierarchy_rows()]
        incremental = sim.global_fingerprint()
        for cell in range(4):
            sim._hierarchy_recompute_cell(cell)
        assert incremental == sim.global_fingerprint() != before
        journal = [(e["kind"], e["virtual_ms"],
                    {k: v for k, v in e["detail"].items() if k != "trace_id"})
                   for e in sim.recorder.tail() if e["kind"] == "parent_round"]
        out.append((cells_of, rows, before, incremental, sim.parent_rounds, sim.virtual_ms,
                    journal, sim.metrics.get("hierarchy.parent_rounds"),
                    sim.metrics.gauges().get("hierarchy.cells"), sim.hierarchy_enabled))
    assert out[0] == out[1]
    assert out[1][4] == 1 and len(set(out[1][0])) == 4


def test_one_cell_and_no_hierarchy():
    for make in (JaxSimulator, _port_sim):
        sim = make(16, seed=2)
        assert not sim.hierarchy_enabled and sim.parent_rounds == 0
        sim.enable_hierarchy()
        assert sim.hierarchy_enabled and len(sim.hierarchy_rows()) == 1


def test_batched_rendezvous_equals_cell_of_endpoint():
    """The simulator assigns every slot's cell with the batched endpoint
    hash; each equals the scalar rendezvous of both packages."""
    sim = _port_sim(300, seed=9)
    for cells in (2, 5, 16):
        sim.enable_hierarchy(cells=cells)
        for slot in range(300):
            host, port = sim.endpoint_of(slot)
            want = jcells.cell_of_endpoint(JaxEndpoint(host, port), cells)
            assert sim.cell_of_slot(slot) == want
            assert pcells.cell_of_endpoint(Endpoint(host, port), cells) == want


def test_cells_and_parent_functions_match_jax():
    eps = [Endpoint.from_parts(f"10.2.{i // 50}.{i % 50}", 6000 + i) for i in range(120)]
    jeps = [JaxEndpoint(e.hostname, e.port) for e in eps]
    topo, jtopo = LatencyTopology(racks=6, zones=3), JaxTopology(racks=6, zones=3)
    slots = {e: i for i, e in enumerate(eps)}
    jslots = {e: i for i, e in enumerate(jeps)}
    assert pcells.cell_count(0) == jcells.cell_count(0) == 1
    assert pcells.cell_count(0, topo) == jcells.cell_count(0, jtopo) == 3
    for cells in (1, 4):
        assert {k: [str(e) for e in v] for k, v in pcells.cell_members(eps, cells).items()} == {
            k: [str(e) for e in v] for k, v in jcells.cell_members(jeps, cells).items()}
        assert pcells.cell_sizes(eps, cells, topo, slots) == jcells.cell_sizes(
            jeps, cells, jtopo, jslots)
    for n in (1, 3):
        assert [str(e) for e in pparent.cell_leaders(eps, n)] == [
            str(e) for e in jparent.cell_leaders(jeps, n)]
    assert pparent.parent_configuration_id(eps[:9]) == jparent.parent_configuration_id(jeps[:9])
    assert pparent.cell_fingerprint(eps) == jparent.cell_fingerprint(jeps)
    rows = [pparent.CellState(cell=c, epoch=-c * 77, size=c + 3, leader=str(eps[c]),
                              fingerprint=c * 5) for c in range(5)]
    jrows = [jparent.CellState(cell=r.cell, epoch=r.epoch, size=r.size, leader=r.leader,
                               fingerprint=r.fingerprint) for r in rows]
    assert [r.row_hash() for r in rows] == [r.row_hash() for r in jrows]
    assert pparent.compose_fingerprint(rows[::-1]) == jparent.compose_fingerprint(jrows)
    view, jview = pparent.GlobalView(), jparent.GlobalView()
    for r, jr in zip(rows, jrows):
        assert view.install(r) and jview.install(jr)
    assert not view.install(rows[0]) and view.evict_cell(4) and not view.evict_cell(4)
    jview.evict_cell(4)
    assert view.fingerprint() == jview.fingerprint() and view.digest() == jview.digest()
    assert view.member_count() == jview.member_count() and view.leaders() == jview.leaders()
