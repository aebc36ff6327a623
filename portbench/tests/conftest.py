"""Shared pieces of the harness's tests: a tiny cell of each mix, run on
the CPU through the harness's own path."""

from __future__ import annotations

import pytest

from portbench import spec

TINY_MEMBERS = 1000


def tiny_cell(mix: str, members: int = TINY_MEMBERS, burst_fraction: float = 0.004,
              per_layer=("view_change_ms.mean", "dispatch_ms.per_round")) -> spec.Cell:
    """The rapid-100k configuration at ``members`` members, under ``mix``
    with a burst of ``burst_fraction``; every end-to-end metric."""
    config = dict(spec.config_by_name("rapid-100k"), members=members, capacity=members)
    traffic = dict(spec.traffic_by_name(mix), burst_fraction=burst_fraction)
    e2e = [spec.Metric(n, "u", spec.reader(n))
           for n in ("view_changes_per_s", "setup_s")]
    layers = [spec.Metric(n, "u", spec.reader(n)) for n in per_layer]
    return spec.Cell(f"tiny.{mix}", 1, config, traffic, e2e, layers)


@pytest.fixture(params=["crash-burst", "lossy-burst"])
def mix(request):
    return request.param
