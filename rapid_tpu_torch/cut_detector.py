"""Multi-node cut detection with H/L watermarks.

The port's own copy of ``rapid_tpu/cut_detector.py``.

Reference: MultiNodeCutDetector.java. A view-change proposal about a node is
emitted only once H of its K observer reports have arrived AND no other node
sits in the unstable (L, H) report band -- this filter is what yields
almost-everywhere agreement on the cut before consensus runs.

Semantics preserved exactly:
- one report per (destination, ring) counts; duplicates ignored
  (MultiNodeCutDetector.java:97-101)
- L-th report moves the destination into the pre-proposal set and bumps
  ``updates_in_progress`` (:104-107)
- H-th report moves it into the proposal set; the proposal is emitted only when
  ``updates_in_progress`` drains to zero (:109-124)
- implicit detection: edges between failing nodes are invalidated so a report
  from an observer that is itself failing does not wedge the cut (:137-164)
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, TYPE_CHECKING

from .types import AlertMessage, EdgeStatus, Endpoint

if TYPE_CHECKING:  # pragma: no cover
    from .membership import MembershipView
    from .observability import Metrics, Tracer

K_MIN = 3


class MultiNodeCutDetector:
    def __init__(self, k: int, h: int, l: int) -> None:
        if h > k or l > h or k < K_MIN or l <= 0 or h <= 0:
            raise ValueError(
                f"arguments do not satisfy K >= H >= L > 0, K >= {K_MIN}: K={k} H={h} L={l}"
            )
        self.k = k
        self.h = h
        self.l = l
        # telemetry plane (optional): bound by the owning MembershipService
        self._metrics: Optional["Metrics"] = None
        self._tracer: Optional["Tracer"] = None
        self._proposal_count = 0
        self._updates_in_progress = 0
        self._reports_per_host: Dict[Endpoint, Dict[int, Endpoint]] = {}
        self._proposal: Set[Endpoint] = set()
        self._pre_proposal: Set[Endpoint] = set()
        self._seen_link_down_events = False

    def bind_telemetry(self, metrics: "Metrics", tracer: "Tracer") -> None:
        self._metrics = metrics
        self._tracer = tracer

    @property
    def num_proposals(self) -> int:
        return self._proposal_count

    def occupancy(self) -> Dict[str, int]:
        """Watermark occupancy for the introspection RPC: how many subjects
        have reports at all, how many crossed L (unstable band), how many
        crossed H (stable, awaiting the band to drain), and the in-progress
        count that gates proposal emission."""
        return {
            "reports_tracked": len(self._reports_per_host),
            "pre_proposal_size": len(self._pre_proposal),
            "proposal_size": len(self._proposal),
            "updates_in_progress": self._updates_in_progress,
        }

    def aggregate_for_proposal(self, msg: AlertMessage) -> List[Endpoint]:
        """Apply one alert (all its ring numbers); returns emitted proposal or []."""
        proposals: List[Endpoint] = []
        for ring_number in msg.ring_numbers:
            proposals.extend(
                self._aggregate(msg.edge_src, msg.edge_dst, msg.edge_status, ring_number)
            )
        return proposals

    def _aggregate(
        self, link_src: Endpoint, link_dst: Endpoint, status: EdgeStatus, ring_number: int
    ) -> List[Endpoint]:
        assert ring_number <= self.k
        if status == EdgeStatus.DOWN:
            self._seen_link_down_events = True

        reports_for_host = self._reports_per_host.setdefault(link_dst, {})
        if ring_number in reports_for_host:
            return []  # duplicate announcement for this (dst, ring)
        reports_for_host[ring_number] = link_src
        num_reports = len(reports_for_host)

        if num_reports == self.l:
            self._updates_in_progress += 1
            self._pre_proposal.add(link_dst)

        if num_reports == self.h:
            self._pre_proposal.discard(link_dst)
            self._proposal.add(link_dst)
            self._updates_in_progress -= 1
            if self._updates_in_progress == 0:
                self._proposal_count += 1
                ret = list(self._proposal)
                self._proposal.clear()
                if self._metrics is not None:
                    self._metrics.incr("cut.proposals_emitted")
                if self._tracer is not None:
                    self._tracer.event("cut_detected", size=len(ret))
                return ret
        return []

    def invalidate_failing_edges(self, view: "MembershipView") -> List[Endpoint]:
        """Implicit detection of edges between failing nodes
        (MultiNodeCutDetector.java:137-164)."""
        if not self._seen_link_down_events:
            return []
        proposals_to_return: List[Endpoint] = []
        for node_in_flux in list(self._pre_proposal):
            observers = (
                view.get_observers_of(node_in_flux)
                if view.is_host_present(node_in_flux)
                else view.get_expected_observers_of(node_in_flux)
            )
            for ring_number, observer in enumerate(observers):
                if observer in self._proposal or observer in self._pre_proposal:
                    status = (
                        EdgeStatus.DOWN
                        if view.is_host_present(node_in_flux)
                        else EdgeStatus.UP
                    )
                    proposals_to_return.extend(
                        self._aggregate(observer, node_in_flux, status, ring_number)
                    )
        return proposals_to_return

    def clear(self) -> None:
        """Reset after a view change (MultiNodeCutDetector.java:169-178)."""
        self._reports_per_host.clear()
        self._proposal.clear()
        self._updates_in_progress = 0
        self._proposal_count = 0
        self._pre_proposal.clear()
        self._seen_link_down_events = False
