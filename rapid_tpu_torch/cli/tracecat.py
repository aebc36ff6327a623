#!/usr/bin/env python
"""Merge per-node Chrome traces into one cluster-wide timeline.

The port's counterpart of ``tools/tracecat.py``: merging the port's
per-node traces gives the same file as the JAX tool would.

Each rapid_tpu_torch process exports its own ``chrome_trace`` JSON with timestamps
relative to that process's first span -- loading two of them side by side in
Perfetto puts both nodes at t=0 and the causal order is lost. This tool
merges N per-node trace files into a single file:

- every input's processes are re-numbered to unique pids and renamed
  ``<label>/<plane>`` so each node keeps its own process rows;
- wall-clock rows are offset-aligned across inputs using the virtual-time
  track the exporter dual-emits: a span that appears on both its wall row
  and the ``virtual-time (ms)`` row (matched by ``args.span_id``) yields one
  ``virtual_ts - wall_ts`` sample, and the per-input mean of those samples
  shifts that input's wall rows onto the shared virtual axis. Inputs with no
  virtual samples are left at their own zero;
- the per-input virtual-time processes are merged into ONE shared
  ``virtual-time (ms)`` process (the axis is cluster-global by construction);
- ``--trace-id`` keeps only the spans of one distributed trace, so a single
  churn episode -- fd_signal on the observer through view_change on every
  member -- can be read end to end.

Stdlib only; usable as a library (``merge_traces``) or a CLI:

    python -m rapid_tpu_torch.cli.tracecat node1.json node2.json -o merged.json
    python -m rapid_tpu_torch.cli.tracecat --trace-id 42 node*.json
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

VIRTUAL_PROCESS_NAME = "virtual-time (ms)"


def _virtual_pid(events: List[dict]) -> Optional[int]:
    for ev in events:
        if (
            ev.get("ph") == "M"
            and ev.get("name") == "process_name"
            and ev.get("args", {}).get("name") == VIRTUAL_PROCESS_NAME
        ):
            return ev.get("pid")
    return None


def _wall_offset_us(events: List[dict], virtual_pid: Optional[int]) -> float:
    """Mean (virtual_ts - wall_ts) over dual-emitted spans: the shift that
    maps this input's wall rows onto the shared virtual axis."""
    if virtual_pid is None:
        return 0.0
    virtual_ts: Dict[int, int] = {}
    for ev in events:
        if ev.get("ph") == "X" and ev.get("pid") == virtual_pid:
            span_id = ev.get("args", {}).get("span_id")
            if span_id is not None:
                virtual_ts.setdefault(span_id, ev["ts"])
    samples = [
        virtual_ts[ev["args"]["span_id"]] - ev["ts"]
        for ev in events
        if ev.get("ph") == "X"
        and ev.get("pid") != virtual_pid
        and ev.get("args", {}).get("span_id") in virtual_ts
    ]
    if not samples:
        return 0.0
    return sum(samples) / len(samples)


def merge_traces(
    traces: List[dict],
    labels: Optional[List[str]] = None,
    trace_id: Optional[int] = None,
) -> dict:
    """Merge chrome_trace dicts (one per node) into a single timeline."""
    if labels is None:
        labels = [f"node{i}" for i in range(len(traces))]
    assert len(labels) == len(traces)
    merged: List[dict] = []
    merged_virtual_pid = 1  # pid 1 is the shared virtual axis
    next_pid = 2
    next_virtual_tid = 1
    merged.append({
        "ph": "M", "pid": merged_virtual_pid, "name": "process_name",
        "args": {"name": VIRTUAL_PROCESS_NAME},
    })
    for label, trace in zip(labels, traces):
        events = trace.get("traceEvents", [])
        virtual_pid = _virtual_pid(events)
        offset = _wall_offset_us(events, virtual_pid)
        pid_map: Dict[int, int] = {}
        virtual_tid_map: Dict[int, int] = {}
        for ev in events:
            pid = ev.get("pid")
            is_virtual = virtual_pid is not None and pid == virtual_pid
            out = dict(ev)
            if "args" in ev:
                out["args"] = dict(ev["args"])
            if is_virtual:
                out["pid"] = merged_virtual_pid
                tid = ev.get("tid")
                if tid is not None:
                    if tid not in virtual_tid_map:
                        virtual_tid_map[tid] = next_virtual_tid
                        next_virtual_tid += 1
                    out["tid"] = virtual_tid_map[tid]
            else:
                if pid not in pid_map:
                    pid_map[pid] = next_pid
                    next_pid += 1
                out["pid"] = pid_map[pid]
            if ev.get("ph") == "M":
                if is_virtual and ev.get("name") == "process_name":
                    continue  # the shared axis is already declared once
                if ev.get("name") == "process_name":
                    out["args"]["name"] = f"{label}/{ev['args']['name']}"
                elif is_virtual and ev.get("name") == "thread_name":
                    out["args"]["name"] = f"{label}/{ev['args']['name']}"
                merged.append(out)
                continue
            if trace_id is not None and (
                ev.get("args", {}).get("trace_id") != trace_id
            ):
                continue
            if not is_virtual:
                out["ts"] = int(round(ev["ts"] + offset))
            merged.append(out)
    return {"traceEvents": merged, "displayTimeUnit": "ms"}


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="merge per-node Chrome traces into one timeline"
    )
    parser.add_argument("traces", nargs="+", help="per-node chrome_trace JSON files")
    parser.add_argument("-o", "--output", default=None,
                        help="output path (default: stdout)")
    parser.add_argument("--trace-id", type=int, default=None,
                        help="keep only spans of this distributed trace")
    args = parser.parse_args(argv)
    loaded: List[dict] = []
    labels: List[str] = []
    for path in args.traces:
        with open(path) as fh:
            loaded.append(json.load(fh))
        stem = path.rsplit("/", 1)[-1]
        labels.append(stem[:-5] if stem.endswith(".json") else stem)
    merged = merge_traces(loaded, labels=labels, trace_id=args.trace_id)
    text = json.dumps(merged)
    if args.output is None:
        sys.stdout.write(text + "\n")
    else:
        with open(args.output, "w") as fh:
            fh.write(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
