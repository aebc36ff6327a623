"""The forensics plane, the port's own copy of ``rapid_tpu/forensics/``:
the hybrid logical clock and the outbound stamping client (``hlc.py``),
incident evidence bundles (``bundle.py``), and the causal cluster timeline
with its anomaly-signature detectors (``timeline.py``;
``rapid_tpu_torch.cli.forensics`` is its CLI face)."""

from .hlc import HlcClock, HlcStamp, hlc_of, stamp_hlc
from .bundle import (
    BUNDLE_SCHEMA_VERSION,
    bundle_fingerprint,
    capture_local_evidence,
    write_bundle,
)
from .timeline import (
    SIGNATURE_CATALOG,
    TimelineEvent,
    detect_signatures,
    merge_timeline,
)

__all__ = [
    "HlcClock",
    "HlcStamp",
    "hlc_of",
    "stamp_hlc",
    "BUNDLE_SCHEMA_VERSION",
    "bundle_fingerprint",
    "capture_local_evidence",
    "write_bundle",
    "SIGNATURE_CATALOG",
    "TimelineEvent",
    "detect_signatures",
    "merge_timeline",
]
