"""Configuration knobs the port reads.

The port's copy of ``ProfilingSettings`` and its ``profiling.*`` bounds from
``rapid_tpu/settings.py`` (the only settings the simulator plane takes).
"""

from __future__ import annotations

from dataclasses import dataclass

# Bounds for every profiling knob, keyed "profiling.<field>": each
# ProfilingSettings field has an entry here with its legal [min, max] range.
SETTINGS_CATALOG = {
    "profiling.enabled": {
        "min": 0, "max": 1,
        "doc": "kill switch: False runs the raw dispatch loop with zero "
               "profiling work on any path",
    },
    "profiling.sample_every_dispatches": {
        "min": 1, "max": 1000000,
        "doc": "shadow-profile one of every N device dispatches (1 = every "
               "dispatch; large N keeps steady-state overhead negligible)",
    },
    "profiling.history_interval_ms": {
        "min": 1, "max": 3600000,
        "doc": "minimum spacing between metric history-ring snapshots",
    },
    "profiling.history_capacity": {
        "min": 4, "max": 65536,
        "doc": "history-ring size before the oldest half is downsampled",
    },
}


@dataclass(frozen=True)
class ProfilingSettings:
    """Knobs for the continuous profiling plane (``profiling/``). Defaults
    are conservative: profiling is off (``enabled=False`` leaves the
    dispatch loop untouched) and, when on, shadow attribution samples only
    one of every ``sample_every_dispatches`` dispatches. Bounds live in
    SETTINGS_CATALOG. The JAX package's ``overhead_budget_pct`` is left out:
    the port has no overhead check to read it yet."""

    enabled: bool = False
    sample_every_dispatches: int = 16
    history_interval_ms: int = 1000
    history_capacity: int = 128

    def __post_init__(self) -> None:
        for key, value in (
            ("enabled", int(self.enabled)),
            ("sample_every_dispatches", self.sample_every_dispatches),
            ("history_interval_ms", self.history_interval_ms),
            ("history_capacity", self.history_capacity),
        ):
            bounds = SETTINGS_CATALOG[f"profiling.{key}"]
            assert bounds["min"] <= value <= bounds["max"], (
                f"profiling.{key}={value!r} outside "
                f"[{bounds['min']}, {bounds['max']}]"
            )
