"""Edge failure detectors: the port's copy of ``rapid_tpu/monitoring/``."""
