"""Runtime support for the port's device plane (``jitwatch.py``)."""
