"""The forensics plane's clock (``hlc.py``), as the simulator uses it."""
