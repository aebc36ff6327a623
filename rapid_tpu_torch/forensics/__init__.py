"""The forensics plane: the hybrid logical clock and the outbound stamping
client (``hlc.py``) and incident evidence bundles (``bundle.py``)."""
