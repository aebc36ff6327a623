"""Runtime support: the device plane's sync watchdog (``jitwatch.py``), and
for the protocol plane the promise (``futures.py``), the clocks
(``scheduler.py``) and the lock-order checker (``lockdep.py``)."""
