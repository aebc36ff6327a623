"""setup_s: seconds from the process's start to the first timed episode:
imports, the card's context, kernel loads (and a first run's builds), the
simulator's build and one warm-up failure episode and wave. Host clock."""


def read(run):
    return run.setup_s
