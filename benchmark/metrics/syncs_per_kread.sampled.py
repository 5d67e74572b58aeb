import sys

COUNTER = "host.sync"


def read(run):
    """Deliberate device-to-host read-backs (counter host.sync) per 1,000
    reads.  The counters are the run's, or else the program's own
    registry (utils/metrics.counters): it is reset where the stages are,
    and nothing of the program runs between the window and this reading.
    A program without the counter gives None."""
    c = run.get("counters")
    if c is None:
        registry = sys.modules.get("salt_tpu_torch.utils.metrics")
        c = getattr(registry, "counters", dict)()
    if not run["staged_units"] or COUNTER not in c:
        return None
    return c[COUNTER] * 1000.0 / run["staged_units"]
