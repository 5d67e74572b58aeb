import sys

COUNTER = "sa_walk.blocks"


def read(run):
    """Column blocks of candidate slots that the sampled-mode locate walks
    (counter sa_walk.blocks, one a resolve_sampled call) per 1,000
    reads.  The counters are the run's, or else the program's own
    registry (utils/metrics.counters), as syncs_per_kread.se reads them.
    A program without the counter gives None."""
    c = run.get("counters")
    if c is None:
        registry = sys.modules.get("salt_tpu_torch.utils.metrics")
        c = getattr(registry, "counters", dict)()
    if not run["staged_units"] or COUNTER not in c:
        return None
    return c[COUNTER] * 1000.0 / run["staged_units"]
