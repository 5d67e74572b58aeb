import sys

LANES, SLOTS = "k4.lanes", "sa_walk.slots"


def read(run):
    """Share of the sampled-mode locate walk's slots that the CUDA kernel
    K4 walked: 100 x counter k4.lanes (lanes a K4 launch walks) over
    counter sa_walk.slots (lanes of every block walked, by either route).
    The counters are the run's, or else the program's own registry
    (utils/metrics.counters), as sa_walk_slots_per_kread.sampled reads
    them.  A program without either counter gives None."""
    c = run.get("counters")
    if c is None:
        registry = sys.modules.get("salt_tpu_torch.utils.metrics")
        c = getattr(registry, "counters", dict)()
    if LANES not in c or not c.get(SLOTS):
        return None
    return 100.0 * c[LANES] / c[SLOTS]
