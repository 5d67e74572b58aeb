STAGES = ("host.rescue_prefilter", "host.rescue",)


def read(run):
    """PE rescue (K2 pre-filter, whose device.sw_score stage it holds, and host SSW) ms per 1,000 pairs."""
    s = run["stages"]
    if not run["staged_units"] or not any(n in s for n in STAGES):
        return None
    return sum(s.get(n, 0.0) for n in STAGES) * 1e6 / run["staged_units"]
