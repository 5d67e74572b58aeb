STAGES = ("host.emit",)


def read(run):
    """The per-read loop of host finalize (span host.emit: MAPQ, LV CIGARs,
    XA, SAM lines) ms per 1,000 reads."""
    s = run["stages"]
    if not run["staged_units"] or not any(n in s for n in STAGES):
        return None
    return sum(s.get(n, 0.0) for n in STAGES) * 1e6 / run["staged_units"]
