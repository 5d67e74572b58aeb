STAGES = ("host.cigar",)


def read(run):
    """The gapped reads' LV CIGARs and MD/NM/XV tags, one native call a
    batch inside host.emit (span host.cigar), ms per 1,000 reads.  A
    program without the span gives None."""
    s = run["stages"]
    if not run["staged_units"] or not any(n in s for n in STAGES):
        return None
    return sum(s.get(n, 0.0) for n in STAGES) * 1e6 / run["staged_units"]
