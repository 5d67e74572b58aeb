STAGES = ("device.seed",)


def read(run):
    """Seeding (span device.seed: LF steps and the greedy extension with its
    read-back a round) ms per 1,000 reads, host clock."""
    s = run["stages"]
    if not run["staged_units"] or not any(n in s for n in STAGES):
        return None
    return sum(s.get(n, 0.0) for n in STAGES) * 1e6 / run["staged_units"]
