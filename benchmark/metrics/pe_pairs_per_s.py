def read(run):
    """Pairs returned as SAM over all the timed seconds of the window."""
    return run["units"] / run["timed_s"]
