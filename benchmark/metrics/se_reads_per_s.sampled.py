def read(run):
    """Reads returned as SAM a second over the calls the stage timers
    read: every call of an untraced run, where it equals the rate over the
    whole window; in a traced run the calls after the profiled one."""
    if not run["staged_units"] or not run.get("staged_s"):
        return None
    return run["staged_units"] / run["staged_s"]
