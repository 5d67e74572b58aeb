def read(run):
    """Seconds from the import of the port to the end of its warm-up call."""
    return run["setup_s"]
