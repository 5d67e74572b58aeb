def read(run):
    """Kernels, copies and memsets in the profiled call per 1,000 reads."""
    t = run["trace"]
    if not t or not t["device_ops"]:
        return None
    return t["device_ops"] * 1000.0 / t["units"]
