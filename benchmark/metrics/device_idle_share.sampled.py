def read(run):
    """Per cent of the profiled call's wall time in which no kernel, copy
    or memset ran on the device."""
    t = run["trace"]
    if not t or not t["device_ops"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
