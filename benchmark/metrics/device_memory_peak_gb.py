def read(run):
    """Peak device memory of the run in GB (1e9 bytes): the CUDA
    allocator's high-water mark over set-up and the window
    (torch.cuda.max_memory_allocated), read by the harness once the window
    has closed and before the reference runs.  None without a card."""
    peak = run.get("memory_peak_bytes")
    return peak / 1e9 if peak else None
