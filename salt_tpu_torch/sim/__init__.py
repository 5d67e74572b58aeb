from .wgsim import simulate, wgsim_main  # noqa: F401
