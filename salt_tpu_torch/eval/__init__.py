from .wgsim_eval import AlnEval, alneval  # noqa: F401
