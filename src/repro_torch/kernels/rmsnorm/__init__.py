from .ops import rmsnorm, rmsnorm_bwd  # noqa: F401
