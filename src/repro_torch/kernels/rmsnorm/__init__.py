from .ops import rmsnorm  # noqa: F401
