from .ops import mamba_scan  # noqa: F401
