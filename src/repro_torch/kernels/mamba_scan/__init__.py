from .ops import mamba_scan, mamba_scan_bwd  # noqa: F401
