from .tokens import TokenPipeline  # noqa: F401
