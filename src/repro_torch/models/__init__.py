"""The model stack on PyTorch: configs, named mesh axes and ``shard_map``
in ``common``, layers, attention, mamba and MoE blocks (the expert-parallel
MoE among them), the top-level ``transformer`` API with its ``Dist`` and
``weights``, the converter from the reference's parameter trees."""

from .common import ModelConfig  # noqa: F401
