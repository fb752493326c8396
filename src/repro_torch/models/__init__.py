"""The model stack on PyTorch: configs in ``common``, layers, attention,
mamba and MoE blocks, the top-level ``transformer`` API and ``weights``, the
converter from the reference's parameter trees."""
