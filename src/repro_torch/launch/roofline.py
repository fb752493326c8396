"""Three-term roofline report from a step's cost count (the counterpart of
``src/repro/launch/roofline.py``).

The rates are the H100's data-sheet values in the port's one record of the
card (``kernels.costs.H100``): bf16 and fp16 products on the tensor cores
at 989 TFLOP/s, f32 products and the kernels' elementwise arithmetic on
the CUDA cores at 67 TFLOP/s, HBM3 at 3.35 TB/s, and NVLink 4 at 450 GB/s
a direction where the reference prices its TPU's ICI link.  Every cost
from ``hlo_analysis`` is per device per step, so the terms are seconds
per step on one card.

The reference prices every FLOP at the bf16 peak, because its CPU
backend upcasts bf16 dots in the HLO it reads.  The port's trace carries
each op's true dtype, so each dtype is priced at its own rate.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass

from ..configs import SHAPES
from ..kernels.costs import H100
from ..models.common import ModelConfig
from .hlo_analysis import HloCosts

PEAK_BF16 = H100.tensor_flops
PEAK_F32 = H100.peak_flops
HBM_BW = H100.hbm_bw
ICI_BW = H100.link_bw


@dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops_per_dev: float
    hlo_flops_per_dev: float
    useful_ratio: float       # MODEL_FLOPS / traced FLOPs
    step_s: float             # max of the three terms (perfect overlap bound)
    roofline_fraction: float  # (MODEL_FLOPS / bf16 peak) / step_s

    def to_dict(self):
        return asdict(self)


def shape_of(shape_name) -> tuple[int, int, str]:
    """(seq_len, global_batch, kind) of a ``SHAPES`` name, or of such a
    triple itself (a shape outside the table, as the card's checks use)."""
    if isinstance(shape_name, str):
        return SHAPES[shape_name]
    seq, batch, kind = shape_name
    return int(seq), int(batch), str(kind)


def model_flops(cfg: ModelConfig, shape_name) -> float:
    """Global MODEL_FLOPS per step: 6*N_active*D for training, 2*N_active*D
    for inference (D = tokens processed)."""
    seq, batch, kind = shape_of(shape_name)
    n = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n * seq * batch
    if kind == "prefill":
        return 2.0 * n * seq * batch
    return 2.0 * n * batch  # decode: one token per sequence


def roofline(costs: HloCosts, cfg: ModelConfig, shape_name,
             n_devices: int) -> Roofline:
    compute_s = (costs.flops_bf16 / PEAK_BF16
                 + (costs.flops_f32 + costs.vector_ops) / PEAK_F32)
    memory_s = costs.hbm_bytes / HBM_BW
    collective_s = costs.total_collective_bytes / ICI_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape_name) / n_devices
    step = max(terms.values())
    return Roofline(
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant,
        model_flops_per_dev=mf,
        hlo_flops_per_dev=costs.flops,
        useful_ratio=mf / costs.flops if costs.flops else 0.0,
        step_s=step,
        roofline_fraction=(mf / PEAK_BF16) / step if step else 0.0)
