"""Model configuration shared by all assigned architectures.

The counterpart of ``src/repro/models/common.py``: ``ModelConfig`` field for
field.  The reference's ``shard_map`` and ``axis_size`` wrappers belong to
its mesh code and come with the port's ``launch/mesh`` (ROADMAP.md).  The
distribution knobs (``remat``, ``fsdp``, ``moe_mode``, ``expert_shards``)
are kept so configs and plan artifacts read the same; on one card the
port's model ignores all of them but ``expert_shards``, which pads the
expert axis as the reference's parameters do.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                # dense | moe | mla_moe | ssm | hybrid | encoder | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0          # 0 -> d_model // n_heads

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0

    # MLA (DeepSeek)
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128

    # SSM (Mamba)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_version: int = 1       # 1 = mamba1 (falcon-mamba), 2 = mamba2 (zamba2)
    ssm_heads: int = 0         # mamba2 heads (d_inner // head dim of 64)

    # hybrid (zamba2): one weight-shared attention block applied every k layers
    attn_every: int = 0

    # flags
    qkv_bias: bool = False
    qk_norm: bool = False
    mrope: bool = False        # M-RoPE (qwen2-vl): 3-section rotary
    causal: bool = True        # False -> encoder-only (hubert)
    embedding_inputs: bool = False  # modality stub: inputs are embeddings
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    # distribution / perf knobs (overridable per run / by GEVO-Shard)
    remat: str = "none"        # none | full  — activation checkpoint per layer
    moe_mode: str = "dense"    # dense | ep_a2a  (decode always uses gather)
    expert_shards: int = 1     # pad expert dim so it divides this (EP width)
    attn_impl: str = "naive"   # naive | blockwise (flash-style, O(S) memory)
    attn_block: int = 512      # q/kv block for blockwise attention
    loss_chunk: int = 0        # seq-chunked xent head (0 = full logits)
    fsdp: bool = True          # ZeRO-3 weight sharding over the DP axes
    ssm_impl: str = "ssd"      # ssd | naive — mamba2 scan formulation
    gnorm_vdot: bool = False   # True reproduces the vdot grad-norm bug (A/B)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def scaled(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + layers), for 6ND math."""
        d, v = self.d_model, self.vocab
        emb = v * d * 2  # in + out embedding (untied)
        per_layer = 0
        if self.family in ("dense", "moe", "vlm", "encoder", "mla_moe"):
            if self.mla:
                q = d * self.q_lora_rank + self.q_lora_rank * self.n_heads * (
                    self.qk_nope_dim + self.qk_rope_dim)
                kv = d * (self.kv_lora_rank + self.qk_rope_dim) + \
                    self.kv_lora_rank * self.n_heads * (
                        self.qk_nope_dim + self.v_head_dim)
                o = self.n_heads * self.v_head_dim * d
                attn = q + kv + o
            else:
                attn = d * self.hd * (self.n_heads + 2 * self.n_kv_heads) \
                    + self.n_heads * self.hd * d
            if self.n_experts:
                ff = 3 * d * self.moe_d_ff * (self.n_experts
                                              + self.n_shared_experts) \
                    + d * self.n_experts
            else:
                ff = 3 * d * self.d_ff
            per_layer = attn + ff
        elif self.family in ("ssm", "hybrid"):
            di, n = self.d_inner, self.ssm_state
            # in_proj (x,z), conv, dt/B/C projections, out_proj
            per_layer = d * di * 2 + di * self.ssm_conv + di * (2 * n + 2) \
                + di * d
        n_param = emb + self.n_layers * per_layer
        if self.family == "hybrid" and self.attn_every:
            # ONE weight-shared attention + MLP block
            shared = 4 * d * self.n_heads * self.hd + 3 * d * self.d_ff
            n_param += shared
        return int(n_param)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        all_expert = 3 * d * self.moe_d_ff * self.n_experts * self.n_layers
        active_expert = 3 * d * self.moe_d_ff * self.top_k * self.n_layers
        return int(full - all_expert + active_expert)
