"""Config dataclasses for models, shapes, and runtime (a copy of the JAX
package's ``configs/base.py``: pure data, kept here so the port imports
nothing of that package).

Every assigned architecture gets a module ``configs/<id>.py`` exposing
``config() -> ModelConfig`` with the exact published numbers, plus
``ModelConfig.reduced()`` for CPU smoke tests (same family, tiny dims).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden dim
    n_shared: int = 0             # shared (always-on) experts
    d_shared: int = 0             # shared expert hidden dim (0 -> d_expert)
    first_dense_layers: int = 0   # leading layers that use a dense FFN instead
    capacity_factor: float = 1.25
    router_noise: float = 0.0
    aux_loss_weight: float = 0.001


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Chunked-SSD style SSM branch (hymba) — per-head scalar decay, state=16."""
    state_size: int = 16
    expand: int = 2               # d_inner = expand * d_model
    head_dim: int = 64            # SSD head dim
    chunk: int = 128


@dataclass(frozen=True)
class RWKVConfig:
    head_size: int = 64
    decay_lora: int = 64          # rank of the data-dependent decay LoRA
    gate_lora: int = 64
    chunk: int = 128


@dataclass(frozen=True)
class EncDecConfig:
    n_enc_layers: int = 24
    max_target_len: int = 448     # informational; decode shapes override


@dataclass(frozen=True)
class VisionConfig:
    n_cross_layers: int = 8       # gated cross-attn layers, every `interval` blocks
    interval: int = 5             # one cross layer per `interval` self layers
    n_patches: int = 1024         # stub frontend: precomputed patch embeddings
    d_vision: int = 1280


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "swiglu"           # swiglu | gelu
    # sliding-window hybrid attention (hymba): window size; layers in
    # `global_layers` use full attention.
    window: Optional[int] = None
    global_layers: Tuple[int, ...] = ()
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    encdec: Optional[EncDecConfig] = None
    vision: Optional[VisionConfig] = None
    mtp_depth: int = 0            # deepseek multi-token-prediction extra layers
    dtype: str = "bfloat16"       # params/activations dtype for full-scale runs
    # distribution hints
    fsdp_threshold: int = 8_000_000_000  # params >= threshold -> FSDP over data
    remat: str = "full"           # full | dots | none
    source: str = ""

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def attn_free(self) -> bool:
        return self.rwkv is not None

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch can decode at 500k context (SSM / linear / SWA-hybrid)."""
        return self.rwkv is not None or (self.ssm is not None and self.window is not None)

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, L, V = self.d_model, self.n_layers, self.vocab_size
        hd = self.resolved_head_dim
        n = V * d  # embedding
        if not self.tie_embeddings:
            n += V * d  # lm head
        for layer in range(L):
            # attention
            if self.mla is not None:
                m = self.mla
                qk = m.qk_nope_head_dim + m.qk_rope_head_dim
                n += d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qk
                n += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                n += m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                n += self.n_heads * m.v_head_dim * d
            elif self.rwkv is None:
                n += d * self.n_heads * hd          # q
                n += 2 * d * self.n_kv_heads * hd   # k, v
                n += self.n_heads * hd * d          # o
            # ffn / moe (rwkv counts its channel-mix separately below)
            if self.moe is not None and layer >= self.moe.first_dense_layers:
                mo = self.moe
                n += d * mo.n_experts                       # router
                n += mo.n_experts * 3 * d * mo.d_expert     # routed experts
                ds = mo.d_shared or mo.d_expert
                n += mo.n_shared * 3 * d * ds               # shared experts
            elif self.rwkv is None:
                mult = 3 if self.act == "swiglu" else 2
                n += mult * d * self.d_ff
            # ssm branch
            if self.ssm is not None:
                di = self.ssm.expand * d
                n += d * 2 * di + di * d + di * 2 * self.ssm.state_size + 2 * di
            if self.rwkv is not None:
                # time-mix r,k,v,g,o + decay lora + channel-mix
                n += 5 * d * d + 2 * d * self.rwkv.decay_lora
                n += d * self.d_ff + self.d_ff * d + d * d
            n += 2 * d  # norms
        if self.encdec is not None:
            e = self.encdec
            for _ in range(e.n_enc_layers):
                n += d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
                n += (3 if self.act == "swiglu" else 2) * d * self.d_ff + 2 * d
            # decoder cross-attn
            n += L * (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d + d)
        if self.vision is not None:
            v = self.vision
            n += v.d_vision * d  # projector
            n += v.n_cross_layers * (2 * (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                                          + self.n_heads * hd * d) // 2 + 3 * d * self.d_ff + 2 * d)
        return n

    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.n_params()
        mo = self.moe
        dense_expert_params = mo.n_experts * 3 * self.d_model * mo.d_expert
        active_expert_params = mo.top_k * 3 * self.d_model * mo.d_expert
        n_moe_layers = self.n_layers - mo.first_dense_layers
        return self.n_params() - n_moe_layers * (dense_expert_params - active_expert_params)

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dict(
            name=self.name + "-reduced",
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            dtype="float32",
            remat="none",
        )
        if self.moe is not None:
            kw["moe"] = MoEConfig(n_experts=4, top_k=2, d_expert=32,
                                  n_shared=self.moe.n_shared, d_shared=32,
                                  first_dense_layers=min(1, self.moe.first_dense_layers),
                                  capacity_factor=2.0)
        if self.mla is not None:
            kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                                  qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)
        if self.ssm is not None:
            kw["ssm"] = SSMConfig(state_size=4, expand=2, head_dim=16, chunk=16)
        if self.rwkv is not None:
            kw["rwkv"] = RWKVConfig(head_size=16, decay_lora=8, gate_lora=8, chunk=16)
            kw["n_heads"] = 4
            kw["n_kv_heads"] = 4
        if self.encdec is not None:
            kw["encdec"] = EncDecConfig(n_enc_layers=2, max_target_len=32)
        if self.vision is not None:
            kw["vision"] = VisionConfig(n_cross_layers=1, interval=2, n_patches=8, d_vision=32)
        if self.window is not None:
            kw["window"] = 8
            kw["global_layers"] = (0,)
        if self.mtp_depth:
            kw["mtp_depth"] = 1
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode | long_decode

    @property
    def is_decode(self) -> bool:
        return self.kind in ("decode", "long_decode")


@dataclass(frozen=True)
class RunConfig:
    """Training/serving runtime knobs."""
    optimizer: str = "sgd"        # sgd | momentum | adamw
    learning_rate: float = 1e-2
    weight_decay: float = 0.0
    grad_clip: float = 0.0
    # compression (paper technique, applied to DP/pod gradient sync or FL updates)
    compression: str = "none"     # none | topk | eftopk | randk
    compression_ratio: float = 0.1
    bcrs: bool = False
    opwa: bool = False
    opwa_gamma: float = 5.0
    opwa_overlap_threshold: int = 1
    server_lr: float = 1.0        # alpha
    block_size: int = 8192        # block top-k block size
    # checkpointing
    checkpoint_dir: str = ""
    checkpoint_every: int = 50
    keep_checkpoints: int = 3
