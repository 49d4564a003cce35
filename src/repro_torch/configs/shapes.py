"""Assigned input-shape set for the LM-family architectures.

``train_*`` lowers ``train_step``; ``prefill_*`` lowers a forward prefill;
``decode_*`` / ``long_*`` lower ``serve_step`` (one new token against a KV cache
of ``seq_len``). ``long_500k`` requires sub-quadratic attention and is skipped
(with a recorded reason) for pure full-attention archs.
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig

SHAPES = {
    "train_4k": ShapeConfig("train_4k", seq_len=4_096, global_batch=256, kind="train"),
    "prefill_32k": ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill"),
    "decode_32k": ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, kind="decode"),
    "long_500k": ShapeConfig("long_500k", seq_len=524_288, global_batch=1, kind="long_decode"),
}

SHAPE_NAMES = tuple(SHAPES)


def applicability(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, Optional[str]]:
    """(runnable, skip_reason). Skips follow the assignment rules."""
    if shape.kind == "long_decode" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: 524k-token decode needs "
                       "sub-quadratic attention (assignment rule; see docs/DESIGN.md)")
    return True, None
