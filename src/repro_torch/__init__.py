"""PyTorch/CUDA port of the BCRS + OPWA federated-learning stack.

The JAX package ``repro`` is the reference; this package mirrors its module
names (``repro_torch.core.bcrs`` <-> ``repro.core.bcrs`` and so on) and
imports neither ``jax`` nor anything of ``repro``. Entry points run on
``device="cuda"`` unless the caller passes ``device="cpu"``; the six Pallas
kernels of the ported paths (the fused round's ``threshold_find`` and
``fused_merge``; the block Top-K route's ``block_topk``, ``overlap_combine``
and ``ef_update``; the dense model's ``flash_attention``) are hand-written
CUDA C++ for Hopper (``csrc/``), built at first use by
``repro_torch.kernels.build``.
"""
import torch

# The port is held to the JAX reference in float32 (ROADMAP "held against the
# reference"): TF32 keeps ~10 mantissa bits, which would move the local SGD
# deltas far outside the parity tolerances, so both TF32 switches are pinned
# off explicitly instead of relying on PyTorch's defaults (matmul already
# defaults to off, cuDNN convolutions default to on).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# The dense model's bf16 matmuls are the reference's bf16-out dot
# (``models.layers.mm``): f32 accumulation, one rounding to bf16 at the end.
# cuBLAS may otherwise reduce split-K partial sums in bf16.
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
