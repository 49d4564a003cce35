"""Strategy plugin registry (torch port of ``repro.core.strategies``).

A ``Strategy`` declares its *capabilities* (carry, selector, value codec,
weighting, OPWA, wire format, megakernel eligibility, kernel codec); the
port's engines dispatch on those and never match strategy names — the same
contract, the same validation, and the same 8 built-ins as the reference
(see that module's docstring and docs/DESIGN.md §8 for the field table).
The wire-format pricing is host f64 arithmetic copied unchanged, so comm
times match the reference bit for bit; the int8/int4 value codecs are
written on torch tensors with the reference's exact op sequence.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "WireFormat", "Strategy", "StrategyRegistry", "REGISTRY",
    "register", "unregister", "get", "names",
    "DENSE32", "SPARSE32", "PACKED_INT8", "PACKED_INT4",
    "BITMASK_INT8", "BITMASK_INT4",
    "CODEC_LEVELS", "symmetric_dequantize", "quantization_scale",
    "round_mantissa", "scale_mantissa_bits",
    "int8_symmetric_codec", "int4_symmetric_codec",
]

#: bytes per survivor of the paper's reference sparse pair (int32 index +
#: f32 value) — the 2x factor inside ``core.bcrs.comm_time``'s
#: ``T = L + 2 * V_bits * cr / B``. Every wire format's effective CR is
#: normalized against this so the scheduler's time model needs no per-format
#: branches.
_REF_PAIR_BYTES = 8.0


# ------------------------------------------------------------- wire format
@dataclass(frozen=True)
class WireFormat:
    """Declarative bytes-on-the-wire model for one strategy.

    ``dense`` formats ship the full f32 vector (no index overhead); the
    authoritative dense round time is ``cost_model.uncompressed_round``
    (T = L + V_bits / B). Sparse formats ship ``index_bytes + value_bytes``
    per survivor plus ``overhead_bytes`` per client message (e.g. a
    quantization scale). ``mask_bits`` replaces (or supplements) the
    per-survivor index stream with a length-n bitmask: ``mask_bits`` bits
    per COORDINATE regardless of k — cheaper than idx32 whenever
    k/n > mask_bits/32 (1-bit mask beats 4-byte indices above ~3.1%
    density).
    """
    kind: str                      # human-readable, lands in docs/README
    dense: bool = False
    index_bytes: float = 4.0
    value_bytes: float = 4.0
    overhead_bytes: float = 0.0
    mask_bits: float = 0.0

    def bytes_on_wire(self, n_params: int, k) -> float:
        """Exact payload bytes one client uploads: ``k`` survivors out of
        ``n_params`` (``k`` ignored for dense formats)."""
        if self.dense:
            return 4.0 * n_params
        return (k * (self.index_bytes + self.value_bytes)
                + self.mask_bits * n_params / 8.0 + self.overhead_bytes)

    def cr_eff(self, cr, n_params: Optional[int] = None):
        """Effective ratio to plug into the paper's ``comm_time`` (Alg. 2),
        whose 2x factor prices the reference idx32+f32 pair: the cr that
        makes ``comm_time`` charge exactly this format's bytes-on-the-wire.
        Accepts scalars or numpy arrays (vectorized arithmetic).

        Dense formats return 1.0 — the legacy convention the straggler
        arrival ordering and the traced-sampling scan always used for
        fedavg (authoritative dense *round* accounting goes through
        ``uncompressed_round``, gated on ``wire.dense``). The reference
        sparse pair returns ``cr`` unchanged (bit-identical to the
        pre-registry accounting); packed formats scale it down honestly.
        """
        if self.dense:
            return cr * 0.0 + 1.0 if hasattr(cr, "shape") else 1.0
        pair = self.index_bytes + self.value_bytes
        eff = cr if pair == _REF_PAIR_BYTES else cr * (pair / _REF_PAIR_BYTES)
        if self.mask_bits:
            # n bits of mask == (mask_bits/8) bytes per coordinate: a
            # k-independent constant once normalized by the 8-byte ref pair
            eff = eff + self.mask_bits / (8.0 * _REF_PAIR_BYTES)
        if self.overhead_bytes:
            if not n_params:
                raise ValueError(
                    f"wire format {self.kind!r} has per-message overhead; "
                    "cr_eff needs n_params")
            eff = eff + self.overhead_bytes / (_REF_PAIR_BYTES * n_params)
        return eff


DENSE32 = WireFormat(kind="dense f32", dense=True)
SPARSE32 = WireFormat(kind="idx32 + f32", index_bytes=4.0, value_bytes=4.0)
PACKED_INT8 = WireFormat(kind="idx32 + int8 + scale32",
                         index_bytes=4.0, value_bytes=1.0,
                         overhead_bytes=4.0)
PACKED_INT4 = WireFormat(kind="idx32 + int4 + scale32",
                         index_bytes=4.0, value_bytes=0.5,
                         overhead_bytes=4.0)
BITMASK_INT8 = WireFormat(kind="bitmask + int8 + scale32",
                          index_bytes=0.0, value_bytes=1.0,
                          mask_bits=1.0, overhead_bytes=4.0)
BITMASK_INT4 = WireFormat(kind="bitmask + int4 + scale32",
                          index_bytes=0.0, value_bytes=0.5,
                          mask_bits=1.0, overhead_bytes=4.0)


# ------------------------------------------------------------- value codecs
#: symmetric grids: wire values live in [-levels, levels]
INT8_LEVELS = 127.0
INT4_LEVELS = 7.0
#: kernel-codec name -> quantization grid — the shared source of truth for
#: the torch codecs below AND the fused_merge kernel codec stage, so the
#: two lowerings cannot drift (docs/DESIGN.md §10)
CODEC_LEVELS = {"int8": INT8_LEVELS, "int4": INT4_LEVELS}


def scale_mantissa_bits(levels: float) -> int:
    """Mantissa bits kept in a symmetric-grid quantizer scale: with the
    quantized magnitude needing ``ceil(log2(levels + 1))`` significand bits,
    keeping ``23 - that`` mantissa bits in the scale makes every
    ``q * scale`` product exactly representable in f32 (product significand
    <= 24 bits). int8 (levels 127) -> 16 bits, int4 (levels 7) -> 20."""
    return 23 - math.ceil(math.log2(levels + 1.0))


def quantization_scale(absmax, levels):
    """Per-row absmax -> the symmetric ``[-levels, levels]`` grid scale.

    Same two deliberate deviations from the textbook ``absmax / levels`` as
    the reference (``repro.core.strategies.quantization_scale``), which make
    the codec bit-identical across lowerings: multiply by the f32-rounded
    reciprocal instead of dividing, then round the product (to nearest, ties
    to even) to ``scale_mantissa_bits(levels)`` mantissa bits so every
    ``q * scale`` dequantization product is exact in f32 — the EF residual
    ``corrected - q*scale`` is then the same value whether or not a compiler
    contracts it into an fma.

    A denormal product is flushed to zero: the reference's platforms (the
    TPU, and XLA on the CPU) flush f32 denormals in arithmetic, so a row
    whose absmax is that small gets scale 0 there (its values dequantize to
    exact zeros and EF keeps them). PyTorch keeps IEEE denormals, so the
    flush is written out here to give the same scale on every input.
    """
    # a fill on the device, not a host copy: a CUDA graph captures it
    recip = torch.full((), float(np.float32(1.0 / levels)),
                       dtype=torch.float32, device=absmax.device)
    scaled = absmax.to(torch.float32) * recip
    scaled = torch.where(scaled.abs() < torch.finfo(torch.float32).tiny,
                         torch.zeros_like(scaled), scaled)
    return round_mantissa(scaled, scale_mantissa_bits(levels))


def round_mantissa(x, mantissa_bits: int):
    """``lax.reduce_precision(x, exponent_bits=8, mantissa_bits)`` for f32:
    round to nearest, ties to even, on the int32 view — XLA's own recipe
    (add ``half-ulp - 1`` plus the kept lsb, then truncate). The 8 exponent
    bits are f32's own, so no exponent clamping happens; a carry out of the
    mantissa correctly bumps the exponent (and rounds the largest finite
    values to inf). NaN passes through unchanged."""
    if mantissa_bits >= 23:
        return x
    shift = 23 - mantissa_bits
    bits = x.contiguous().view(torch.int32)
    last = (bits >> shift) & 1
    bias = last + ((1 << (shift - 1)) - 1)
    rounded = ((bits + bias) & ~((1 << shift) - 1)).view(torch.float32)
    return torch.where(torch.isnan(x), x, rounded)


def symmetric_dequantize(values, scale, levels):
    """quantize-then-dequantize on the symmetric ``[-levels, levels]`` grid
    with a precomputed per-row ``scale`` (broadcastable against ``values``,
    from ``quantization_scale``). The op sequence is the reference's:
    ``where(scale > 0)`` guard (an all-zero row keeps scale 0 and stays
    exactly zero), a correctly rounded divide, ``torch.round`` (half to
    even, as ``jnp.round``), the clip, and the exact multiply. The
    ``fused_merge`` kernel's codec stage runs the same sequence."""
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(values / safe), -levels, levels)
    return q * scale


def _symmetric_codec(values, levels):
    v = values.to(torch.float32)
    axes = tuple(range(1, v.ndim))
    absmax = torch.amax(torch.abs(v), dim=axes, keepdim=True)
    return symmetric_dequantize(v, quantization_scale(absmax, levels), levels)


def int8_symmetric_codec(values, mask):
    """Per-client symmetric int8 quantization of the surviving values.

    values: [C, ...] dense-masked survivors (rank-agnostic — the scale
    reduces over ALL non-client axes, so per-leaf mesh layouts work
    unreshaped); mask: matching bool (unused — zeros round to exactly zero
    under the symmetric grid, so non-survivors stay zero).

    Returns the DEQUANTIZED f32 values — what the server reconstructs from
    the int8 wire payload. Feeding these to the EF residual update
    (``corrected - sent``) makes error feedback absorb the quantization
    error with no extra engine code.
    """
    del mask
    return _symmetric_codec(values, INT8_LEVELS)


def int4_symmetric_codec(values, mask):
    """Per-client symmetric int4 quantization (15-point grid) of the
    surviving values — same contract as ``int8_symmetric_codec`` at a
    quarter of the value-stream bytes. EF absorbs the (much larger)
    quantization error, which is what keeps the biased low-bit compressor
    sound (CFedAvg, arXiv 2106.07155)."""
    del mask
    return _symmetric_codec(values, INT4_LEVELS)


# ---------------------------------------------------------------- strategy
_CARRIES = ("none", "ef")
_SELECTORS = ("none", "topk")
_WEIGHTINGS = ("data", "bcrs")
_RESIDUAL_LAYOUTS = ("dense", "topk_complement")


@dataclass(frozen=True)
class Strategy:
    """Declarative capability record — see the module docstring for field
    semantics. Frozen + hashable, so it can key caches and counters."""
    name: str
    description: str = ""
    carry: str = "none"
    selector: str = "topk"
    value_codec: Optional[Callable] = None
    weighting: str = "data"
    overlap_weighted: bool = False
    wire: WireFormat = field(default=SPARSE32)
    megakernel: bool = True
    residual_layout: str = "dense"
    kernel_codec: Optional[str] = None

    @property
    def compresses(self) -> bool:
        """Whether clients sparsify before upload (drives compression work,
        schedule CRs, and the sparse-vs-dense accounting split)."""
        return self.selector != "none"

    @property
    def needs_residuals(self) -> bool:
        """Whether engines must allocate/thread/donate EF residual buffers."""
        return self.carry == "ef"


# ---------------------------------------------------------------- registry
class StrategyRegistry:
    """Name-keyed table of validated ``Strategy`` records (the builder-
    registry shape of SNIPPETS.md snippet 3, with duplicates refused instead
    of warned — two strategies silently swapping under one name is exactly
    the drift this registry exists to prevent)."""

    def __init__(self):
        self._strategies: dict = {}

    # -- registration ----------------------------------------------------
    def register(self, strategy: Strategy, *,
                 override: bool = False) -> Strategy:
        """Validate and register. Returns the strategy (decorator-friendly).

        Raises ``ValueError`` on duplicate names (unless ``override=True``)
        and on capability combinations no engine can honor — a registration-
        time error beats five engines failing differently at trace time.
        """
        self._validate(strategy)
        if strategy.name in self._strategies and not override:
            raise ValueError(
                f"strategy {strategy.name!r} is already registered "
                f"(registered: {', '.join(self.names())}); pass "
                "override=True to replace it")
        self._strategies[strategy.name] = strategy
        return strategy

    @staticmethod
    def _validate(strategy: Strategy) -> None:
        if not isinstance(strategy, Strategy):
            raise TypeError(f"expected Strategy, got {type(strategy)!r}")
        if not strategy.name or not isinstance(strategy.name, str):
            raise ValueError("strategy needs a non-empty string name")
        if strategy.carry not in _CARRIES:
            raise ValueError(
                f"strategy {strategy.name!r}: unknown carry "
                f"{strategy.carry!r} (one of {_CARRIES})")
        if strategy.selector not in _SELECTORS:
            raise ValueError(
                f"strategy {strategy.name!r}: unknown selector "
                f"{strategy.selector!r} (one of {_SELECTORS})")
        if strategy.weighting not in _WEIGHTINGS:
            raise ValueError(
                f"strategy {strategy.name!r}: unknown weighting "
                f"{strategy.weighting!r} (one of {_WEIGHTINGS})")
        if not isinstance(strategy.wire, WireFormat):
            raise ValueError(
                f"strategy {strategy.name!r}: wire must be a WireFormat, "
                f"got {type(strategy.wire)!r}")
        if strategy.kernel_codec is not None:
            if strategy.kernel_codec not in CODEC_LEVELS:
                raise ValueError(
                    f"strategy {strategy.name!r}: unknown kernel_codec "
                    f"{strategy.kernel_codec!r} (one of "
                    f"{tuple(CODEC_LEVELS)})")
            if strategy.value_codec is None:
                raise ValueError(
                    f"strategy {strategy.name!r}: kernel_codec names the "
                    "kernel lowering of a value_codec — declare the "
                    "value_codec it must stay bit-exact with")
        if strategy.value_codec is not None:
            if not callable(strategy.value_codec):
                raise ValueError(
                    f"strategy {strategy.name!r}: value_codec must be "
                    "callable")
            if strategy.carry != "ef":
                raise ValueError(
                    f"strategy {strategy.name!r}: a lossy value_codec "
                    "requires carry='ef' — without error feedback the "
                    "codec error is silently dropped bias")
            if strategy.megakernel and strategy.kernel_codec is None:
                raise ValueError(
                    f"strategy {strategy.name!r}: a value_codec strategy "
                    "may declare megakernel=True only with a kernel_codec "
                    "(the fused_merge dequantization stage that matches "
                    "its codec — see docs/DESIGN.md §10)")
        if strategy.residual_layout not in _RESIDUAL_LAYOUTS:
            raise ValueError(
                f"strategy {strategy.name!r}: unknown residual_layout "
                f"{strategy.residual_layout!r} (one of {_RESIDUAL_LAYOUTS})")
        if strategy.residual_layout == "topk_complement":
            if strategy.carry != "ef":
                raise ValueError(
                    f"strategy {strategy.name!r}: residual_layout="
                    "'topk_complement' describes EF residuals — requires "
                    "carry='ef'")
            if strategy.selector != "topk":
                raise ValueError(
                    f"strategy {strategy.name!r}: residual_layout="
                    "'topk_complement' holds only the dropped coordinates "
                    "of a Top-K selection — requires selector='topk'")
            if strategy.value_codec is not None:
                raise ValueError(
                    f"strategy {strategy.name!r}: a value_codec leaves "
                    "quantization error at the survivor coordinates, so "
                    "the EF residual is dense — declare "
                    "residual_layout='dense'")
        if strategy.selector == "none":
            if not strategy.wire.dense:
                raise ValueError(
                    f"strategy {strategy.name!r}: selector='none' ships "
                    "every coordinate — declare a dense wire format")
            if strategy.overlap_weighted:
                raise ValueError(
                    f"strategy {strategy.name!r}: overlap weighting needs "
                    "survivor masks — selector='none' has none")
        elif strategy.wire.dense:
            raise ValueError(
                f"strategy {strategy.name!r}: a sparsifying selector with "
                "a dense wire format would misprice every upload")

    def unregister(self, name: str) -> None:
        """Remove a registration (test teardown; built-ins removable too —
        there is nothing special about them)."""
        self._strategies.pop(name, None)

    # -- lookup ----------------------------------------------------------
    def get(self, name: str) -> Strategy:
        try:
            return self._strategies[name]
        except KeyError:
            raise ValueError(
                f"unknown strategy {name!r} (registered: "
                f"{', '.join(self.names())})") from None

    def names(self) -> Tuple[str, ...]:
        return tuple(self._strategies)

    def __contains__(self, name: str) -> bool:
        return name in self._strategies

    def __iter__(self):
        return iter(self._strategies.values())


#: the process-wide registry every engine/CLI/cost model reads
REGISTRY = StrategyRegistry()
register = REGISTRY.register
unregister = REGISTRY.unregister
get = REGISTRY.get
names = REGISTRY.names


# ---------------------------------------------------------------- built-ins
# The paper's five strategies (Alg. 1), re-registered through the public
# API — they get no private hooks, so they double as registration examples.
register(Strategy(
    name="fedavg",
    description="uniform data-weighted average, no compression",
    carry="none", selector="none", weighting="data",
    wire=DENSE32, megakernel=False))

register(Strategy(
    name="topk",
    description="data-weighted average of Top-K-compressed updates",
    carry="none", selector="topk", weighting="data",
    wire=SPARSE32, megakernel=True))

register(Strategy(
    name="eftopk",
    description="Top-K with client-side error-feedback residuals",
    carry="ef", selector="topk", weighting="data",
    wire=SPARSE32, megakernel=True, residual_layout="topk_complement"))

register(Strategy(
    name="bcrs",
    description="per-client CRs from the bandwidth schedule (Alg. 2) "
                "+ Eq. 6 coefficients",
    carry="none", selector="topk", weighting="bcrs",
    wire=SPARSE32, megakernel=True))

register(Strategy(
    name="bcrs_opwa",
    description="BCRS + overlap-aware parameter weighting (Alg. 3)",
    carry="none", selector="topk", weighting="bcrs",
    overlap_weighted=True, wire=SPARSE32, megakernel=True))

# Registry-only plugins (no engine file mentions them): quantized Top-K
# survivors — the FedSparQ sparsity-x-quantization direction. EF absorbs the
# quantization error; the packed wire formats (4+1 / 4+0.5 bytes/survivor +
# one f32 scale) make their comm accounting honest, 8/5x / 16/9x cheaper
# than idx32+f32 at equal sparsity. kernel_codec opts them into the Hopper
# pipeline: fused_merge quantizes/dequantizes in the tile pass with the
# scale threshold_find emitted (docs/DESIGN.md §10).
register(Strategy(
    name="qtopk",
    description="int8-quantized Top-K survivors with EF absorbing the "
                "quantization error; packed-bytes wire accounting",
    carry="ef", selector="topk", value_codec=int8_symmetric_codec,
    weighting="data", wire=PACKED_INT8, megakernel=True,
    kernel_codec="int8"))

register(Strategy(
    name="bitmask_topk",
    description="int8-quantized Top-K survivors shipped under a 1-bit "
                "coordinate bitmask instead of idx32 — cheaper than packed "
                "indices above ~3.1% density, and the built-in that "
                "exercises the BITMASK_* mask-bits pricing end-to-end",
    carry="ef", selector="topk", value_codec=int8_symmetric_codec,
    weighting="data", wire=BITMASK_INT8, megakernel=True,
    kernel_codec="int8"))

register(Strategy(
    name="int4",
    description="int4-quantized Top-K survivors (EF absorbs the error); "
                "idx32+int4 packed wire at 9/16 of the reference pair",
    carry="ef", selector="topk", value_codec=int4_symmetric_codec,
    weighting="data", wire=PACKED_INT4, megakernel=True,
    kernel_codec="int4"))
