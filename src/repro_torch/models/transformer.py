"""Decoder-only models: init, the training loss, prefill and cached decode.

Port of ``repro.models.transformer.Model`` for three families:
  * dense (stablelm, yi, qwen: MHA or GQA, optional QKV bias);
  * hybrid (hymba: GQA sliding-window attention and a parallel SSD branch,
    mixed as ``0.5 * (rms_norm(a) + rms_norm(s))``);
  * ssm (rwkv6: time-mix and channel-mix blocks behind a layer norm);
each with ``init``, ``loss_fn``, ``init_cache``, ``decode_step`` and
``prefill``.
Params are nested dicts whose layer stack carries a leading ``[L, ...]``
axis; the forward walks it with a Python loop. Under autograd each block is
checkpointed as ``cfg.remat`` says (``_remat``: "full", "dots" or
"none"), as the reference wraps its scanned blocks; with grad mode off
(serving) no block is. The caches are stacked ``[L, ...]`` too and written
in place by ``decode_step``: ``{"k", "v"}`` of ``[L, B, S, Hkv, D]``, for
hybrid also ``"ssm": {"conv", "state"}``, for ssm ``{"tm_x", "cm_x",
"wkv"}``.

A sliding ``window`` (with its ``global_layers``) is honoured per layer, as
in the reference. The moe, encdec and vlm families wait for their ROADMAP
item (queue 1, item 3) and raise ``NotImplementedError`` when the model is
built.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mamba, rwkv6
from repro_torch.models.layers import (_dtype, apply_mlp, cross_entropy,
                                       dense_init, embed_init, embed_lookup,
                                       embed_onehot, init_mlp, layer_norm,
                                       pad_vocab, rms_norm)

Params = Dict[str, Any]


def _save_mm(ctx, op, *args, **kwargs):
    """The "dots" policy: keep what ``aten.mm`` computes, recompute the
    rest. ``x @ W`` with a 2-D weight folds to ``mm``, so this keeps the
    products with no batch dimension, as the reference's
    ``dots_with_no_batch_dims_saveable``; attention's and GLA's batched
    products (``bmm``) are recomputed."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, mode: str):
    """``fn`` checkpointed as the reference's ``_remat``: "none" returns it
    unchanged, "dots" keeps the matmul outputs (``_save_mm``) and any
    other mode recomputes the whole block in the backward. Non-reentrant,
    so ``torch.autograd.grad`` works through it; no RNG state (nothing
    draws randomness, and saving it would read the generator inside a CUDA
    graph capture). A recompute runs the same ops on the same inputs, so
    the three modes give the same bits."""
    if mode == "none":
        return fn
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if mode == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_mm)
    return functools.partial(checkpoint, fn, **kw)


def layer_params(tree, i: int):
    """Layer ``i`` of a stacked ``[L, ...]`` params tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    return tree[i]


def unstack_layers(tree, n: int):
    """A stacked ``[L, ...]`` params tree -> L per-layer trees, each leaf
    unbound once (views). Under autograd each stacked leaf then gets one
    backward that stacks the L layer gradients, where indexing layer by
    layer (``layer_params``) would give each layer's gradient as a
    zero-filled full ``[L, ...]`` tensor to be summed L times."""
    if isinstance(tree, dict):
        per_key = {k: unstack_layers(v, n) for k, v in tree.items()}
        return [{k: per_key[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _stack(trees):
    """List of per-layer params trees -> one tree with a leading L axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


#: the families the port runs, each with the config options it may set
_PORTED = {"dense": (), "hybrid": ("ssm",), "ssm": ("rwkv",)}


def _unsupported(cfg: ModelConfig) -> Optional[str]:
    if cfg.family not in _PORTED:
        return f"family {cfg.family!r}"
    for opt in ("mla", "moe", "ssm", "rwkv", "encdec", "vision"):
        if getattr(cfg, opt) is not None and opt not in _PORTED[cfg.family]:
            return f"option {opt!r}"
    return None


def _zeros_stacked(n: int, tree):
    """A per-layer cache tree -> fresh zeros of ``[n, ...]`` for each leaf
    (its own storage per layer, so a layer's in-place write stays in it)."""
    return {k: torch.zeros((n,) + tuple(v.shape), dtype=v.dtype,
                           device=v.device) for k, v in tree.items()}


class Model:
    def __init__(self, cfg: ModelConfig, device="cuda"):
        what = _unsupported(cfg)
        if what is not None:
            raise NotImplementedError(
                f"{cfg.name}: {what} is not ported yet; the port runs the "
                "dense, hybrid and ssm families (ROADMAP queue 1, item 3: "
                "the moe, mla, encdec and vlm families)")
        self.cfg = cfg
        self.dtype = _dtype(cfg.dtype)
        self.v_pad = pad_vocab(cfg.vocab_size, 256)
        self.device = resolve_device(device)

    # =================================================================== init
    def init(self, seed: Union[int, torch.Generator]) -> Params:
        """Random params drawn from ``seed`` (an int, or a generator on the
        model's device)."""
        gen = seed
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
        cfg = self.cfg
        d = cfg.d_model
        p = {
            "embed": {"w": embed_init(gen, (self.v_pad, d), self.dtype)},
            "final_norm": self._ones(),
            "lm_head": {"w": dense_init(gen, d, (d, self.v_pad), self.dtype)},
        }
        if cfg.family == "ssm":
            p["ln0_s"] = self._ones()
            p["ln0_b"] = self._zeros()
            # read by nothing; kept so that trees and checkpoints match
            p["final_norm_b"] = self._zeros()
            p["layers"] = self._init_stack(gen, cfg.n_layers,
                                           self._init_rwkv_block)
        else:  # dense / hybrid
            p["layers"] = self._init_stack(gen, cfg.n_layers,
                                           self._init_block)
        return p

    def _ones(self):
        return torch.ones((self.cfg.d_model,), dtype=torch.float32,
                          device=self.device)

    def _zeros(self):
        return torch.zeros((self.cfg.d_model,), dtype=torch.float32,
                           device=self.device)

    def _init_stack(self, gen, n, init_one):
        return _stack([init_one(gen) for _ in range(n)])

    def _init_dense_block(self, gen):
        cfg = self.cfg
        return {"attn": attn.init_attention(
                    gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim, self.dtype, cfg.qkv_bias),
                "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act,
                                self.dtype),
                "ln1": self._ones(),
                "ln2": self._ones()}

    def _init_block(self, gen):
        cfg = self.cfg
        p = self._init_dense_block(gen)
        if cfg.ssm is not None:  # hymba hybrid: parallel SSM branch
            p["ssm"] = mamba.init_ssm(gen, cfg.d_model, cfg.ssm, self.dtype)
            p["attn_out_norm"] = self._ones()
            p["ssm_out_norm"] = self._ones()
        return p

    def _init_rwkv_block(self, gen):
        cfg = self.cfg
        return {"tm": rwkv6.init_time_mix(gen, cfg.d_model, cfg.rwkv,
                                          self.dtype),
                "cm": rwkv6.init_channel_mix(gen, cfg.d_model, cfg.d_ff,
                                             self.dtype),
                "ln1_s": self._ones(), "ln1_b": self._zeros(),
                "ln2_s": self._ones(), "ln2_b": self._zeros()}

    # ============================================================== forward
    def _window_flags(self) -> Optional[List[int]]:
        """Per-layer effective window (int32 max // 2 for global layers:
        effectively no window), or None without a sliding window."""
        cfg = self.cfg
        if cfg.window is None:
            return None
        wins = [cfg.window] * cfg.n_layers
        for g in cfg.global_layers:
            wins[g] = (2 ** 31 - 1) // 2
        return wins

    def _block_fwd(self, p, x, positions, window=None, chunk=512):
        cfg = self.cfg
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        a = attn.self_attention(p["attn"], h, cfg=cfg, positions=positions,
                                causal=True, window=window, chunk=chunk)
        if cfg.ssm is not None:
            s = mamba.apply_ssm(p["ssm"], h, d_model=cfg.d_model,
                                ssm_cfg=cfg.ssm)
            x = x + 0.5 * (rms_norm(a, p["attn_out_norm"], cfg.norm_eps)
                           + rms_norm(s, p["ssm_out_norm"], cfg.norm_eps))
        else:
            x = x + a
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + apply_mlp(p["mlp"], h2, cfg.act)

    def _rwkv_block_fwd(self, p, x):
        cfg = self.cfg
        h = layer_norm(x, p["ln1_s"], p["ln1_b"], cfg.norm_eps)
        x = x + rwkv6.apply_time_mix(p["tm"], h, n_heads=cfg.n_heads,
                                     rwkv_cfg=cfg.rwkv)
        h = layer_norm(x, p["ln2_s"], p["ln2_b"], cfg.norm_eps)
        return x + rwkv6.apply_channel_mix(p["cm"], h)

    def _backbone(self, params, x, positions) -> torch.Tensor:
        """Token embeddings -> final hidden states. With grad mode on, each
        block runs under ``_remat(..., cfg.remat)``."""
        cfg = self.cfg
        layers = unstack_layers(params["layers"], cfg.n_layers)
        remat = cfg.remat if torch.is_grad_enabled() else "none"
        if cfg.family == "ssm":
            x = layer_norm(x, params["ln0_s"], params["ln0_b"], cfg.norm_eps)
            body = _remat(self._rwkv_block_fwd, remat)
            for p in layers:
                x = body(p, x)
            return x
        body = _remat(self._block_fwd, remat)
        wins = self._window_flags()
        for i, p in enumerate(layers):
            x = body(p, x, positions, None if wins is None else wins[i])
        return x

    # ================================================================= losses
    def loss_fn(self, params, batch) -> Tuple[torch.Tensor,
                                              Dict[str, torch.Tensor]]:
        """Mean next-token CE of ``batch`` ({"tokens", "labels"} [B, S])
        -> ``(loss, {"ce": ce})``, the reference's loss for every family
        outside encdec and vlm (the MoE aux and MTP terms belong to
        families not ported yet). The embedding is the one-hot contraction
        (``layers.embed_onehot``), so the gradient is the same from run to
        run on the card. The ssm family's ``ln0`` is ``_backbone``'s; its
        ``final_norm_b`` is read by nothing, so autograd gives it no
        gradient (the trainers turn that into zeros, the reference's)."""
        cfg = self.cfg
        tokens, labels = batch["tokens"], batch["labels"]
        x = embed_onehot(params["embed"]["w"], tokens)
        positions = torch.arange(tokens.shape[1], device=x.device)
        x = self._backbone(params, x, positions)
        h = rms_norm(x, params["final_norm"], cfg.norm_eps)
        ce = cross_entropy(h @ params["lm_head"]["w"], labels,
                           cfg.vocab_size)
        return ce, {"ce": ce}

    # ================================================================ caches
    def init_cache(self, batch: int, seq: int,
                   dtype=torch.bfloat16) -> Params:
        """Zeroed caches, ``[L, ...]`` for every leaf. ``dtype`` is the K
        and V caches'; the recurrent states are f32 whatever it is, and so
        is hymba's conv history (the reference builds it with
        ``init_ssm_cache``'s default dtype)."""
        cfg = self.cfg
        L = cfg.n_layers
        if cfg.family == "ssm":
            return _zeros_stacked(L, rwkv6.init_rwkv_cache(
                batch, cfg.d_model, cfg.n_heads, cfg.rwkv, self.device))
        shape = (L, batch, seq, cfg.n_kv_heads, cfg.resolved_head_dim)
        cache = {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                 "v": torch.zeros(shape, dtype=dtype, device=self.device)}
        if cfg.family == "hybrid":
            cache["ssm"] = _zeros_stacked(L, mamba.init_ssm_cache(
                batch, cfg.d_model, cfg.ssm, device=self.device))
        return cache

    # ================================================================= decode
    def decode_step(self, params, cache, tokens, pos
                    ) -> Tuple[torch.Tensor, Params]:
        """One-token decode. tokens: [B] int; pos: int. Returns the logits
        [B, v_pad] and the cache (written in place)."""
        cfg = self.cfg
        x = embed_lookup(params["embed"]["w"], tokens)       # [B, d]
        if cfg.family == "ssm":
            x = layer_norm(x, params["ln0_s"], params["ln0_b"], cfg.norm_eps)
            x, cache = self._decode_rwkv(params, cache, x)
        else:
            x, cache = self._decode_dense(params, cache, x, pos)
        h = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return h @ params["lm_head"]["w"], cache

    def _decode_block(self, p, x, kc, vc, pos, window, ssm_cache=None):
        cfg = self.cfg
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        a, kc, vc = attn.decode_self_attention(p["attn"], h, kc, vc, pos,
                                               cfg=cfg, window=window)
        if ssm_cache is not None:
            s, _ = mamba.decode_ssm(p["ssm"], h, ssm_cache,
                                    d_model=cfg.d_model, ssm_cfg=cfg.ssm)
            x = x + 0.5 * (rms_norm(a, p["attn_out_norm"], cfg.norm_eps)
                           + rms_norm(s, p["ssm_out_norm"], cfg.norm_eps))
        else:
            x = x + a
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + apply_mlp(p["mlp"], h2, cfg.act), kc, vc

    def _decode_dense(self, params, cache, x, pos):
        """Dense and hybrid layers; every cache leaf's ``[i]`` is a view, so
        each block writes the stacked caches in place."""
        wins = self._window_flags()
        ssm = cache.get("ssm")
        for i in range(self.cfg.n_layers):
            x, _, _ = self._decode_block(
                layer_params(params["layers"], i), x, cache["k"][i],
                cache["v"][i], pos, None if wins is None else wins[i],
                None if ssm is None else layer_params(ssm, i))
        return x, cache

    def _decode_rwkv(self, params, cache, x):
        cfg = self.cfg
        for i in range(cfg.n_layers):
            p, c = layer_params(params["layers"], i), layer_params(cache, i)
            h = layer_norm(x, p["ln1_s"], p["ln1_b"], cfg.norm_eps)
            tm_out, _ = rwkv6.decode_time_mix(p["tm"], h, c,
                                              n_heads=cfg.n_heads,
                                              rwkv_cfg=cfg.rwkv)
            x = x + tm_out
            h = layer_norm(x, p["ln2_s"], p["ln2_b"], cfg.norm_eps)
            cm_out, _ = rwkv6.decode_channel_mix(p["cm"], h, c)
            x = x + cm_out
        return x, cache

    # ================================================================ prefill
    def prefill(self, params, batch) -> Tuple[torch.Tensor, None]:
        """Forward over the prompt ``batch["tokens"]`` [B, S], returning the
        last-token logits [B, v_pad] and no cache, as the reference's
        prefill does. The recurrent families need S to be a multiple of
        their GLA chunk (the reference asserts it; nothing is padded)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = embed_lookup(params["embed"]["w"], tokens)
        positions = torch.arange(tokens.shape[1], device=x.device)
        x = self._backbone(params, x, positions)
        h = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return h[:, -1, :] @ params["lm_head"]["w"], None
