"""The dense decoder-only model: init, prefill and KV-cache decode.

Port of the dense family of ``repro.models.transformer.Model`` (stablelm,
yi, qwen: MHA or GQA, optional QKV bias). Params are nested dicts whose
layer stack carries a leading ``[L, ...]`` axis; the forward walks it with
a Python loop (no remat at inference). The KV cache is ``{"k", "v"}`` of
``[L, B, S, Hkv, D]``, written in place by ``decode_step``.

A sliding ``window`` (with its ``global_layers``) is honoured per layer, as
in the reference. Other families wait for their ROADMAP item (queue 1,
item 7b) and raise ``NotImplementedError`` when the model is built.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (_dtype, apply_mlp, dense_init,
                                       embed_init, embed_lookup, init_mlp,
                                       pad_vocab, rms_norm)

Params = Dict[str, Any]


def layer_params(tree, i: int):
    """Layer ``i`` of a stacked ``[L, ...]`` params tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    return tree[i]


def _stack(trees):
    """List of per-layer params trees -> one tree with a leading L axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _unsupported(cfg: ModelConfig) -> Optional[str]:
    if cfg.family != "dense":
        return f"family {cfg.family!r}"
    for opt in ("mla", "moe", "ssm", "rwkv", "encdec", "vision"):
        if getattr(cfg, opt) is not None:
            return f"option {opt!r}"
    return None


class Model:
    def __init__(self, cfg: ModelConfig, device="cuda"):
        what = _unsupported(cfg)
        if what is not None:
            raise NotImplementedError(
                f"{cfg.name}: {what} is not ported yet; the port runs the "
                "dense family (ROADMAP queue 1, item 7b: the moe, mla, "
                "hybrid, ssm, encdec and vlm families)")
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
        return {
            "embed": {"w": embed_init(gen, (self.v_pad, d), self.dtype)},
            "final_norm": torch.ones((d,), dtype=torch.float32,
                                     device=self.device),
            "lm_head": {"w": dense_init(gen, d, (d, self.v_pad), self.dtype)},
            "layers": self._init_stack(gen, cfg.n_layers,
                                       self._init_dense_block),
        }

    def _init_stack(self, gen, n, init_one):
        return _stack([init_one(gen) for _ in range(n)])

    def _init_dense_block(self, gen):
        cfg = self.cfg
        ones = lambda: torch.ones((cfg.d_model,), dtype=torch.float32,
                                  device=self.device)
        return {"attn": attn.init_attention(
                    gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim, self.dtype, cfg.qkv_bias),
                "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act,
                                self.dtype),
                "ln1": ones(),
                "ln2": ones()}

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
        x = x + attn.self_attention(p["attn"], h, cfg=cfg,
                                    positions=positions, causal=True,
                                    window=window, chunk=chunk)
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + apply_mlp(p["mlp"], h2, cfg.act)

    def _backbone(self, params, x, positions) -> torch.Tensor:
        """Token embeddings -> final hidden states."""
        wins = self._window_flags()
        for i in range(self.cfg.n_layers):
            x = self._block_fwd(layer_params(params["layers"], i), x,
                                positions, None if wins is None else wins[i])
        return x

    # ================================================================ caches
    def init_cache(self, batch: int, seq: int,
                   dtype=torch.bfloat16) -> Params:
        cfg = self.cfg
        shape = (cfg.n_layers, batch, seq, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                "v": torch.zeros(shape, dtype=dtype, device=self.device)}

    # ================================================================= decode
    def decode_step(self, params, cache, tokens, pos
                    ) -> Tuple[torch.Tensor, Params]:
        """One-token decode. tokens: [B] int; pos: int. Returns the logits
        [B, v_pad] and the cache (written in place)."""
        cfg = self.cfg
        x = embed_lookup(params["embed"]["w"], tokens)       # [B, d]
        x, cache = self._decode_dense(params, cache, x, pos)
        h = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return h @ params["lm_head"]["w"], cache

    def _decode_block(self, p, x, kc, vc, pos, window):
        cfg = self.cfg
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        a, kc, vc = attn.decode_self_attention(p["attn"], h, kc, vc, pos,
                                               cfg=cfg, window=window)
        x = x + a
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + apply_mlp(p["mlp"], h2, cfg.act), kc, vc

    def _decode_dense(self, params, cache, x, pos):
        wins = self._window_flags()
        for i in range(self.cfg.n_layers):
            # cache["k"][i] is a view: the block writes the stacked cache
            x, _, _ = self._decode_block(layer_params(params["layers"], i), x,
                                         cache["k"][i], cache["v"][i], pos,
                                         None if wins is None else wins[i])
        return x, cache

    # ================================================================ prefill
    def prefill(self, params, batch) -> Tuple[torch.Tensor, None]:
        """Forward over the prompt ``batch["tokens"]`` [B, S], returning the
        last-token logits [B, v_pad] and no cache, as the reference's dense
        prefill does."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = embed_lookup(params["embed"]["w"], tokens)
        positions = torch.arange(tokens.shape[1], device=x.device)
        x = self._backbone(params, x, positions)
        h = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return h[:, -1, :] @ params["lm_head"]["w"], None
