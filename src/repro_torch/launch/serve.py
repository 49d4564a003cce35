"""Serving driver: batched prefill + greedy decode with KV / recurrent
caches.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \\
        [--reduced] [--batch 4 --prompt-len 16 --gen 32] [--device cuda]

Port of ``repro.launch.serve`` for the families the port runs: dense
(stablelm-1.6b, yi-9b, qwen2.5-*), hybrid (hymba-1.5b), ssm (rwkv6-1.6b),
encdec (whisper-medium) and vlm (llama-3.2-vision-11b). Random weights
from ``--seed``, the prompt prefilled by stepping ``decode_step`` over it
(cache-exact, any prompt length), then greedy argmax over the real
vocabulary. As in the reference, no frames or patches are drawn and the
cross-attention caches stay zero, so whisper and the vlm decode without
the audio or the image (ROADMAP §3, R5). Runs on the card unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.device import resolve_device, synchronize
from repro_torch.models import Model


def generate(model: Model, params, prompt: torch.Tensor, gen: int,
             cache_dtype=torch.bfloat16) -> Dict[str, Any]:
    """Greedy serving of a batch of prompts [B, P]: a cache of P + gen
    positions, the prompt stepped through ``decode_step`` (cache-exact; a
    fused forward exists as ``model.prefill``), then ``gen`` tokens by argmax
    over the real vocabulary.

    Returns ``tokens`` (numpy [B, gen]), ``prompt_logits`` (the logits after
    the last prompt token), ``logits`` (after the last decode step, which
    made no token), ``t_prefill`` and ``t_gen`` (host seconds, each ending
    in a device synchronize)."""
    device = model.device
    b, prompt_len = prompt.shape
    cache = model.init_cache(b, prompt_len + gen, cache_dtype)
    with torch.no_grad():
        t0 = time.time()
        logits = None
        for pos in range(prompt_len):
            logits, cache = model.decode_step(params, cache, prompt[:, pos],
                                              pos)
        synchronize(device)
        t_prefill = time.time() - t0
        prompt_logits = logits

        toks = torch.argmax(logits[:, : model.cfg.vocab_size], -1)
        out = [toks.cpu().numpy()]
        t0 = time.time()
        for i in range(gen - 1):
            logits, cache = model.decode_step(params, cache, toks,
                                              prompt_len + i)
            toks = torch.argmax(logits[:, : model.cfg.vocab_size], -1)
            out.append(toks.cpu().numpy())
        t_gen = time.time() - t0
    return dict(tokens=np.stack(out, 1), prompt_logits=prompt_logits,
                logits=logits, t_prefill=t_prefill, t_gen=t_gen)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="stablelm-1.6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Model(cfg, device)
    rng = np.random.default_rng(args.seed)
    params = model.init(args.seed)
    prompt = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)),
        device=device)
    res = generate(model, params, prompt, args.gen,
                   torch.float32 if args.reduced else torch.bfloat16)
    gen, t_prefill, t_gen = res["tokens"], res["t_prefill"], res["t_gen"]
    print(f"[serve] arch={args.arch} batch={args.batch} "
          f"prefill {args.prompt_len} tok in {t_prefill:.2f}s; "
          f"generated {gen.shape[1]} tok in {t_gen:.2f}s "
          f"({args.batch * gen.shape[1] / max(t_gen, 1e-9):.1f} tok/s)")
    print("[serve] sample tokens:", gen[0, :16].tolist())
    assert bool(torch.isfinite(res["logits"]).all())


if __name__ == "__main__":
    main()
