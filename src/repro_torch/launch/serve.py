"""Batched serving CLI (port of ``repro/launch/serve.py``): prefill a
batch of prompts by stepping the decode cache one forced token at a time,
then decode tokens step by step against the per-layer cache.

``python -m repro_torch.launch.serve --arch smollm-135m --reduced --batch 4
--prompt-len 32 --gen 16 [--device cpu]``

Runs on ``cuda:0`` unless ``--device`` says otherwise.  Weights are random
from ``--seed`` (a ``torch.Generator``); so is the sampling.  This route
never reaches K8: the whole-sequence prefill that does is
``models.make_prefill_step``.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.device import resolve_device, synchronize
from repro_torch.models import (ModelConfig, init_decode_cache, init_params,
                                make_serve_step)


def generate(params, cfg: ModelConfig, prompts: np.ndarray, gen: int,
             temperature: float, generator: torch.Generator,
             device: torch.device) -> Dict[str, object]:
    """Stepwise prefill of ``prompts`` [B, P] and ``gen`` decoded tokens.
    Temperature 0 is greedy.  Returns the tokens [B, gen] and the wall
    times of both phases (each ending in a device sync)."""
    batch, prompt_len = prompts.shape
    step = make_serve_step(cfg)
    cache = init_decode_cache(cfg, batch, prompt_len + gen, device)
    toks = torch.as_tensor(prompts, dtype=torch.int32, device=device)

    t0 = time.perf_counter()
    logits = None
    for t in range(prompt_len):
        logits, cache = step(params, cache, {"tokens": toks[:, t:t + 1]})
    synchronize(device)
    t_prefill = time.perf_counter() - t0

    out: List[torch.Tensor] = []
    t0 = time.perf_counter()
    for _ in range(gen):
        lg = logits[:, -1, :cfg.vocab].float()
        if temperature > 0:
            probs = torch.softmax(lg / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)
        else:
            tok = lg.argmax(-1, keepdim=True)
        tok = tok.to(torch.int32)
        out.append(tok)
        logits, cache = step(params, cache, {"tokens": tok})
    synchronize(device)
    t_decode = time.perf_counter() - t0
    tokens = torch.cat(out, dim=1).cpu().numpy() if out else \
        np.zeros((batch, 0), np.int32)
    return dict(tokens=tokens, prefill_s=t_prefill, decode_s=t_decode)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda:0)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_arch(args.arch, reduced=args.reduced)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, generator, device)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len),
                           dtype=np.int32)
    res = generate(params, cfg, prompts, args.gen, args.temperature,
                   generator, device)

    t_prefill, t_decode = res["prefill_s"], res["decode_s"]
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen}")
    print(f"prefill: {t_prefill*1e3:.1f} ms "
          f"({args.batch*args.prompt_len/t_prefill:.0f} tok/s)")
    print(f"decode:  {t_decode*1e3:.1f} ms "
          f"({args.batch*args.gen/t_decode:.0f} tok/s)")
    print("sampled token ids (first row):",
          res["tokens"][0].tolist())  # type: ignore[index]
    return res


if __name__ == "__main__":
    main()
