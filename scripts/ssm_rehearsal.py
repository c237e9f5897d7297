"""Host rehearsal of the bounds of chip_smoke.py's lm_ssm phase.

    PYTHONPATH=src python scripts/ssm_rehearsal.py \
        {chain,depth,flash,host,reference}

Runs the port on the CPU at the published depths with the width cut
(rwkv6-1.6b at d 1,024, 16 heads of 64, d_ff 3,584; zamba2-7b at d 896,
8 heads of 112, d_ff 3,584; vocab 8,192; random weights), or at the
published width with the depth cut, and prints one JSON line per reading:

* ``chain``: 2 x 96 tokens teacher-forced through the serve step against
  one forward, in bf16 and in f32, and the bf16 forward against the same
  weights widened to f32 (seeds 0, 1);
* ``depth``: the f32 chain against the forward at rwkv6-1.6b's full width
  and depths 1, 2, 4, 8 (seed 0) and 4 (seed 1), and at zamba2-7b's first
  site (six Mamba layers and the shared block) at d 1,792, 16 heads of 112;
* ``flash``: zamba2-7b's bf16 prefill through K8's plain version against
  the blocked route and each against f32, 2 x 1,024 tokens (seeds 1, 2);
* ``host``: depth 1, 1 x 512 tokens, the loss and the worst gradient leaf
  (relative L2) in bf16 against f32 and in f32 against f64 (seeds 0-2);
* ``reference``: the JAX reference's rwkv6-1.6b at the same cut width, its
  bf16 forward over 2 x 96 tokens against the same weights in f32 (the
  only subcommand that imports JAX).

Minutes of CPU and a few GB of memory each.
"""
from __future__ import annotations

import dataclasses
import json
import sys

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.data import TokenPipeline
from repro_torch.models import (forward, init_decode_cache, init_params,
                                make_prefill_step, make_serve_step,
                                value_and_grad)
from repro_torch.models import lm as lm_module

RWKV = dataclasses.replace(get_arch("rwkv6-1.6b"), d_model=1024, n_heads=16,
                           n_kv=16, d_ff=3584, vocab=8192)
ZAMBA = dataclasses.replace(get_arch("zamba2-7b"), d_model=896, n_heads=8,
                            n_kv=8, d_ff=3584, vocab=8192, attn_impl="flash")


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def diff(a: torch.Tensor, b: torch.Tensor, vocab: int) -> dict:
    d = (a[..., :vocab].double() - b[..., :vocab].double()).abs()
    return dict(max=float(d.max()), mean=float(d.mean()))


def widened(model, cfg, dtype: str):
    """The same weights in a model of ``dtype`` (exact widening)."""
    wide = dataclasses.replace(cfg, dtype=dtype)
    out = init_params(wide, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        for (_, a), (_, b) in zip(out.named_parameters(),
                                  model.named_parameters()):
            a.copy_(b)
    return out, wide


def tokens(cfg, b: int, s: int, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s), dtype=np.int32))


def chain_and_forward(model, cfg, seq):
    step = make_serve_step(cfg)
    cache = init_decode_cache(cfg, seq.shape[0], seq.shape[1], "cpu")
    chain = torch.cat([step(model, cache, {"tokens": seq[:, t:t + 1]})[0]
                       for t in range(seq.shape[1])], 1)
    with torch.inference_mode():
        whole, _, _ = forward(model, cfg, {"tokens": seq})
    return chain, whole


def run_chain() -> None:
    for cfg in (RWKV, ZAMBA):
        for seed in (0, 1):
            model = init_params(cfg, torch.Generator().manual_seed(seed),
                                "cpu")
            seq = tokens(cfg, 2, 96, seed)
            chain16, whole16 = chain_and_forward(model, cfg, seq)
            m32, c32 = widened(model, cfg, "float32")
            chain32, whole32 = chain_and_forward(m32, c32, seq)
            emit(arch=cfg.name, seed=seed,
                 bf16_chain_vs_forward=diff(chain16, whole16, cfg.vocab),
                 bf16_forward_vs_f32=diff(whole16, whole32, cfg.vocab),
                 f32_chain_vs_forward=diff(chain32, whole32, cfg.vocab))


def run_depth() -> None:
    rwkv = dataclasses.replace(get_arch("rwkv6-1.6b"), dtype="float32")
    zamba = dataclasses.replace(get_arch("zamba2-7b"), dtype="float32",
                                d_model=1792, n_heads=16, n_kv=16,
                                d_ff=7168, n_layers=6, attn_impl="flash")
    cases = [(dataclasses.replace(rwkv, n_layers=n), 0) for n in (1, 2, 4, 8)]
    cases += [(dataclasses.replace(rwkv, n_layers=4), 1), (zamba, 0),
              (zamba, 1)]
    for cfg, seed in cases:
        model = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
        chain, whole = chain_and_forward(model, cfg, tokens(cfg, 2, 96, seed))
        emit(arch=cfg.name, d_model=cfg.d_model, layers=cfg.n_layers,
             seed=seed, f32_chain_vs_forward=diff(chain, whole, cfg.vocab))


def run_flash() -> None:
    for seed in (1, 2):
        model = init_params(ZAMBA, torch.Generator().manual_seed(seed), "cpu")
        seq = {"tokens": tokens(ZAMBA, 2, 1024, seed)}
        blocked_cfg = dataclasses.replace(ZAMBA, attn_impl="blocked")
        flash, _ = make_prefill_step(ZAMBA)(model, seq)
        blocked, _ = make_prefill_step(blocked_cfg)(model, seq)
        m32, c32 = widened(model, blocked_cfg, "float32")
        ref32, _ = make_prefill_step(c32)(m32, seq)
        v = ZAMBA.vocab
        emit(arch=ZAMBA.name, seed=seed,
             flash_vs_blocked=diff(flash, blocked, v),
             blocked_vs_f32=diff(blocked, ref32, v),
             flash_vs_f32=diff(flash, ref32, v))


def grads(model, cfg, batch):
    loss, _, g = value_and_grad(model, cfg, batch)
    return float(loss), g


def run_host() -> None:
    lm_module._DTYPES.setdefault("float64", torch.float64)
    for seed in (0, 1, 2):
        for cfg in (dataclasses.replace(RWKV, n_layers=1),
                    dataclasses.replace(ZAMBA, n_layers=1,
                                        mamba_per_attn=1)):
            model = init_params(cfg, torch.Generator().manual_seed(seed),
                                "cpu")
            batch = next(iter(TokenPipeline(cfg, 1, 512, seed=3 + seed,
                                            depth=0, device="cpu")
                              .batches(1)))
            out = {}
            for dtype in ("bfloat16", "float32", "float64"):
                m, c = (model, cfg) if dtype == "bfloat16" else \
                    widened(model, cfg, dtype)
                out[dtype] = grads(m, c, batch)
            for lo, hi in (("bfloat16", "float32"), ("float32", "float64")):
                (l_lo, g_lo), (l_hi, g_hi) = out[lo], out[hi]
                rel = {k: float((g_lo[k].double() - g.double()).norm()
                                / g.double().norm().clamp(min=1e-300))
                       for k, g in g_hi.items()}
                worst = max(rel, key=rel.get)
                emit(arch=cfg.name, seed=seed, compare=f"{lo} vs {hi}",
                     loss_diff=abs(l_lo - l_hi), worst_leaf=worst,
                     worst_rel_l2=rel[worst])


def run_reference() -> None:
    import jax
    import jax.numpy as jnp

    import repro.models as rm
    from repro.configs import ARCHS
    cfg = dataclasses.replace(ARCHS["rwkv6-1.6b"][0], d_model=1024,
                              n_heads=16, n_kv=16, d_ff=3584, vocab=8192)
    p16 = rm.init_params(jax.random.PRNGKey(0), cfg)
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32), p16)
    seq = jnp.asarray(tokens(cfg, 2, 96, 0).numpy())
    l16, _, _ = rm.forward(p16, cfg, {"tokens": seq})
    l32, _, _ = rm.forward(p32, dataclasses.replace(cfg, dtype="float32"),
                           {"tokens": seq})
    d = np.abs(np.asarray(l16, np.float64)
               - np.asarray(l32, np.float64))[..., :cfg.vocab]
    emit(arch=cfg.name, package="reference",
         bf16_forward_vs_f32=dict(max=float(d.max()), mean=float(d.mean())))


if __name__ == "__main__":
    {"chain": run_chain, "depth": run_depth, "flash": run_flash,
     "host": run_host, "reference": run_reference}[sys.argv[1]]()
