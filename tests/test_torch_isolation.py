"""The PyTorch/CUDA port stands alone: it imports nothing of JAX or of the
reference package, its entry points refuse to run without CUDA unless asked
for the host, and every knob outside the ported slices raises."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import resolve_device
from repro_torch.core import HybridConfig, HybridGNNTrainer
from repro_torch.configs import get_arch
from repro_torch.graph import GNNConfig, make_dataset
from repro_torch.models import (init_decode_cache, init_params,
                                make_serve_step)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_nor_reference(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in FORBIDDEN]
    assert bad == [], f"{path} imports {bad}"


def test_cpu_trainer_leaves_jax_unloaded():
    code = (
        "import sys\n"
        "from repro_torch.core import HybridConfig, HybridGNNTrainer\n"
        "from repro_torch.graph import GNNConfig, make_dataset\n"
        "ds = make_dataset('ogbn-products', scale=0.0005, seed=0)\n"
        "g = GNNConfig(layer_dims=(100, 16, 47), fanouts=(3, 2),\n"
        "              agg_impl='pallas_fused')\n"
        "cfg = HybridConfig(total_batch=128, cache_fraction=0.2,\n"
        "                   accel_platform='rtx-a5000')\n"
        "tr = HybridGNNTrainer(ds, g, cfg, device='cpu')\n"
        "tr.train(2)\n"
        "tr.close()\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'ml_dtypes', 'repro')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith("ok")


def test_default_device_requires_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_trainer_default_device_requires_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = make_dataset("ogbn-products", scale=0.0005, seed=0)
    g = GNNConfig(layer_dims=(100, 16, 47), fanouts=(3, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HybridGNNTrainer(ds, g, HybridConfig(total_batch=64))


@pytest.mark.parametrize("knob,wired", [
    ({"auto_tune": True}, lambda tr: tr.autotuner is not None),
    ({"pipeline_watchdog_seconds": 1.0},
     lambda tr: tr.cfg.pipeline_watchdog_seconds == 1.0),
], ids=["auto_tune", "pipeline_watchdog_seconds"])
def test_out_of_slice_knob_raises(knob, wired):
    """The last two knobs that raised are ported: no ``HybridConfig`` knob
    raises ``NotImplementedError`` now, and a trainer built with either
    one trains."""
    ds = make_dataset("ogbn-products", scale=0.0005, seed=0)
    g = GNNConfig(layer_dims=(100, 16, 47), fanouts=(3, 2))
    tr = HybridGNNTrainer(ds, g, HybridConfig(total_batch=64, **knob),
                          device="cpu")
    assert wired(tr)
    assert len(tr.train(2)) == 2
    tr.close()


@pytest.mark.parametrize("knob", [
    {"prefetch_windows": 2},
    {"mmap_lru_windows": 4},
    {"prefetch_windows": 4, "prefetch_dedup_history": 0,
     "mmap_lru_windows": 16},
], ids=lambda k: "+".join(k))
def test_storage_tier_knob_builds(knob):
    cfg = HybridConfig(**knob)
    assert all(getattr(cfg, k) == v for k, v in knob.items())


@pytest.mark.parametrize("knob", [
    {"use_accel_sampler": True},
    {"compression": "int8"},
    {"ckpt_every": 5},
], ids=lambda k: next(iter(k)))
def test_sampler_sync_checkpoint_knob_builds(knob):
    cfg = HybridConfig(**knob)
    assert all(getattr(cfg, k) == v for k, v in knob.items())


@pytest.mark.parametrize("knob", [
    {"cache_refresh": True},
    {"async_refresh": True},
    {"recent_rows_batches": 2},
    {"cache_refresh": True, "cache_refresh_period": 3},
    {"cache_sharding": "sharded"},
    {"cache_sharding": "sharded", "shard_placement": "degree"},
    {"kernel_pipeline_depth": 2},
    {"kernel_pipeline_depth": 4, "cache_sharding": "sharded"},
], ids=lambda k: "+".join(k))
def test_dynamic_cache_knob_builds(knob):
    cfg = HybridConfig(**knob)
    assert all(getattr(cfg, k) == v for k, v in knob.items())


@pytest.mark.parametrize("knob", [
    {"kernel_pipeline_depth": 5},
    {"kernel_pipeline_depth": 0},
    {"cache_sharding": "striped"},
    {"shard_placement": "random"},
], ids=lambda k: "=".join(map(str, next(iter(k.items())))))
def test_bad_sharded_plane_knob_rejected(knob):
    with pytest.raises(ValueError):
        HybridConfig(**knob)


def test_fault_injector_raises():
    """``fault_injector`` is ported: the trainer takes it without raising,
    hands it to the cache, and its pipeline fires the stage hooks."""
    from repro_torch.graph import FaultInjector
    ds = make_dataset("ogbn-products", scale=0.0005, seed=0)
    g = GNNConfig(layer_dims=(100, 16, 47), fanouts=(3, 2))
    inj = FaultInjector([])
    tr = HybridGNNTrainer(ds, g, HybridConfig(total_batch=64,
                                              cache_fraction=0.2),
                          device="cpu", fault_injector=inj)
    assert tr.cache.fault_injector is inj
    tr.train(2)
    tr.close()
    assert inj.report()["calls"]["pipeline.load"] == 2


@pytest.mark.parametrize("backend", ["partitioned", "mmap"])
def test_storage_feature_backend_builds(backend, tmp_path):
    ds = make_dataset("ogbn-products", scale=0.0005, feature_backend=backend,
                      partition_rows=256, spill_dir=str(tmp_path / "spill"))
    assert type(ds.features).__name__ == {"partitioned": "PartitionedFeatures",
                                          "mmap": "MmapFeatures"}[backend]
    assert ds.features.shape == (ds.num_nodes, 100)
    with pytest.raises(ValueError, match="unknown feature_backend"):
        make_dataset("ogbn-products", scale=0.0005, feature_backend="nvme")


def test_unknown_agg_impl_and_dtype_rejected():
    with pytest.raises(ValueError):
        GNNConfig(agg_impl="cutlass")
    with pytest.raises(ValueError):
        HybridConfig(feature_dtype="float16")
    with pytest.raises(ValueError):
        HybridConfig(compression="fp8")


@pytest.mark.parametrize("arch,kw,item", [
    ("mixtral-8x22b", {}, "MoE"),
    ("llama4-scout-17b-a16e", {}, "MoE"),
    ("rwkv6-1.6b", {}, "RWKV"),
    ("zamba2-7b", {}, "RWKV and Mamba"),
    ("llama3.2-1b", {"window": 8}, "SWA"),
    ("musicgen-medium", {}, "stub frontends"),
    ("internvl2-1b", {}, "stub frontends"),
], ids=lambda x: x if isinstance(x, str) else "")
def test_unported_lm_config_raises(arch, kw, item):
    """No LM config raises any more: the MoE, sliding-window,
    stub-frontend, RWKV and Mamba configs that raised before (``item``
    names the ROADMAP entry that ported each) build and decode on the CPU.
    An attention cache holds ``min(seq_len, window)`` slots (a window of 8
    wraps in the 12 steps); RWKV's holds the shift rows and the WKV state
    a layer; zamba's the Mamba state a layer plus one such KV cache a
    site."""
    cfg = dataclasses.replace(get_arch(arch, reduced=True), **kw)
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    seq_len = 12
    cache = init_decode_cache(cfg, 2, seq_len, "cpu")
    want = min(seq_len, cfg.window) if cfg.window else seq_len
    if cfg.kind == "rwkv":
        assert sorted(cache) == ["rwkv"]
        assert cache["rwkv"].s.shape == (cfg.n_layers, 2, cfg.n_heads,
                                         cfg.hd, cfg.hd)
    else:
        assert cache["attn"].capacity == want
    if cfg.kind == "zamba":
        sites, per, tail = cfg.zamba_structure()
        assert cache["mamba"].h.shape[:2] == (sites, per)
        assert cache["mamba_tail"].h.shape[0] == tail
        assert sites * per + tail == cfg.n_layers
    step = make_serve_step(cfg)
    for t in range(seq_len):
        logits, cache = step(model, cache,
                             {"tokens": torch.full((2, 1), t + 1)})
        assert logits.shape == (2, 1, cfg.vocab_padded)
        assert bool(torch.isfinite(logits).all())
    if cfg.kind == "rwkv":
        assert bool(cache["rwkv"].s.any())
        return
    attn_layers = cfg.zamba_structure()[0] if cfg.kind == "zamba" \
        else cfg.n_layers
    assert cache["attn"].pos.tolist() == [seq_len] * attn_layers
    assert sorted(cache["attn"].slot_pos[0].tolist()) == list(
        range(seq_len - want, seq_len))


def test_serve_default_device_requires_cuda(monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "llama3.2-1b", "--reduced"])
