"""Checkpoints of the port: the reference's six checkpoint tests on dicts of
tensors, the same files as the reference's in both directions (each
package restores what the other saved, with equal sha256 and byte counts),
and the trainer's callback at the reference's iterations."""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.checkpoint as rck
import repro.core as rc
import repro.graph as rg
import repro_torch.checkpoint as pck
import repro_torch.core as tc
import repro_torch.graph as tg
from repro.checkpoint.ckpt import _flatten as ref_flatten
from repro.optim import adamw as ref_adamw
from repro_torch.checkpoint.ckpt import _flatten as port_flatten
from repro_torch.optim import adamw as port_adamw


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w1": torch.randn(8, 16, generator=g),
                       "b1": torch.zeros(16, dtype=torch.bfloat16)},
            "opt": {"step": 7,
                    "m": {"w1": torch.ones(8, 16),
                          "b1": torch.ones(16, dtype=torch.float32)}}}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _same(a, b):
    if isinstance(a, int):
        return isinstance(b, int) and a == b
    return a.dtype == b.dtype and torch.equal(a, b)


def test_roundtrip(tmp_path):
    tree = _tree()
    pck.save(str(tmp_path), 42, tree, meta={"note": "x"})
    step, restored = pck.restore(str(tmp_path), None, tree)
    assert step == 42
    a, b = _leaves(tree), _leaves(restored)
    assert a.keys() == b.keys()
    assert all(_same(a[k], b[k]) for k in a)     # bf16 and the int step too


def test_integrity_detects_corruption(tmp_path):
    pck.save(str(tmp_path), 1, _tree())
    ckpt = os.path.join(str(tmp_path), "step_00000001")
    victim = [f for f in os.listdir(ckpt) if f.endswith(".bin")][0]
    path = os.path.join(ckpt, victim)
    raw = bytearray(open(path, "rb").read())
    raw[0] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="sha256"):
        pck.restore(str(tmp_path), 1, _tree())


def test_shape_mismatch_rejected(tmp_path):
    pck.save(str(tmp_path), 1, _tree())
    bad = _tree()
    bad["params"]["w1"] = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="shape"):
        pck.restore(str(tmp_path), 1, bad)


def test_rotation_keeps_last_k(tmp_path):
    mgr = pck.CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s))
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(str(tmp_path)))
    assert steps == [3, 4]


def test_async_save_then_restore(tmp_path):
    pck.save_async(str(tmp_path), 9, _tree(3))
    pck.wait_for_async()
    assert pck.latest_step(str(tmp_path)) == 9
    step, restored = pck.restore(str(tmp_path), None, _tree())
    assert step == 9
    assert torch.equal(restored["params"]["w1"], _tree(3)["params"]["w1"])


def test_restore_latest_resumes(tmp_path):
    mgr = pck.CheckpointManager(str(tmp_path), keep=3, async_save=True)
    t = _tree(1)
    mgr.save(5, t)
    mgr.finalize()
    got = mgr.restore_latest(_tree(0))
    assert got is not None
    step, tree = got
    assert step == 5
    assert torch.equal(tree["params"]["w1"], t["params"]["w1"])


def test_async_rotation_counts_the_step_in_flight(tmp_path):
    mgr = pck.CheckpointManager(str(tmp_path), keep=2, async_save=True)
    for s in (1, 3, 5, 7):
        mgr.save(s, _tree(s))
    mgr.finalize()
    assert sorted(int(d.split("_")[1])
                  for d in os.listdir(str(tmp_path))) == [5, 7]


# ------------------------------------------------------ across packages


def _tree_pair():
    """A GNN's parameters, its AdamW state after one step and one bf16
    leaf, as the reference holds them (jnp, int32 step) and as the port
    does (torch, int step)."""
    cfg = rg.GNNConfig(model="sage", layer_dims=(100, 32, 47),
                       fanouts=(5, 3), num_classes=47)
    params = rg.init_params(jax.random.PRNGKey(0), cfg)
    opt = ref_adamw(1e-3)
    grads = jax.tree.map(lambda p: jnp.full_like(p, 0.5), params)
    _, state = opt.update(grads, opt.init(params), params)
    bf = np.random.default_rng(0).standard_normal(33).astype(
        ml_dtypes.bfloat16)
    ref = {"params": dict(params), "opt": state,
           "extra": {"half": jnp.asarray(bf)}}

    def t(x):
        return torch.from_numpy(np.array(x))
    port = {"params": {k: t(v) for k, v in params.items()},
            "opt": {"step": int(state["step"]),
                    "m": {k: t(v) for k, v in state["m"].items()},
                    "v": {k: t(v) for k, v in state["v"].items()}},
            "extra": {"half": torch.from_numpy(
                bf.view(np.int16).copy()).view(torch.bfloat16)}}
    return ref, port


def _manifest(directory, step):
    with open(os.path.join(directory, f"step_{step:08d}",
                           "manifest.json")) as f:
        return json.load(f)


def _bits(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().tobytes()
        return x.numpy().tobytes()
    if isinstance(x, int):
        return np.asarray(x, np.int32).tobytes()
    return np.asarray(x).tobytes()


def test_reference_checkpoint_restores_into_port(tmp_path):
    ref, port = _tree_pair()
    rck.save(str(tmp_path / "ref"), 3, ref, meta={"from": "ref"})
    pck.save(str(tmp_path / "port"), 3, port, meta={"from": "ref"})
    assert _manifest(str(tmp_path / "ref"), 3) == \
        _manifest(str(tmp_path / "port"), 3)
    template = {"params": {k: torch.zeros_like(v)
                           for k, v in port["params"].items()},
                "opt": {"step": 0,
                        "m": {k: torch.zeros_like(v)
                              for k, v in port["opt"]["m"].items()},
                        "v": {k: torch.zeros_like(v)
                              for k, v in port["opt"]["v"].items()}},
                "extra": {"half": torch.zeros(33, dtype=torch.bfloat16)}}
    step, got = pck.restore(str(tmp_path / "ref"), None, template)
    assert step == 3
    want, have = _leaves(port), _leaves(got)
    assert want.keys() == have.keys()
    for k in want:
        assert _same(want[k], have[k]), k
    assert isinstance(got["opt"]["step"], int) and got["opt"]["step"] == 1


def test_port_checkpoint_restores_into_reference(tmp_path):
    ref, port = _tree_pair()
    pck.save(str(tmp_path), 11, port)
    man = _manifest(str(tmp_path), 11)
    assert man["leaves"]["opt/step"]["dtype"] == "int32"
    assert man["leaves"]["extra/half"]["dtype"] == "bfloat16"
    template = jax.tree.map(jnp.zeros_like, ref)
    step, got = rck.restore(str(tmp_path), None, template)
    assert step == 11
    rl = ref_flatten(ref)
    gl = ref_flatten(got)
    assert rl.keys() == gl.keys()
    for k in rl:
        assert rl[k].dtype == gl[k].dtype, k
        assert rl[k].tobytes() == gl[k].tobytes(), k
    pl = _leaves(port)
    for k, info in man["leaves"].items():
        raw = _bits(pl[k])
        assert info["bytes"] == len(raw) == rl[k].nbytes


def test_trainer_checkpoint_callback_matches_reference(tmp_path):
    rds = rg.make_dataset("ogbn-products", scale=0.002, seed=0)
    pds = tg.make_dataset("ogbn-products", scale=0.002, seed=0)
    gkw = dict(model="sage", layer_dims=(100, 16, 47), fanouts=(3, 2),
               num_classes=47)
    cfg = dict(total_batch=128, use_drm=False, use_accel_sampler=False,
               accel_platform="rtx-a5000", ckpt_every=2,
               ckpt_dir=str(tmp_path), seed=0)
    ref = rc.HybridGNNTrainer(rds, rg.GNNConfig(**gkw),
                              rc.HybridConfig(**cfg))
    port = tc.HybridGNNTrainer(pds, tg.GNNConfig(**gkw),
                               tc.HybridConfig(**cfg), device="cpu")
    calls = {"ref": [], "port": []}
    ref.set_checkpoint_callback(lambda it, p, o: calls["ref"].append(
        (it, sorted(ref_flatten({"params": p, "opt": o})))))
    mgr = pck.CheckpointManager(str(tmp_path), keep=2)

    def port_cb(it, p, o):
        calls["port"].append(
            (it, sorted(port_flatten({"params": p, "opt": o}))))
        mgr.save(it, {"params": p, "opt": o})
    port.set_checkpoint_callback(port_cb)
    ref.train(5)
    port.train(5)
    ref.close()
    port.close()
    mgr.finalize()
    assert [c[0] for c in calls["port"]] == [1, 3]
    assert calls["port"] == calls["ref"]
    assert pck.latest_step(str(tmp_path)) == 3
    step, got = mgr.restore_latest({"params": port.params,
                                    "opt": port.opt_state})
    assert step == 3 and got["opt"]["step"] == 4
    assert set(got["params"]) == set(port.params)
