"""The port's LM stack under a device mesh on the CPU: four gloo processes
(a FileStore in ``tmp_path``, no fixed port), against the reference's run
on one device from the same weights and batches.

* Training: the reduced smollm-135m, 3 AdamW steps (lr 1e-3) of 8 x 64
  tokens under tp2d on (data 2, model 2) and under dp with K8's plain
  version inside ``local_map`` on (4, 1).  Losses within 1e-5; parameters
  within the bounds ``tests/test_torch_lm_train.py`` states for AdamW
  (the update normalises each element's gradient, so an element whose
  gradient is near its sums' rounding moves a fraction of lr: at most
  2 lr a step anywhere, over 1e-3 lr in at most 0.1 % of a leaf, 1e-4 lr
  on average).  The sums run in another order on the mesh (each rank's
  partial products, then the reduction).
* MoE's ``ep`` branch: the reduced llama4-scout (4 experts, top 1) on
  (data 2, model 2), where 'model' divides the experts, so the capacity
  buffer is sharded over experts: logits within 1e-4 (rtol and atol, as
  ``tests/test_torch_lm_moe.py`` holds the forward), the loss within
  1e-5, and every gradient leaf within 2e-5 of its largest magnitude.
* The training CLI under a launcher's ``WORLD_SIZE`` of 4 with
  ``--model-parallel 2``: a (2, 2) mesh, losses within 1e-5 of the same
  command in one process (which has no mesh).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as rm
import repro.optim as ro
from repro.configs import ARCHS as REF_ARCHS
from repro_torch.configs import ARCHS
from repro_torch.launch import train as train_cli
from repro_torch.models import init_params
from repro_torch.models.convert import export_named, export_params

ROOT = Path(__file__).resolve().parents[1]
LR, STEPS, BATCH, SEQ = 1e-3, 3, 8, 64

_RANK = r"""
import json, sys
import numpy as np
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import ARCHS
from repro_torch.dist import shard_batch, shard_params, use_mesh, use_policy
from repro_torch.models import (forward, init_params, make_train_step,
                                value_and_grad)
from repro_torch.optim import adamw
rank, world, store, spec = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                            json.loads(sys.argv[4]))
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world)
cfg = ARCHS[spec["arch"]][1]
import dataclasses
cfg = dataclasses.replace(cfg, attn_impl=spec["attn"])
mesh = init_device_mesh("cpu", tuple(spec["mesh"]),
                        mesh_dim_names=("data", "model"))
data = np.load(spec["batches"])
batches = [{k: torch.from_numpy(data[f"{k}{i}"]) for k in ("tokens", "labels")}
           for i in range(spec["steps"])]

def full(t):
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach()

out = {}
with use_mesh(mesh), use_policy(spec["policy"]):
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    placements = shard_params(model, mesh)
    if spec["mode"] == "train":
        opt = adamw(spec["lr"])
        state = opt.init(dict(model.named_parameters()))
        step = make_train_step(cfg, opt)
        losses = []
        for b in batches:
            model, state, m = step(model, state, shard_batch(b, mesh))
            losses.append(float(full(m["loss"])))
        out["losses"] = losses
        arrays = {k: full(p).numpy() for k, p in model.named_parameters()}
        # the parameters keep the rule table's layout through the steps
        out["layout_kept"] = all(
            tuple(p.placements) == placements[k]
            for k, p in model.named_parameters())
    else:
        b = shard_batch(batches[0], mesh)
        logits, aux, _ = forward(model, cfg, b)
        loss, metrics, grads = value_and_grad(model, cfg, b)
        out["loss"] = float(full(loss))
        out["aux"] = float(full(metrics["aux"]))
        arrays = {"logits": full(logits).numpy()}
        arrays.update({"grad." + k: full(g).numpy() for k, g in grads.items()})
if rank == 0:
    np.savez(spec["out"], **arrays)
print("RESULT:" + json.dumps(out))
dist.destroy_process_group()
"""

_CLI = r"""
import json, os, sys
import torch, torch.distributed as dist
rank, world, store, argv = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                            json.loads(sys.argv[4]))
torch.set_num_threads(1)
os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK="0")
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world)
from repro_torch.launch import train
res = train.main(argv)
print("RESULT:" + json.dumps({k: res[k] for k in (
    "losses", "mesh", "rank", "layout_kept", "k8_per_step", "peak_bytes")}))
"""


@pytest.fixture(autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run_ranks(code, world, tmp_path, arg, timeout=300):
    """``code`` in ``world`` processes joined through a FileStore in
    ``tmp_path``; each prints one ``RESULT:`` JSON line.  Every process is
    joined (killed past ``timeout``)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    store = str(tmp_path / "store")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r),
                               str(world), store, json.dumps(arg)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-3000:]
            line = [ln for ln in out.splitlines()
                    if ln.startswith("RESULT:")][-1]
            outs.append(json.loads(line[len("RESULT:"):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _batches(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, cfg.vocab, (BATCH, SEQ)
                                    ).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (BATCH, SEQ)
                                    ).astype(np.int32)} for _ in range(n)]


def _save_batches(tmp_path, batches):
    path = tmp_path / "batches.npz"
    np.savez(path, **{f"{k}{i}": v for i, b in enumerate(batches)
                      for k, v in b.items()})
    return str(path)


def _reference(arch, attn):
    """The reduced config in both packages and the reference's copy of the
    port's seed-0 weights."""
    jcfg = dataclasses.replace(REF_ARCHS[arch][1], attn_impl=attn)
    tcfg = dataclasses.replace(ARCHS[arch][1], attn_impl=attn)
    model = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    jparams = jax.tree.map(jnp.asarray, export_params(model))
    return jcfg, tcfg, model, jparams


def _flat(tree):
    """A tree of the reference's layout as ``{path: f32 array}``."""
    return {jax.tree_util.keystr(p): np.asarray(a, np.float32) for p, a in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_tree(model, arrays, prefix=""):
    """A rank's saved ``{port name: array}`` in the reference's layout."""
    return _flat(export_named(model, {
        k: torch.from_numpy(arrays[prefix + k])
        for k, _ in model.named_parameters()}))


@pytest.mark.parametrize("mesh,policy,attn", [((2, 2), "tp2d", "blocked"),
                                              ((4, 1), "dp", "flash")],
                         ids=["tp2d-2x2", "dp-flash-4x1"])
def test_training_under_mesh_matches_reference(tmp_path, mesh, policy,
                                               attn):
    jcfg, tcfg, model, jp = _reference("smollm-135m", attn)
    batches = _batches(tcfg, STEPS)
    spec = dict(arch="smollm-135m", attn=attn, mesh=mesh, policy=policy,
                mode="train", lr=LR, steps=STEPS,
                batches=_save_batches(tmp_path, batches),
                out=str(tmp_path / "out.npz"))
    outs = run_ranks(_RANK, 4, tmp_path, spec)
    opt = ro.adamw(LR)
    step = rm.make_train_step(jcfg, opt)
    state = opt.init(jp)
    ref_losses = []
    for b in batches:
        jp, state, m = step(jp, state, {k: jnp.asarray(v)
                                        for k, v in b.items()})
        ref_losses.append(float(m["loss"]))
    for out in outs:
        np.testing.assert_allclose(out["losses"], ref_losses, rtol=0,
                                   atol=1e-5)
        assert out["layout_kept"]
    got = _port_tree(model, np.load(spec["out"]))
    want = _flat(jp)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        d = np.abs(got[name] - w)
        assert d.max() <= 2 * LR * STEPS, (name, d.max())
        assert (d > 1e-3 * LR).mean() <= 1e-3, (name, (d > 1e-3 * LR).mean())
        assert d.mean() <= 1e-4 * LR, (name, d.mean())


def test_moe_ep_branch_matches_one_device(tmp_path):
    arch = "llama4-scout-17b-a16e"
    jcfg, tcfg, model, jp = _reference(arch, "blocked")
    assert tcfg.moe_experts % 2 == 0          # 'model' divides the experts
    batches = _batches(tcfg, 1)
    spec = dict(arch=arch, attn="blocked", mesh=(2, 2), policy="ep",
                mode="grad", steps=1,
                batches=_save_batches(tmp_path, batches),
                out=str(tmp_path / "out.npz"))
    outs = run_ranks(_RANK, 4, tmp_path, spec)
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}
    jlogits, jaux, _ = rm.forward(jp, jcfg, jb)
    (jloss, jm), jg = jax.value_and_grad(rm.loss_fn, has_aux=True)(jp, jcfg,
                                                                    jb)
    arrays = np.load(spec["out"])
    np.testing.assert_allclose(arrays["logits"], np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    for out in outs:
        np.testing.assert_allclose(out["loss"], float(jloss), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(out["aux"], float(jm["aux"]), rtol=1e-5)
    got = _port_tree(model, arrays, "grad.")
    want = _flat(jg)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        bound = 2e-5 * max(np.abs(w).max(), 1e-30)
        assert np.abs(got[name] - w).max() <= bound, name


def test_train_cli_model_parallel_under_a_launcher(tmp_path, capsys):
    argv = ["--arch", "smollm-135m", "--reduced", "--device", "cpu",
            "--steps", "3", "--batch", "4", "--seq", "32",
            "--model-parallel", "2"]
    outs = run_ranks(_CLI, 4, tmp_path, argv)
    one = train_cli.main(argv)
    assert "mesh" not in one
    for rank, out in enumerate(outs):
        assert out["mesh"] == {"data": 2, "model": 2}
        # every rank's own readings: its rank, the layout kept, K8 a step
        # (0: the plain version on the host), no device memory
        assert out["rank"] == rank and out["layout_kept"]
        assert out["k8_per_step"] == [0] * 3 and out["peak_bytes"] is None
        np.testing.assert_allclose(out["losses"], one["losses"], rtol=0,
                                   atol=1e-5)


def test_train_cli_under_torchrun_prints_one_line_a_rank():
    """Under ``torchrun`` the ranks share one stdout: each rank's JSON
    readings arrive as a line of their own (the line and its newline in
    one write; print's two writes let another rank's line land between
    them, as the four-card run showed)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node=4", "-m", "repro_torch.launch.train", "--arch",
         "smollm-135m", "--reduced", "--device", "cpu", "--steps", "1",
         "--batch", "4", "--seq", "32", "--model-parallel", "2"],
        env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = [json.loads(ln) for ln in p.stdout.splitlines()
             if ln.startswith("{")]
    assert sorted(r["rank"] for r in lines) == [0, 1, 2, 3]
    assert all(r["mesh"] == {"data": 2, "model": 2} and r["layout_kept"]
               for r in lines)
