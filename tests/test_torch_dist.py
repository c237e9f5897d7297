"""The port's mesh rules (``repro_torch.dist``, ``dist.sharding``,
``launch.cellspecs``, ``launch.dryrun``, ``configs.shapes``) against the
reference's, and its hierarchical gradient mean under gloo.

* Rule tables: every leaf of the ten registry archs at full size (shapes
  only: ``jax.eval_shape`` and a ``FakeTensorMode``), on the meshes (1, 1),
  (4, 2), (16, 16) and (2, 16, 16), under tp2d / dp / serve2d / ep.  The
  reference's meshes are ``AbstractMesh``es, the port's ``DeviceMesh``es
  over a fake process group of 512 ranks.  ``param_pspec``, the
  constraint specs (``constrain``, ``constrain_proj``, ``constrain_act``,
  ``constrain_act_serve``), ``_batch_pspecs``, ``_cache_pspec`` and
  ``_prefill_out_pspec`` equal the reference's; ``param_pspec`` drops the
  reference's leading stack dims (the port keeps one tensor a layer), and
  the one leaf whose stack dim the reference shards (rwkv6-1.6b's ``w0``
  on (4, 2), over 'data') is replicated over that axis in the port.
* Decisions: ``resolve_policy``, ``microbatch_ladder``,
  ``cell_applicable``, ``input_specs`` (shapes and dtypes) and
  ``model_flops_total`` equal for 10 archs x 4 shapes x 256 / 512 ranks.
* Collectives: ``hierarchical_psum_mean`` over four gloo processes on the
  (pod 2, data 2) and (data 2, model 2) meshes, with a leaf whose dim 0
  the pod does not divide (the flat all-reduce), equals the mean of the
  ranks' trees within f32 rounding (rtol 1e-6: four f32 terms summed in
  another order).
"""
import dataclasses
import functools
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
from jax.sharding import AbstractMesh

import repro.dist as rdist
import repro.launch.cellspecs as rcell
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import cell_applicable as ref_applicable
from repro.configs import input_specs as ref_input_specs
from repro.dist.sharding import param_pspec as ref_param_pspec
from repro.launch.analysis import model_flops_total as ref_model_flops
from repro.launch.dryrun import resolve_policy as ref_resolve
from repro.models import init_decode_cache as ref_init_decode_cache
from repro.models import init_params as ref_init_params
from repro_torch import dist as tdist
from repro_torch.configs import ARCHS, SHAPES, cell_applicable, input_specs
from repro_torch.dist.sharding import param_pspec, stack_sizes
from repro_torch.launch import cellspecs as tcell
from repro_torch.launch.analysis import model_flops_total
from repro_torch.launch.dryrun import init_fake_world, resolve_policy
from repro_torch.models import init_decode_cache, init_params

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
POLICIES = ("tp2d", "dp", "serve2d", "ep")
ARCH_IDS = sorted(ARCHS)


@pytest.fixture(scope="module", autouse=True)
def _fake_world():
    """A fake process group of 512 ranks: the port's meshes need one."""
    init_fake_world(512)
    yield
    torch.distributed.destroy_process_group()


@functools.lru_cache(maxsize=None)
def _meshes(name):
    from torch.distributed.device_mesh import DeviceMesh
    shape, names = MESHES[name]
    n = int(np.prod(shape))
    return (AbstractMesh(shape, names),
            DeviceMesh("cpu", torch.arange(n).reshape(shape),
                       mesh_dim_names=names, _init_backend=False))


def _norm(spec):
    """A reference PartitionSpec as the port's tuple."""
    return tuple(e if e is None or isinstance(e, str) else tuple(e)
                 for e in spec)


@functools.lru_cache(maxsize=None)
def _ref_leaves(arch):
    cfg = REF_ARCHS[arch][0]
    tree = jax.eval_shape(functools.partial(ref_init_params, cfg=cfg),
                          jax.random.PRNGKey(0))
    return [("/".join(str(getattr(p, "key", p)) for p in path), path, leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)]


@functools.lru_cache(maxsize=None)
def _port_leaves(arch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        model = init_params(ARCHS[arch][0], torch.Generator(), "cpu")
        named = {k: p for k, p in model.named_parameters()}
    return named, stack_sizes(named)


def _ref_key(name):
    """``layers.3.moe.w1`` -> ``layers/moe/w1``."""
    return "/".join(p for p in name.split(".") if not p.isdigit())


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_rules_match_reference(arch, mesh_name, policy):
    rmesh, tmesh = _meshes(mesh_name)
    with rdist.use_mesh(rmesh), rdist.use_policy(policy):
        ref = {key: (_norm(ref_param_pspec(path, leaf)), leaf)
               for key, path, leaf in _ref_leaves(arch)}
    named, stacks = _port_leaves(arch)
    with tdist.use_policy(policy):
        placements = tdist.params_shardings(named, tmesh)
        with tdist.use_mesh(tmesh):
            got = {k: param_pspec(k, t, stacks.get(k, ()))
                   for k, t in named.items()}
    assert {_ref_key(k) for k in named} == set(ref)
    for name, t in named.items():
        spec, leaf = ref[_ref_key(name)]
        lead = len(stacks.get(name, ()))
        assert tuple(leaf.shape[lead:]) == tuple(t.shape), name
        assert str(leaf.dtype) == str(t.dtype).split(".")[-1], name
        want = spec[lead:]
        if any(e is not None for e in spec[:lead]):
            # the one stack dim the reference shards (module docstring)
            assert (arch, mesh_name, name.rsplit(".", 1)[-1]) == (
                "rwkv6-1.6b", "4x2", "w0") and spec[:lead] == ("data",)
        assert got[name] == want, name
        assert placements[name] == tdist.to_placements(tmesh, want), name


def _activation_cases(cfg):
    """(function, shape, extra) of every constraint the model applies, at
    each assigned shape's batch and length."""
    out = []
    for sh in REF_SHAPES.values():
        b, s = sh.global_batch, (1 if sh.step == "decode" else sh.seq_len)
        d, hd = cfg.d_model, cfg.hd
        out += [("act", (b, s, d), None), ("act", (b, s), None),
                ("serve", (b, 1, d), None),
                ("proj", (b, s, cfg.n_heads * hd), cfg.n_heads),
                ("proj", (b, s, cfg.n_kv * hd), cfg.n_kv),
                ("mlp", (b, s, cfg.d_ff), None),
                ("logits", (b, s, cfg.vocab_padded), None)]
    return out


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_constraint_specs_match_reference(arch, mesh_name, policy,
                                          monkeypatch):
    """The spec each ``constrain*`` applies; on a mesh of one rank none."""
    rmesh, tmesh = _meshes(mesh_name)
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: seen.append(_norm(s.spec)) or x)
    cfg = REF_ARCHS[arch][0]
    for fn, shape, extra in _activation_cases(cfg):
        x = jax.ShapeDtypeStruct(shape, jnp.float32)
        seen.clear()
        with rdist.use_mesh(rmesh), rdist.use_policy(policy):
            if fn == "act":
                rdist.constrain_act(x)
            elif fn == "serve":
                rdist.constrain_act_serve(x)
            elif fn == "proj":
                rdist.constrain_proj(x, extra)
            else:
                rdist.constrain(x, ("pod", "data"), None, "model")
        with tdist.use_policy(policy):
            if fn == "act":
                dims = (tdist.act_dims(tmesh, shape) if len(shape) >= 3
                        else None)
            elif fn == "serve":
                dims = tdist.act_serve_dims(len(shape))
            elif fn == "proj":
                dims = tdist.proj_dims(tmesh, extra)
            else:
                dims = (("pod", "data"), None, "model")
        if mesh_name == "1x1" or dims is None:
            assert seen == [], (fn, shape)
            continue
        assert seen == [tdist.constrain_spec(tmesh, shape, *dims)], (
            fn, shape)


def _ref_cache_leaves(cfg, b, s):
    tree = jax.eval_shape(lambda: ref_init_decode_cache(cfg, b, s))
    return sorted((jax.tree_util.keystr(p[:-1]), str(p[-1].name), p, leaf)
                  for p, leaf in jax.tree_util.tree_leaves_with_path(tree))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_cache_and_prefill_rules_match_reference(arch, mesh_name,
                                                       policy):
    rmesh, tmesh = _meshes(mesh_name)
    rcfg, tcfg = REF_ARCHS[arch][0], ARCHS[arch][0]
    for name, rsh in REF_SHAPES.items():
        tsh = SHAPES[name]
        rb = rcell._batch_pspecs(rcfg, rsh, rmesh,
                                 ref_input_specs(rcfg, rsh))
        tb = tcell._batch_pspecs(tcfg, tsh, tmesh, input_specs(tcfg, tsh))
        assert {k: _norm(v) for k, v in rb.items()} == tb, name
        if rsh.step == "prefill" and rcfg.kind in ("dense", "moe",
                                                   "zamba"):
            lead = (rcfg.zamba_structure()[0] if rcfg.kind == "zamba"
                    else rcfg.n_layers)
            shape = (lead, rsh.global_batch, rsh.seq_len, rcfg.n_kv,
                     rcfg.hd)
            path = (jax.tree_util.DictKey("attn_kv"),
                    jax.tree_util.SequenceKey(0))
            with rdist.use_mesh(rmesh), rdist.use_policy(policy):
                want = _norm(rcell._prefill_out_pspec(
                    path, jax.ShapeDtypeStruct(shape, jnp.bfloat16), rcfg,
                    rsh, rmesh))
            with tdist.use_policy(policy):
                got = tcell._prefill_out_pspec("attn_kv", shape, tcfg, tsh,
                                               tmesh)
            assert got == want, name
        if rsh.step != "decode":
            continue
        ref = _ref_cache_leaves(rcfg, rsh.global_batch, rsh.seq_len)
        port = init_decode_cache(tcfg, tsh.global_batch, tsh.seq_len,
                                 device="meta")
        port_leaves = sorted(
            (f"['{g}']", f.name, tuple(getattr(c, f.name).shape))
            for g, c in port.items() for f in dataclasses.fields(c))
        assert [(g, n, tuple(leaf.shape)) for g, n, _, leaf in ref] == \
            port_leaves, name
        for g, n, path, leaf in ref:
            with rdist.use_mesh(rmesh), rdist.use_policy(policy):
                want = _norm(rcell._cache_pspec(path, leaf, rcfg, rsh,
                                                rmesh))
            with tdist.use_policy(policy):
                got = tcell._cache_pspec(n, leaf.shape, tcfg, tsh, tmesh)
            assert got == want, (name, g, n)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decisions_match_reference(arch):
    """resolve_policy, microbatch_ladder, cell_applicable, input_specs and
    model_flops_total on every (shape, 256 / 512 ranks)."""
    rcfg, tcfg = REF_ARCHS[arch][0], ARCHS[arch][0]
    for name, rsh in REF_SHAPES.items():
        tsh = SHAPES[name]
        assert dataclasses.asdict(rsh) == dataclasses.asdict(tsh)
        for mesh_name, n in (("16x16", 256), ("2x16x16", 512)):
            assert tuple(ref_resolve(rcfg, rsh, n)) == resolve_policy(
                tcfg, tsh, n), (name, n)
            rmesh, tmesh = _meshes(mesh_name)
            assert rcell.microbatch_ladder(rsh, rmesh) == \
                tcell.microbatch_ladder(tsh, tmesh)
        assert tuple(ref_applicable(rcfg, rsh)) == cell_applicable(tcfg,
                                                                   tsh)
        ref_in = ref_input_specs(rcfg, rsh)
        port_in = input_specs(tcfg, tsh)
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in
                ref_in.items()} == {k: (tuple(v.shape),
                                        str(v.dtype).split(".")[-1])
                                    for k, v in port_in.items()}
        assert all(v.device.type == "meta" for v in port_in.values())
        assert ref_model_flops(rcfg, rsh) == model_flops_total(tcfg, tsh)


# -------------------------------------------------------------- collectives

_PSUM = r"""
import json, sys
import numpy as np
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.dist import hierarchical_psum_mean, use_mesh
rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world)
out = {}
for shape, names in (((2, 2), ("pod", "data")), ((2, 2), ("data", "model"))):
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    rng = np.random.default_rng(rank)
    tree = {"w": torch.from_numpy(rng.standard_normal((8, 3), np.float32)),
            "odd": torch.from_numpy(rng.standard_normal((5,), np.float32)),
            "nested": [torch.from_numpy(rng.standard_normal((4, 2),
                                                            np.float32))]}
    with use_mesh(mesh):
        got = hierarchical_psum_mean(tree)
    out["x".join(names)] = {"w": got["w"].tolist(), "odd": got["odd"].tolist(),
                            "nested": got["nested"][0].tolist()}
with use_mesh(None):
    same = hierarchical_psum_mean(tree)
out["identity"] = same is tree
print("RESULT:" + json.dumps(out))
dist.destroy_process_group()
"""


def run_ranks(code, world, tmp_path, timeout=300, extra=()):
    """``code`` in ``world`` processes joined through a FileStore in
    ``tmp_path``; each prints one ``RESULT:`` JSON line.  Every process is
    joined (killed past ``timeout``)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    store = str(tmp_path / "store")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r),
                               str(world), store, *extra], env=env,
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


def test_hierarchical_psum_mean_equals_mean_under_gloo(tmp_path):
    outs = run_ranks(_PSUM, 4, tmp_path)
    trees = []
    for r in range(4):
        rng = np.random.default_rng(r)
        trees.append({"w": rng.standard_normal((8, 3), np.float32),
                      "odd": rng.standard_normal((5,), np.float32),
                      "nested": rng.standard_normal((4, 2), np.float32)})
    want = {k: np.mean([t[k].astype(np.float64) for t in trees], axis=0)
            for k in trees[0]}
    for out in outs:
        assert out["identity"] is True
        for mesh in ("podxdata", "dataxmodel"):
            for k, w in want.items():
                np.testing.assert_allclose(np.asarray(out[mesh][k]), w,
                                           rtol=1e-6, atol=1e-7)
    # every rank holds the same mean
    assert all(o == outs[0] for o in outs)


def test_carry_context_reaches_another_thread():
    """A rematerialised forward runs in autograd's own thread on a card:
    ``carry_context`` hands it the mesh and policy ambient when it was
    made (the thread-local context is empty there)."""
    import threading
    _, mesh = _meshes("4x2")
    seen = {}
    with tdist.use_mesh(mesh), tdist.use_policy("dp"):
        bound = tdist.carry_context(
            lambda: (tdist.current_mesh(), tdist.current_policy()))
        bare = lambda: (tdist.current_mesh(), tdist.current_policy())
    for name, fn in (("bound", bound), ("bare", bare)):
        t = threading.Thread(target=lambda n=name, f=fn: seen.update({n: f()}))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    assert seen["bound"] == (mesh, "dp")
    assert seen["bare"] == (None, "tp2d")
