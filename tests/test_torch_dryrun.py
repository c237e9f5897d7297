"""The port's dry-run (``repro_torch.launch.dryrun``) against the
reference's, cell by cell, on a (4, 2) mesh.

The reference lowers and compiles each cell on eight forced host devices
in a subprocess.  jax 0.9's ``jax.make_mesh`` gives Explicit axes, which
the reference's ``with_sharding_constraint`` refuses, so its subprocess
builds the mesh with Auto axes (the reference is not changed; its own
test, ``tests/test_dryrun_launch.py``, still builds Explicit ones).  The
port runs each cell under the fake process group at world 8, each cell in
its own subprocess.  Both take one microbatch: argument bytes and product
FLOPs do not depend on it.

Compared, per cell: both ``ok``; the argument bytes per rank (the
reference's ``memory_analysis().argument_size_in_bytes``); the product
FLOPs of the whole unpartitioned step (the reference's ``dot_general``
FLOPs and its flash ``pallas_call`` charge, summed over its jaxpr with
``repro.launch.costmodel._dot_cost``; a ``shard_map`` body counted once per
shard, as the port counts its ``local_map`` regions).  The differences
have causes that the test computes exactly and holds to equality:

* argument bytes, train cells: the reference's AdamW step is an int32 on
  the device (4 bytes); the port's is a Python int;
* argument bytes, rwkv6-1.6b on (4, 2): the reference shards the stacked
  [24, 2048] ``w0`` over 'data' on its layer axis, which per-layer leaves
  cannot express (``repro_torch.dist.sharding``): the port holds 73,728
  bytes more a rank;
* FLOPs, the prefill step: the port runs the head on the last position
  only (2·B·(S-1)·d·V fewer), and RWKV's bonus diagonal ``sum(r·u·k)`` is
  an elementwise product and a sum in the port, two ``dot_general``s of a
  three-operand einsum in the reference (4·B·S·H·K a layer);
* FLOPs, the flash train cell: the port's recompute VJP of K8 visits the
  keys up to each 512-row q block's last row only (the rest of the
  probabilities are exactly 0), the reference's all S: its five products
  cost 5·2·B·H·D·(S² - Σ_blocks qb·stop) less a layer.

Everything else must agree within 1 %; in this run it is exact.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
CELLS = [("smollm-135m", "train_4k", "tp2d"),
         ("smollm-135m", "decode_32k", "serve2d"),
         ("rwkv6-1.6b", "prefill_32k", "tp2d"),
         ("smollm-135m", "train_4k", "auto")]
TIMEOUT = 400

_REF = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json, math, sys
import jax
from jax.sharding import AxisType
from repro.configs import SHAPES, get_arch
from repro.dist import use_mesh, use_policy
from repro.launch.cellspecs import build_cell
from repro.launch.costmodel import _dot_cost, _sub_jaxprs
from repro.launch.dryrun import resolve_policy, run_cell

mesh = jax.make_mesh((4, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)

def shards(eqn):
    names = set()
    for spec in eqn.params["in_specs"]:
        for e in spec:
            if e is not None:
                names.update((e,) if isinstance(e, str) else e)
    return math.prod(eqn.params["mesh"].shape[n] for n in names)

def products(jaxpr):
    jaxpr = getattr(jaxpr, "jaxpr", jaxpr)
    total = 0.0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name == "dot_general":
            total += _dot_cost(eqn).flops
        elif name == "pallas_call":
            b, s, hkv, g, d = eqn.invars[0].aval.shape
            total += 2 * 2 * b * hkv * g * s * s * d * 0.5
        elif name == "shard_map":
            total += shards(eqn) * products(eqn.params["jaxpr"])
        else:
            for sub, mult in _sub_jaxprs(eqn):
                total += mult * products(sub)
    return total

out = []
for arch, shape_name, policy in json.loads(sys.argv[1]):
    r = run_cell(arch, shape_name, mesh, verbose=False, policy=policy,
                 microbatches=1)
    cfg, shape = get_arch(arch), SHAPES[shape_name]
    if policy == "auto":
        policy, attn = resolve_policy(cfg, shape, mesh.size)
        cfg = dataclasses.replace(cfg, attn_impl=attn)
    cell = build_cell(cfg, shape, mesh, microbatches=1, policy=policy)
    with use_mesh(mesh), use_policy(policy):
        closed = jax.make_jaxpr(cell.fn)(*cell.args)
    out.append({"status": r["status"], "error": r.get("error"),
                "policy": policy,
                "args": r.get("memory_analysis", {}).get(
                    "argument_size_in_bytes"),
                "products": products(closed),
                "coll": r.get("collectives", {}).get("total")})
print("RESULT:" + json.dumps(out))
"""

_PORT = r"""
import json, sys
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.launch.dryrun import init_fake_world, run_cell
init_fake_world(8)
mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
arch, shape, policy = json.loads(sys.argv[1])
r = run_cell(arch, shape, mesh, verbose=False, policy=policy, microbatches=1)
print("RESULT:" + json.dumps({
    "status": r["status"], "error": r.get("error"),
    "policy": r.get("policy"), "attn_impl": r.get("attn_impl"),
    "args": r.get("memory", {}).get("argument_bytes"),
    "products": r.get("cost", {}).get("global_product_flops"),
    "coll": r.get("collectives", {}).get("total"),
    "fits": r.get("fits_80gb"), "roofline": r.get("roofline")}))
"""


def _start(code: str, arg) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-c", code, json.dumps(arg)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _result(proc: subprocess.Popen):
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT:")][-1]
    return json.loads(line[len("RESULT:"):])


@pytest.fixture(scope="module")
def both():
    """Every cell through both packages, all subprocesses at once."""
    ref = _start(_REF, CELLS)
    port = [_start(_PORT, c) for c in CELLS]
    return _result(ref), [_result(p) for p in port]


def _expected_gap(arch, shape, policy):
    """(argument bytes, product FLOPs) the port has less than the
    reference, from the causes in the module docstring."""
    from repro_torch.configs import SHAPES, get_arch
    cfg, sh = get_arch(arch), SHAPES[shape]
    args = 4 if sh.step == "train" else 0
    if arch == "rwkv6-1.6b":
        w0 = cfg.n_layers * cfg.d_model * 4          # [24, 2048] f32
        args -= w0 // 2 - w0 // 8                    # model vs data x model
    flops = 0
    b, s = sh.global_batch, sh.seq_len
    if sh.step == "prefill":
        flops += 2 * b * (s - 1) * cfg.d_model * cfg.vocab_padded
        if cfg.kind == "rwkv":
            flops += 4 * b * s * cfg.d_model * cfg.n_layers
    if sh.step == "train" and policy == "auto":      # dp + flash
        qb = min(cfg.q_block, s)
        tiled = sum(qb * min(i + qb, s) for i in range(0, s, qb))
        flops += (cfg.n_layers * 5 * 2 * b * cfg.n_heads * cfg.hd
                  * (s * s - tiled))
    return args, flops


@pytest.mark.parametrize("i", range(len(CELLS)),
                         ids=["-".join(c) for c in CELLS])
def test_dryrun_cell_matches_reference(both, i):
    ref, port = both[0][i], both[1][i]
    arch, shape, policy = CELLS[i]
    assert ref["status"] == "ok", ref["error"]
    assert port["status"] == "ok", port["error"]
    assert port["policy"] == ref["policy"]
    d_args, d_flops = _expected_gap(arch, shape, policy)
    assert port["args"] == ref["args"] - d_args, (port["args"], ref["args"])
    assert port["products"] == pytest.approx(ref["products"] - d_flops,
                                             rel=1e-2)
    assert port["products"] == ref["products"] - d_flops   # exact here
    assert port["roofline"]["bottleneck"] in ("compute", "memory",
                                              "collective")


def test_dryrun_cells_issue_collectives(both):
    """The partitioned steps move data between ranks, in both packages."""
    assert any(c["coll"] > 0 for c in both[0])
    assert any(c["coll"] > 0 for c in both[1])


def test_dryrun_auto_cell_runs_k8_through_local_map(both):
    """The auto policy resolves smollm-135m train_4k to dp with K8 (the
    reference's decision), and its cost counts K8's custom op."""
    port = both[1][3]
    assert (port["policy"], port["attn_impl"]) == ("dp", "flash")


def test_cost_mode_counts_products_and_k8_per_rank():
    """On plain tensors: a product's 2·M·N·K and its bytes, K8's charge
    (two causal products) at its q, k, v, o bytes, one FLOP per other
    output element."""
    from repro_torch.kernels import ops
    from repro_torch.launch.costmodel import CostMode
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    q = torch.zeros(1, 32, 2, 3, 16)
    k = torch.zeros(1, 32, 2, 16)
    with CostMode() as cm:
        a @ b
        ops.flash_attention(q, k, k, 32, 0)
    k8 = 2 * 2 * 1 * 2 * 3 * 32 * 32 * 16 * 0.5
    assert cm.cost.product_flops == 2 * 8 * 16 * 4 + k8
    assert cm.by_op["mm"] == 2 * 8 * 16 * 4
    assert cm.by_op["flash_attention"] == k8
    assert cm.cost.bytes == 4 * (8 * 16 + 16 * 4 + 8 * 4) + 4 * (
        2 * q.numel() + 2 * k.numel())
    assert cm.cost.global_product_flops == cm.cost.product_flops
