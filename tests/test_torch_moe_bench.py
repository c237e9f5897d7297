"""The benchmark's routed-model pieces on the CPU at tiny widths: the plain
MoE reference (``perfbench/reference/moe.py``) against the port, the
port's MoE spans and counters, the MoE metric readers, the Zipf token law,
the per-leaf weights, and the cross-card driver in four gloo processes.

Tolerances: port and reference both run in f32 with TF32 off, so they
differ only in the order of additions (the port's capacity buffer and
batched products against the reference's per-expert loops, DTensor's
partial sums under a mesh): 1e-5 of each compared tensor's largest
magnitude covers that at these sizes with room, and is three orders below
what one misrouted token or a dropped assignment moves.
"""
import copy
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.drivers import lm_train_mesh  # noqa: E402
from perfbench.harness import (  # noqa: E402
    mesh_record, moe_dims, moe_weights, program, spec, token_batches)
from perfbench.harness.trace import profile, span  # noqa: E402
from perfbench.reference import lm as ref_lm  # noqa: E402
from perfbench.reference import moe as ref  # noqa: E402
from repro_torch import trace  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.models import (forward, init_params,  # noqa: E402
                                make_train_step, value_and_grad)
from repro_torch.models import moe as port_moe  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

CELL = "mixtral-8x22b.seq-8k"
TOL = 1e-5          # of the largest magnitude; see the module docstring


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_cell(layers=2, factor=1.25, batch=4, seq=64):
    cell = copy.deepcopy(spec.cell(CELL))
    cell["config"]["arch"].update(
        num_hidden_layers=layers, hidden_size=64, num_attention_heads=4,
        num_key_value_heads=2, head_dim=16, intermediate_size=96,
        num_local_experts=4, vocab_size=256, dtype="float32", q_block=32,
        capacity_factor=factor)
    cell["traffic"].update(batch=batch, seq=seq)
    return cell


def close(got, want, tol=TOL, what=""):
    got, want = got.detach().float(), want.detach().float()
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max())
    assert err <= tol * scale, (what, err, scale)


def _port_model(cell, seed=5):
    dims = moe_dims.from_arch(cell["config"]["arch"])
    cfg = lm_train_mesh.model_config(cell)
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    w = moe_weights.make(dims, seed, torch.device("cpu"),
                         dtype=torch.float32)
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(w[k])
    return dims, cfg, model, w


# ------------------------------------------------------------ reference


@pytest.mark.parametrize("factor", [1.25, 0.5, 2.0],
                         ids=["cf1.25", "drops", "dropless"])
def test_moe_ffn_matches_plain_reference(factor):
    """Output, aux and every input's gradient of one routed FFN: the
    port's ``moe_ffn`` against the reference's, f32."""
    cell = tiny_cell(layers=1, factor=factor)
    dims = moe_dims.from_arch(cell["config"]["arch"])
    w = moe_weights.make(dims, 11, torch.device("cpu"), torch.float32)
    p = "layers.0.moe."
    leaves = {n: w[p + n].clone().requires_grad_(True)
              for n in ("router", "w1", "w3", "w2")}
    x = torch.randn(2, 32, dims.d, generator=torch.Generator().manual_seed(3))
    xp = x.clone().requires_grad_(True)
    with ref_lm.exact_f32():
        out, aux = port_moe.moe_ffn(xp, leaves, top_k=dims.top_k,
                                    capacity_factor=factor)
        gp = torch.autograd.grad((out * out).sum() + aux,
                                 [xp, *leaves.values()])
        rw = {"layers.0.moe." + n: t.detach().clone().requires_grad_(True)
              for n, t in leaves.items()}
        xr = x.clone().requires_grad_(True)
        rout, raux = ref.moe_ffn(xr, rw, "layers.0.", dims, "f32")
        gr = torch.autograd.grad((rout * rout).sum() + raux,
                                 [xr, *rw.values()])
    close(out, rout, what="out")
    close(aux, raux, what="aux")
    for name, a, b in zip(["x", "router", "w1", "w3", "w2"], gp, gr):
        close(a, b, what=name)
    # the case's routing: drops where the capacity is short, none where it
    # holds every assignment
    logits = x @ leaves["router"].detach()
    cap = moe_dims.capacity(dims, 32)
    dropped = sum(int((~ref.kept(ref.top_k(logits[r], dims.top_k),
                                 dims.experts, cap)).sum())
                  for r in range(2))
    if factor < 1.0:
        assert dropped > 0
    if factor >= dims.experts / dims.top_k:
        assert dropped == 0


def test_capacity_and_routing_match_the_port():
    cell = tiny_cell()
    dims = moe_dims.from_arch(cell["config"]["arch"])
    for tokens in (1, 7, 64, 8192):
        assert moe_dims.capacity(dims, tokens) == port_moe._capacity(
            tokens, dims.experts, dims.top_k, dims.capacity_factor)
    g = torch.Generator().manual_seed(1)
    logits = torch.randn(3, 40, dims.experts, generator=g)
    logits[0, :5] = 0.25                    # ties: the lower index first
    cap = moe_dims.capacity(dims, 40)
    _, _, _, keep, experts = port_moe._routing_indices(logits, dims.top_k,
                                                       cap)
    for r in range(3):
        mine = ref.top_k(logits[r], dims.top_k)
        assert torch.equal(mine, experts[r])
        assert torch.equal(ref.kept(mine, dims.experts, cap),
                           keep[r].reshape(40, dims.top_k))


def test_train_step_matches_plain_reference():
    """A reduced-width Mixtral: the port's loss, logits and every leaf's
    gradient against the reference with all weights alive, and the
    blocked reference (one layer's weights at a time) against both."""
    cell = tiny_cell()
    dims, cfg, model, w = _port_model(cell)
    host = token_batches.host_batch(dims.vocab, 1.0, 4, 64, 9, 0)
    batch = {k: torch.from_numpy(v) for k, v in host.items()}
    with ref_lm.exact_f32():
        loss, _, grads = value_and_grad(model, cfg, batch)
        logits, _, _ = forward(model, cfg, batch)
        rvalue, rgrads = ref.value_and_grad(w, dims, batch, "f32")
        x = torch.nn.functional.embedding(batch["tokens"].long(),
                                          w["embed"])
        for i in range(dims.layers):
            x, _ = ref.layer(x, w, i, dims, "f32")
        rlogits = ref_lm._mm(ref_lm.rms_norm(x, w["final_norm"], dims.eps),
                             w["lm_head"], "f32")
        blocked = {}
        bvalue = ref.blocked_value_and_grad(
            dims, batch, lambda i: {n: w[n] for n in ref.layer_names(dims,
                                                                     i)},
            {k: w[k] for k in ref.OUTER}, blocked.update, "f32")
    assert abs(float(loss) - rvalue) <= TOL * abs(rvalue)
    assert abs(bvalue - rvalue) <= TOL * abs(rvalue)
    close(logits, rlogits, what="logits")
    assert sorted(grads) == sorted(rgrads) == sorted(blocked)
    for k in rgrads:
        close(grads[k], rgrads[k], what=k)
        close(blocked[k], rgrads[k], what="blocked " + k)


def test_first_change_is_the_reference_optimizers_first_step():
    train = spec.cell(CELL)["config"]["train"]
    g = torch.Generator().manual_seed(2)
    for dtype in (torch.float32, torch.bfloat16):
        w = {"a": torch.randn(64, 32, generator=g).to(dtype)}
        grad = torch.randn(64, 32, generator=g) * 1e-3
        start = w["a"].clone()
        opt = ref_lm.Optimizer(train, w)
        opt.update(w, {"a": grad})
        want = w["a"].float() - start.float()
        assert torch.equal(ref.first_change(start, grad, train), want)


# ------------------------------------------------------- spans, counters


def _step_once(cfg, model, batch):
    opt = adamw(1e-3)
    state = opt.init(dict(model.named_parameters()))
    return make_train_step(cfg, opt)(model, state, batch)


def test_counters_equal_the_index_math():
    """``moe.assignments``, ``moe.dropped``, ``moe.slots`` and
    ``moe.slots_filled`` on ``moe.ffn`` equal what the routing's own
    arrays count, in a case that drops."""
    e, k, d, f = 4, 2, 16, 24
    g = torch.Generator().manual_seed(4)
    leaves = port_moe.init_moe_params(g, d, f, e)
    x = torch.randn(3, 40, d, generator=g)
    cap = port_moe._capacity(40, e, k, 0.5)
    _, valid, _, keep, _ = port_moe._routing_indices(
        x @ leaves["router"], k, cap)
    assert int((~keep).sum()) > 0
    trace.reset()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        with trace.step("cpu"):
            port_moe.moe_ffn(x, leaves, top_k=k, capacity_factor=0.5)
    got = [s for s in trace.spans() if s["name"] == "moe.ffn"]
    assert len(got) == 1
    assert got[0]["counters"] == {
        "moe.assignments": keep.numel(), "moe.dropped": int((~keep).sum()),
        "moe.slots": valid.numel(), "moe.slots_filled": int(valid.sum())}
    names = {s["name"] for s in trace.spans()}
    assert {"moe.ffn", "moe.route", "moe.dispatch", "moe.experts",
            "moe.combine"} <= names


def test_spans_off_add_no_event():
    cell = tiny_cell()
    _, cfg, model, w = _port_model(cell)
    host = token_batches.host_batch(256, 1.0, 4, 64, 1, 0)
    batch = {k: torch.from_numpy(v) for k, v in host.items()}
    trace.reset()
    assert not trace.recording()
    _step_once(cfg, model, batch)
    assert trace.spans() == [] and trace.dropped() == 0


# ------------------------------------------------------------- readers


def _canned_run(steps=2):
    """A tiny MoE train loop traced as the driver traces it, on the host."""
    cell = tiny_cell()
    dims, cfg, model, _ = _port_model(cell)
    opt = adamw(1e-3)
    state = opt.init(dict(model.named_parameters()))
    step_fn = make_train_step(cfg, opt)
    feed = iter(TokenPipeline(cfg, 4, 64, seed=3, device="cpu",
                              zipf_exponent=1.0).batches(steps))
    trace.reset()

    def body():
        nonlocal model, state
        for _ in range(steps):
            with span("input_wait"):
                batch = next(feed)
            with span("step"):
                model, state, _ = step_fn(model, state, batch)
        with span("window_end"):
            pass
        return steps
    tr = profile(body)
    run = mesh_record.MeshRun(
        dims=dims, traffic=cell["traffic"], steps=10, window_s=2.0,
        tokens_per_step=4 * 64, step_ms=[200.0] * 10, input_wait_s=[0.0],
        peak_bytes=0, setup_s=1.0, trace=tr, ranks=1)
    run.moe_counters = mesh_record.forward_counts(run)
    return run


def _read(name, run):
    return spec.reader(name).read(run)


def test_moe_readers_on_a_canned_run():
    run = _canned_run()
    got = program.steps(run)
    assert len(got) == 2

    def per_step(names):
        return statistics.median(sum(
            e["device_ms"] for e in s.spans if e["name"] in names)
            for s in got)
    assert _read("moe_ms", run) == pytest.approx(per_step({"moe.ffn"}))
    assert _read("moe_experts_ms", run) == pytest.approx(
        per_step({"moe.experts"}))
    assert _read("moe_route_ms", run) == pytest.approx(
        per_step({"moe.route", "moe.dispatch", "moe.combine"}))
    c = run.moe_counters
    # forward only: 2 steps x 2 layers x 4 rows x 64 tokens x top-2
    assert c["moe.assignments"] == 2 * 2 * 4 * 64 * 2
    assert _read("moe_drop_pct", run) == pytest.approx(
        100 * c["moe.dropped"] / c["moe.assignments"])
    assert _read("moe_slot_fill_pct", run) == pytest.approx(
        100 * c["moe.slots_filled"] / c["moe.slots"])
    mfu = _read("moe_step_mfu", run)
    assert 0 < mfu < 100
    # the yardstick by hand: d 64, 4 / 2 heads of 16, 4 experts of 96,
    # 2 layers, vocab 256, 4 x 64 tokens, 0.2 s a step
    kept = (c["moe.assignments"] - c["moe.dropped"]) / 2
    dense = 2 * (64 * 16 * (8 + 4) + 64 * 4) + 64 * 256
    attn = 4 * 16 * 4 * 4 * (64 * 65 // 2) * 2
    flops = 3 * (2 * dense * 256 + attn + 2 * 3 * 64 * 96 * kept)
    assert mfu == pytest.approx(100 * flops / (989e12 * 0.2))


def test_moe_readers_find_nothing_without_the_programs_counters():
    run = _canned_run(steps=1)
    bare = mesh_record.MeshRun(**{f: getattr(run, f) for f in (
        "dims", "traffic", "steps", "window_s", "tokens_per_step",
        "step_ms", "input_wait_s", "peak_bytes", "setup_s")})
    for name in ("moe_ms", "moe_experts_ms", "moe_route_ms", "moe_drop_pct",
                 "moe_slot_fill_pct", "moe_step_mfu"):
        assert _read(name, bare) is None, name


# ------------------------------------------------------ tokens, weights


def test_zipf_tokens_are_the_benchmarks_own():
    cfg = lm_train_mesh.model_config(tiny_cell())
    pipe = TokenPipeline(cfg, 4, 64, seed=3_000_000_019, depth=0,
                         device="cpu", zipf_exponent=1.0)
    for i, b in enumerate(pipe.batches(3)):
        want = token_batches.host_batch(256, 1.0, 4, 64, 3_000_000_019, i)
        assert all(np.array_equal(b[k].numpy(), want[k]) for k in want)
    toks = token_batches.host_batch(32768, 1.0, 4, 8192, 5, 0)["tokens"]
    assert toks.min() >= 0 and toks.max() < 32768
    # rank 1's share of Zipf(1) over 32,768 ids is 1 / H(32768) ~ 9.2 %
    share = np.bincount(toks.ravel()).max() / toks.size
    assert 0.08 < share < 0.105


def test_default_token_draw_is_unchanged():
    cfg = lm_train_mesh.model_config(tiny_cell())
    b = next(iter(TokenPipeline(cfg, 2, 16, seed=7, depth=0,
                                device="cpu").batches(1)))
    rng = np.random.default_rng(7)
    want = (rng.zipf(1.3, (2, 16)).astype(np.int64) % 256).astype(np.int32)
    assert np.array_equal(b["tokens"].numpy(), want)


def test_weights_leaf_by_leaf_match_the_port_names():
    cell = tiny_cell()
    dims = moe_dims.from_arch(cell["config"]["arch"])
    model = init_params(lm_train_mesh.model_config(cell),
                        torch.Generator().manual_seed(0), "cpu")
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    assert shapes == {n: s for n, s, _ in moe_weights.leaf_specs(dims)}
    all_at_once = moe_weights.make(dims, 2**31 + 5, torch.device("cpu"))
    alone = moe_weights.leaf(dims, "layers.1.moe.w2", 2**31 + 5,
                             torch.device("cpu"))
    assert torch.equal(alone, all_at_once["layers.1.moe.w2"])
    assert not torch.equal(all_at_once["layers.0.moe.w1"],
                           all_at_once["layers.1.moe.w1"])


def test_dims_refuse_what_the_reference_cannot_follow():
    arch = dict(spec.cell(CELL)["config"]["arch"])
    moe_dims.from_arch(arch)
    for key, bad in (("sliding_window", 4096), ("kind", "dense"),
                     ("hidden_act", "gelu"), ("frontend", "audio_stub")):
        with pytest.raises(ValueError):
            moe_dims.from_arch(dict(arch, **{key: bad}))


# ---------------------------------------------------------- the driver


@pytest.mark.parametrize("fault", [None, "state_unchanged", "half_batch"],
                         ids=["sound", "state_unchanged", "half_batch"])
def test_driver_across_four_gloo_ranks(fault):
    """The cell at a tiny size in four rank processes on the host: sound,
    it is correct (traced, with the MoE metrics); each planted fault
    turns it false."""
    cell = tiny_cell()
    rec = lm_train_mesh.run(cell, 2**31 + 11, 0.0, fault is None,
                            started=time.time(), fault=fault, device="cpu")
    ok, checks = lm_train_mesh.judge.verdict(rec["numbers"], cell["limits"])
    assert rec["cards"] == 4 and rec["steps"] >= 2
    assert checks["batch_mismatch"]["value"] == 0
    if fault is None:
        assert ok, checks
        assert checks["grad_gap"]["value"] < 1e-4
        assert set(rec["per_layer"]) == {
            "moe_ms", "moe_experts_ms", "moe_route_ms", "moe_drop_pct",
            "moe_slot_fill_pct", "moe_step_mfu"}
    else:
        assert not ok, checks


def test_driver_refuses_a_rank_that_loads_jax(tmp_path, monkeypatch):
    """A forbidden module loaded in one rank process (here rank 2 alone,
    through a ``sitecustomize`` on its path) refuses the run, though the
    parent process never loads it."""
    (tmp_path / "sitecustomize.py").write_text(
        "import sys, types\n"
        "if sys.argv[-2:-1] == ['2']:\n"
        "    sys.modules['jax'] = types.ModuleType('jax')\n")
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    with pytest.raises(RuntimeError, match=r"\{2: \['jax'\]\}"):
        lm_train_mesh.run(tiny_cell(), 2**31 + 11, 0.0, False,
                          started=time.time(), device="cpu")
