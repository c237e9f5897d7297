"""repro_torch.analysis: engine and rule tests, and parity with the
reference analyzer.

Per rule: a minimal violating fixture (positive), a compliant twin
(negative), a suppressed twin (noqa) and an unused suppression (RPT000).
The CUDA text rules run on small kernels written to ``tmp_path`` and on
copies of the port's own sources with one barrier wait, drain or ring
check deleted.  Parity: on the rules both analyzers share, the port's raw
findings equal ``repro.analysis``'s (``RPR`` -> ``RPT``, same lines) on
the reference's own fixture snippets and on ``src/repro_torch``; RPT103
and RPT301 may only add to theirs.  The self-check holds the port's tree,
CUDA sources and ``chip_smoke.py`` at zero findings.
"""
import ast
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import pytest

import repro.analysis as ref_analysis
import repro_torch.annotations as port_annotations
from repro_torch.analysis import (Engine, default_rules, guarded_by,
                                  requires_lock, run_paths)
from repro_torch.analysis.engine import Rule, iter_files

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
CSRC = PORT / "kernels" / "csrc"
PORT_FILES = iter_files(PORT) + [str(ROOT / "chip_smoke.py")]


def check(source, path="fixture.py", rules=None):
    """Run the port's rule set over one in-memory fixture."""
    eng = Engine(rules if rules is not None else default_rules())
    raw = eng.check_file(path, source=source, raw=True)
    for rule in eng.rules:
        raw.extend(f for f in rule.finish() if f.path == path)
    return eng._apply_noqa(raw, eng._collect_noqa(source), path)


def check_cu(tmp_path, source, name="k.cu"):
    path = tmp_path / name
    path.write_text(source)
    return run_paths([str(path)])


def rules_of(findings):
    return sorted(f.rule for f in findings)


def raw_findings(engine, paths, sources=None):
    """Every finding of ``engine`` over ``paths`` with suppressions off,
    the cross-file ones included."""
    out = []
    for p in paths:
        out += engine.check_file(p, source=None if sources is None
                                 else sources[p], raw=True)
    for rule in engine.rules:
        out += rule.finish()
    return out


# --------------------------------------------------------------------------
# RPT1xx lock discipline
# --------------------------------------------------------------------------

GUARDED_HEADER = """\
import threading
import torch
import torch.distributed as dist
from repro_torch.annotations import guarded_by, requires_lock

@guarded_by("_lock", "pending", "done")
class S:
    def __init__(self):
        self._lock = threading.Lock()
        self.pending = 0
        self.done = 0
"""


def guarded(body):
    return GUARDED_HEADER + "\n" + body


class TestLockDiscipline:
    @pytest.mark.parametrize("body,rule", [
        ("    def peek(self):\n        return self.pending\n", "RPT101"),
        ("    def reset(self):\n        self.pending = 0\n", "RPT104"),
        ("    def drop(self):\n        del self.pending\n", "RPT104"),
        ("    def bump(self):\n        self.pending += 1\n", "RPT303"),
    ], ids=["read", "write", "del", "augassign"])
    def test_positive_noqa_and_unused(self, body, rule):
        assert rules_of(check(guarded(body))) == [rule]
        line = body.rstrip("\n").split("\n")[-1]
        suppressed = body.replace(line, f"{line}  # noqa: {rule} - benign")
        assert check(guarded(suppressed)) == []
        # under the lock the same line is clean and its noqa is stale
        locked = suppressed.replace(line, "        with self._lock:\n    "
                                    + line)
        out = check(guarded(locked))
        assert rules_of(out) == ["RPT000"]
        assert "unused suppression" in out[0].message

    def test_negative_under_lock(self):
        body = """\
    def ok(self):
        with self._lock:
            self.pending += 1
            self.done = self.pending
"""
        assert check(guarded(body)) == []

    def test_init_exempt(self):
        assert check(GUARDED_HEADER) == []

    def test_requires_lock_treats_body_as_locked(self):
        body = """\
    @requires_lock("_lock")
    def _drain_locked(self):
        self.pending = 0
        self.done += 1
"""
        assert check(guarded(body)) == []

    def test_nested_def_and_lambda_start_unlocked(self):
        body = """\
    def spawn(self):
        with self._lock:
            def worker():
                self.pending += 1
            fn = lambda: self.done
            return worker, fn
"""
        assert rules_of(check(guarded(body))) == ["RPT101", "RPT303"]

    def test_unannotated_class_not_policed(self):
        src = "class Plain:\n    def peek(self):\n        return self.p\n"
        assert check(src) == []

    INVERSION = """
import threading
from repro_torch.annotations import guarded_by

@guarded_by("_a", "x")
@guarded_by("_b", "y")
class S:
    def one(self):
        with self._a:
            with self._b:
                pass

    def two(self):
        with self._b:
            with self._a:
                pass
"""

    def test_rpt102_inversion_both_sites(self):
        out = check(self.INVERSION)
        assert rules_of(out) == ["RPT102", "RPT102"]
        assert {f.line for f in out} == {10, 15}

    def test_rpt102_negative_consistent_order(self):
        src = self.INVERSION.replace(
            "        with self._b:\n            with self._a:",
            "        with self._a:\n            with self._b:")
        assert check(src) == []

    def test_rpt102_noqa_and_unused(self):
        lines = self.INVERSION.split("\n")
        lines[9] += "  # noqa: RPT102 - one"
        lines[14] += "  # noqa: RPT102 - two"
        assert check("\n".join(lines)) == []
        consistent = TestLockDiscipline.INVERSION.replace(
            "        with self._b:\n            with self._a:",
            "        with self._a:\n            with self._b:").split("\n")
        consistent[9] += "  # noqa: RPT102 - stale"
        assert rules_of(check("\n".join(consistent))) == ["RPT000"]

    @pytest.mark.parametrize("call", [
        # the reference's set
        "src.take(rows)", "t.join()", "time.sleep(0.1)", 'open("f")',
        "fut.result()", "os.fsync(fd)", "x.block_until_ready()",
        # torch's host-blocking calls
        "torch.cuda.synchronize()", "stream.synchronize()",
        "event.synchronize()", "x.item()", "x.tolist()", "x.cpu()",
        'x.to("cuda")', 'x.to("cuda:1", torch.bfloat16)',
        "x.to(device=d)", "x.to(self.device)", "x.to(dev)",
        "x.to(torch.device('cuda', 0))", "x.cuda()",
        "torch.empty(4, device=dev).copy_(host)", "pinned.copy_(y, dev)",
        "torch.save(x, f)", "torch.load(f)", "dist.all_reduce(x)",
        "dist.barrier()", "torch.distributed.broadcast(x, 0)",
        "dist.all_gather_into_tensor(out, x)",
    ])
    def test_rpt103_blocking_call_under_lock(self, call):
        body = f"""\
    def bad(self, src, rows, t, fut, fd, x, y, d, dev, stream, event,
            host, pinned, out, f):
        with self._lock:
            {call}
"""
        out = check(guarded(body))
        assert rules_of(out) == ["RPT103"], call
        assert "self._lock" in out[0].message
        suppressed = body.replace(call, call + "  # noqa: RPT103 - why")
        assert check(guarded(suppressed)) == []

    def test_rpt103_imported_collective(self):
        src = GUARDED_HEADER.replace(
            "import torch.distributed as dist",
            "from torch.distributed import barrier as bar\n"
            "from torch import distributed as tdist") + """
    def bad(self, x):
        with self._lock:
            bar()
            tdist.reduce_scatter_tensor(x, x)
"""
        assert rules_of(check(src)) == ["RPT103", "RPT103"]

    @pytest.mark.parametrize("call", [
        "np.take(rows, rows)", '", ".join(["x"])', 'os.path.join("a", "b")',
        "x.to(torch.float32)", 'x.to("cuda", non_blocking=True)',
        "x.to(dev, non_blocking=True)", "x.cuda(non_blocking=True)",
        "dst.copy_(src)", "dst.copy_(x, non_blocking=True)",
        "x.add_(y)", "other.barrier()", "pool.submit(job)",
    ])
    def test_rpt103_negative_cheap_calls(self, call):
        body = f"""\
    def ok(self, rows, x, y, dev, dst, src, other, pool, job):
        import os
        with self._lock:
            {call}
"""
        assert check(guarded(body)) == []

    def test_rpt103_only_fires_while_held(self):
        body = """\
    def ok(self, x):
        with self._lock:
            n = self.pending
        torch.cuda.synchronize()
        return x.item(), x.to("cuda"), n
"""
        assert check(guarded(body)) == []

    def test_rpt103_unused_noqa(self):
        body = """\
    def ok(self, x):
        return x.item()  # noqa: RPT103 - nothing is held here
"""
        assert rules_of(check(guarded(body))) == ["RPT000"]


# --------------------------------------------------------------------------
# RPT2xx kernel invariants: the CUDA text rules
# --------------------------------------------------------------------------

RING = """\
#include "tma.cuh"
// a two-stage ring: printf( in a comment is not a call
__global__ void ring_kernel(const float* src, float* out, int n) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + 2048);
  uint64_t* empty = full + 2;
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    fence_mbarrier_init();
  }
  __syncthreads();
  const char* tag = "printf(\\"no\\")";
  for (int k = 0; k < n; ++k) {
    const int s = k % 2;
    if (threadIdx.x == 0) {
      if (k >= 2) mbar_wait(&empty[s], ((k / 2) - 1) & 1);
      mbar_arrive_expect_tx(&full[s], 1024);
      bulk_load(smem + s * 1024, src + k * 256, 1024, &full[s]);
    } else if (threadIdx.x == 32) {
      mbar_wait(&full[s], (k / 2) & 1);
      bulk_store(out + k * 256, smem + s * 1024, 1024);
      bulk_commit();
      bulk_wait_read<0>();
      mbar_arrive(&empty[s]);
    }
  }
  if (threadIdx.x == 32) bulk_wait<0>();
}

extern "C" int launch(const float* src, float* out, int n) {
  printf("host code may print\\n");
  ring_kernel<<<1, 64, 4096>>>(src, out, n);
  return 0;
}
"""


TMA_RING = """\
#include "tma.cuh"
__global__ void tma_ring_kernel(const __grid_constant__ CUtensorMap map,
                                float* out, int n) {
  extern __shared__ unsigned char smem[];
  __shared__ uint64_t full[2], empty[2];
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    fence_mbarrier_init();
  }
  __syncthreads();
  for (int k = 0; k < n; ++k) {
    const int s = k % 2;
    if (threadIdx.x == 0) {
      if (k >= 2) mbar_wait(&empty[s], ((k / 2) - 1) & 1);
      mbar_arrive_expect_tx(&full[s], 1024);
      tma_load_4d(smem + s * 1024, &map, 0, 0, k * 4, 0, &full[s]);
    } else if (threadIdx.x >= 32 && threadIdx.x < 64) {
      mbar_wait(&full[s], (k / 2) & 1);
      out[k * 32 + threadIdx.x - 32] = smem[s * 1024 + threadIdx.x];
      mbar_arrive_warp(&empty[s]);
    }
  }
}
"""


class TestCudaRules:
    def test_balanced_ring_is_clean(self, tmp_path):
        assert check_cu(tmp_path, RING) == []

    @pytest.mark.parametrize("line,bar", [
        ("      mbar_wait(&full[s], (k / 2) & 1);\n", "full"),
        ("      if (k >= 2) mbar_wait(&empty[s], ((k / 2) - 1) & 1);\n",
         "empty"),
    ])
    def test_rpt203_ring_missing_its_wait(self, tmp_path, line, bar):
        out = check_cu(tmp_path, RING.replace(line, ""))
        assert out and set(rules_of(out)) == {"RPT203"}
        assert all(f"'{bar}'" in f.message for f in out)
        assert any("mbar_wait" in f.message for f in out)

    def test_rpt203_missing_arrival(self, tmp_path):
        out = check_cu(tmp_path, RING.replace(
            "      mbar_arrive(&empty[s]);\n", ""))
        assert rules_of(out) == ["RPT203"]
        assert "'empty'" in out[0].message and "arrival" in out[0].message
        assert out[0].line == 10   # reported at the barrier's mbar_init

    def test_rpt203_load_on_unawaited_barrier(self, tmp_path):
        src = RING.replace("&full[s]);\n    } else",
                           "&other[s]);\n    } else")
        out = check_cu(tmp_path, src)
        assert rules_of(out) == ["RPT203"]
        assert "bulk_load" in out[0].message and "'other'" in out[0].message

    def test_tma_ring_is_clean(self, tmp_path):
        # K8's ring: tensor-map loads on "full", consumer warps' arrivals
        # on "empty"
        assert check_cu(tmp_path, TMA_RING) == []

    def test_rpt203_tensor_load_on_unawaited_barrier(self, tmp_path):
        src = TMA_RING.replace("      mbar_wait(&full[s], (k / 2) & 1);\n",
                               "")
        out = check_cu(tmp_path, src)
        assert out and set(rules_of(out)) == {"RPT203"}
        assert any("tma_load_4d" in f.message and "'full'" in f.message
                   for f in out)

    def test_rpt203_store_never_committed(self, tmp_path):
        src = RING.replace("      bulk_commit();\n", "")
        out = check_cu(tmp_path, src)
        assert rules_of(out) == ["RPT203"]
        assert "bulk_store" in out[0].message

    def test_rpt203_commits_never_drained(self, tmp_path):
        src = RING.replace("      bulk_wait_read<0>();\n",
                           "      bulk_wait_read<1>();\n").replace(
            "  if (threadIdx.x == 32) bulk_wait<0>();\n", "")
        out = check_cu(tmp_path, src)
        assert rules_of(out) == ["RPT203"]
        assert "drains" in out[0].message

    def test_rpt203_noqa_and_unused(self, tmp_path):
        line = "      mbar_init(&full[s], 1);\n"
        src = RING.replace("      mbar_wait(&full[s], (k / 2) & 1);\n", "")
        src = src.replace(line, line.rstrip("\n")
                          + "  // noqa: RPT203 - waited elsewhere\n")
        src = src.replace("src + k * 256, 1024, &full[s]);",
                          "src + k * 256, 1024, &full[s]);"
                          "  // noqa: RPT203 - waited elsewhere")
        assert check_cu(tmp_path, src) == []
        stale = RING.replace(line, line.rstrip("\n")
                             + "  // noqa: RPT203 - stale\n")
        assert rules_of(check_cu(tmp_path, stale, "s.cu")) == ["RPT000"]

    @pytest.mark.parametrize("stmt", [
        'printf("x=%f\\n", v);', "curand_init(7, 0, 0, &st);",
        "float r = curand_uniform(&st);", 'FILE* f = fopen("a", "w");',
        'fprintf(stderr, "no");',
    ])
    def test_rpt201_side_effect_in_kernel(self, tmp_path, stmt):
        src = f"""\
__global__ void k(float* out, float v) {{
  {stmt}
  out[0] = v;
}}
"""
        out = check_cu(tmp_path, src)
        assert rules_of(out) == ["RPT201"]
        assert out[0].line == 2 and "'k'" in out[0].message
        suppressed = src.replace(stmt, stmt + "  // noqa: RPT201 - debug")
        assert check_cu(tmp_path, suppressed) == []

    def test_rpt201_device_helper_and_header(self, tmp_path):
        src = """\
#pragma once
__device__ __forceinline__ float noisy(float x) {
  printf("%f", x);
  return x;
}
__device__ int counter;
__device__ float quiet(float x);
"""
        out = check_cu(tmp_path, src, "h.cuh")
        assert rules_of(out) == ["RPT201"] and "'noisy'" in out[0].message

    def test_rpt201_negative_host_comment_and_string(self, tmp_path):
        # RING prints from host code, and names printf in a comment and a
        # string inside the kernel: none of them is a finding
        assert check_cu(tmp_path, RING) == []
        out = check_cu(tmp_path, RING + "// noqa: RPT201 - stale\n")
        assert rules_of(out) == ["RPT000"]

    def test_cuda_rules_see_the_port_kernels(self):
        # the parser finds every __global__ kernel of the port's sources
        from repro_torch.analysis import rules_kernels as rk
        found = {}
        for p in sorted(CSRC.glob("*.cu")):
            text = rk._blank_comments_and_strings(p.read_text())
            found[p.name] = sorted(f.name for f in rk._cuda_functions(text)
                                   if f.kind == "__global__")
        assert found["cache_combine.cu"] == [
            "combine_legacy_kernel", "combine_rows_bulk_kernel",
            "combine_rows_kernel", "combine_rows_pipelined_kernel"]
        assert found["fused_update.cu"] == ["fused_update_kernel",
                                            "fused_update_ring_kernel"]
        assert found["flash_attention.cu"] == ["flash_fwd_kernel",
                                               "flash_fwd_wgmma_kernel"]
        assert all(found.values())

    MUTANTS = [(name, i) for name in ("cache_combine.cu", "fused_update.cu",
                                      "flash_attention.cu")
               for i, line in enumerate(
                   (CSRC / name).read_text().split("\n"))
               if "mbar_wait(" in line]

    @pytest.mark.parametrize("name,index", MUTANTS,
                             ids=[f"{n}:{i + 1}" for n, i in MUTANTS])
    def test_rpt203_deleted_wait_in_port_kernel(self, tmp_path, name, index):
        lines = (CSRC / name).read_text().split("\n")
        bar = lines[index].split("mbar_wait(")[1].lstrip("&").split("[")[0]
        bar = bar.split(",")[0].strip()
        del lines[index]
        out = check_cu(tmp_path, "\n".join(lines), name)
        assert out, f"deleting {name}:{index + 1} went unseen"
        assert set(rules_of(out)) == {"RPT203"}
        assert any(f"'{bar}'" in f.message and "mbar_wait" in f.message
                   for f in out)

    @pytest.mark.parametrize("stmt,message", [
        ("    bulk_wait<0>();  // every store has written out", "drains"),
        ("      bulk_commit();", "bulk_store"),
    ])
    def test_rpt203_deleted_drain_or_commit_in_k4(self, tmp_path, stmt,
                                                  message):
        src = (CSRC / "cache_combine.cu").read_text()
        assert stmt + "\n" in src
        out = check_cu(tmp_path, src.replace(stmt + "\n", ""),
                       "cache_combine.cu")
        assert rules_of(out) == ["RPT203"] and message in out[0].message


# --------------------------------------------------------------------------
# RPT2xx kernel invariants: the Python rules
# --------------------------------------------------------------------------

SCATTER_WRAPPER = '''\
def scatter_rows_(out, rows, slots, pipeline_depth=1):
    """In place: out[slots[i]] = rows[i]."""
    _launch("cache_update", f"cache_update_{suffix}", out, slots)
'''


class TestKernelRules:
    def test_rpt202_unmarked_caller_of_launching_wrapper(self):
        src = SCATTER_WRAPPER + """
def update(cache, rows, slots):
    return scatter_rows_(cache, rows, slots)
"""
        out = check(src)
        assert rules_of(out) == ["RPT202"]
        assert "'update'" in out[0].message and out[0].line == 5

    @pytest.mark.parametrize("dedupe", [
        "    slots = np.unique(slots)\n",
        "    slots = torch.unique(slots)\n",
        '    """Duplicate slots keep-last."""\n',
        '    """The last writer wins on a slot named twice."""\n',
    ], ids=["np.unique", "torch.unique", "keep-last", "last-writer"])
    def test_rpt202_negative_caller_dedupes_or_documents(self, dedupe):
        src = SCATTER_WRAPPER + f"""
def update(cache, rows, slots):
{dedupe}    return scatter_rows_(cache, rows, slots)
"""
        assert check(src) == []

    def test_rpt202_negative_docstring_contract_two_hops(self):
        src = SCATTER_WRAPPER + '''
def mid(cache, rows, slots):
    return scatter_rows_(cache, rows, slots)

def update_rows(cache, rows, slots):
    """Scatter rows; duplicate slots dedupe keep-last (last writer wins)."""
    return mid(cache, rows, slots)
'''
        assert check(src) == []

    def test_rpt202_index_copy_wrapper(self):
        src = """
def write_rows(block, ids, rows):
    block.index_copy_(0, ids, rows)

def put_rows(block, ids, rows):
    block.index_put_((ids.long(),), rows)

def local_slot(block, rows, pos):
    at = (pos % 8).reshape(1)
    block.index_copy_(0, at, rows)

def caller(block, ids, rows, pos):
    write_rows(block, ids, rows)
    put_rows(block, ids, rows)
    local_slot(block, rows, pos)
"""
        # the ids come from the caller in write_rows and put_rows only
        out = check(src)
        assert rules_of(out) == ["RPT202", "RPT202"]
        assert {m for f in out for m in ("'write_rows'", "'put_rows'")
                if m in f.message} == {"'write_rows'", "'put_rows'"}

    def test_rpt202_noqa_and_unused(self):
        src = SCATTER_WRAPPER + """
def update(cache, rows, slots):  # noqa: RPT202 - slots unique by construction
    return scatter_rows_(cache, rows, slots)
"""
        assert check(src) == []
        marked = src.replace("    return scatter_rows_",
                             "    slots = np.unique(slots)\n"
                             "    return scatter_rows_")
        assert rules_of(check(marked)) == ["RPT000"]

    def test_rpt202_report_only_cross_file(self, tmp_path):
        a = tmp_path / "wrapper.py"
        a.write_text(SCATTER_WRAPPER)
        b = tmp_path / "caller.py"
        b.write_text("def update(c, r, s):\n"
                     "    return scatter_rows_(c, r, s)\n")
        out = run_paths([str(a), str(b)], report_only={str(b)})
        assert rules_of(out) == ["RPT202"] and out[0].path == str(b)
        assert run_paths([str(a), str(b)], report_only={str(a)}) == []

    DEPTH = """\
def run(x, pipeline_depth=1):
    depth = _depth(pipeline_depth)
    if depth == 1:
        _launch("k", "k_f32", x, x.data_ptr())
        return
    _check_ring("K", depth, 8, x.shape[1], 4)
    _launch("k_pipelined", "k_pipelined_f32", x, x.data_ptr(), depth)
"""

    def test_rpt204_negative_checked_depth(self):
        assert check(self.DEPTH) == []

    @pytest.mark.parametrize("old,new,word", [
        ('    _check_ring("K", depth, 8, x.shape[1], 4)\n', "", "_check_ring"),
        ("depth = _depth(pipeline_depth)", "depth = int(pipeline_depth)",
         "_depth"),
    ], ids=["no-ring-check", "no-range-check"])
    def test_rpt204_positive(self, old, new, word):
        src = self.DEPTH.replace(old, new)
        assert src != self.DEPTH
        out = check(src)
        assert rules_of(out) == ["RPT204"]
        assert out[0].line == src.split("\n").index(
            '    _launch("k_pipelined", "k_pipelined_f32", x, x.data_ptr(), '
            'depth)') + 1
        assert word in out[0].message

    def test_rpt204_check_after_launch_fires(self):
        src = self.DEPTH.replace(
            '    _check_ring("K", depth, 8, x.shape[1], 4)\n', "") + \
            '    _check_ring("K", depth, 8, x.shape[1], 4)\n'
        assert rules_of(check(src)) == ["RPT204"]

    def test_rpt204_derived_names_flow(self):
        src = """\
def run(x, depth=2):
    d = depth
    args = (x.data_ptr(), d)
    _launch("k", "k_f32", x, *args)
"""
        out = check(src)
        assert rules_of(out) == ["RPT204"] and "_depth" in out[0].message

    def test_rpt204_launch_in_a_lambda(self):
        src = """\
def run(x, depth=2):
    d = _depth(depth)
    go = lambda: _launch("k", "k_f32", x, d)
    return go()
"""
        out = check(src)
        assert rules_of(out) == ["RPT204"] and out[0].line == 3
        assert check(src.replace("    go =", "    _check_ring('K', d, 8, 4, 4)"
                                 "\n    go =")) == []

    def test_rpt204_noqa_and_unused(self):
        src = self.DEPTH.replace(
            '    _check_ring("K", depth, 8, x.shape[1], 4)\n', "").replace(
            "x.data_ptr(), depth)",
            "x.data_ptr(), depth)  # noqa: RPT204 - ok")
        assert check(src) == []
        stale = self.DEPTH.replace("x.data_ptr(), depth)",
                                   "x.data_ptr(), depth)  # noqa: RPT204 - x")
        assert rules_of(check(stale)) == ["RPT000"]

    @pytest.mark.parametrize("delete", [
        '        _check_ring("K4", depth, COMBINE_ROW_BLOCK, f, '
        'miss.element_size())\n',
        '    _check_ring("K6", depth, UPDATE_ROW_BLOCK, f, '
        'out.element_size())\n',
    ], ids=["K4", "K6"])
    def test_rpt204_deleted_ring_check_in_port_ops(self, tmp_path, delete):
        src = (PORT / "kernels" / "ops.py").read_text()
        assert delete in src
        path = tmp_path / "ops.py"
        path.write_text(src.replace(delete, ""))
        out = run_paths([str(path)])
        assert rules_of(out) == ["RPT204"]
        assert "_check_ring" in out[0].message

    def test_rpt204_unchecked_depth_in_port_ops(self, tmp_path):
        src = (PORT / "kernels" / "ops.py").read_text()
        assert src.count("depth = _depth(pipeline_depth)") == 2
        path = tmp_path / "ops.py"
        path.write_text(src.replace("depth = _depth(pipeline_depth)",
                                    "depth = int(pipeline_depth)"))
        out = run_paths([str(path)])
        assert rules_of(out) == ["RPT204", "RPT204"]
        assert all("_depth" in f.message for f in out)

    FALLBACK = """\
def combine(x):
    _launch("k", "k_f32", x)

def step(x):
    try:
        combine(x)
    except RuntimeError:
        return ref(x)
"""

    def test_rpt205_try_falls_back_from_a_launch(self):
        out = check(self.FALLBACK)
        assert rules_of(out) == ["RPT205"] and out[0].line == 7
        assert "'combine'" in out[0].message

    @pytest.mark.parametrize("handler", [
        "    except RuntimeError:\n        raise\n",
        "    except RuntimeError as e:\n        log(e)\n",
    ], ids=["re-raise", "records"])
    def test_rpt205_negative_handler_keeps_the_failure(self, handler):
        src = self.FALLBACK.replace(
            "    except RuntimeError:\n        return ref(x)\n", handler)
        assert check(src) == []

    def test_rpt205_negative_try_reaches_no_kernel(self):
        src = self.FALLBACK.replace('    _launch("k", "k_f32", x)',
                                    "    return x + 1")
        assert check(src) == []

    def test_rpt205_build_in_try_across_files(self, tmp_path):
        a = tmp_path / "build.py"
        a.write_text("def warm():\n    return build_all()\n")
        b = tmp_path / "user.py"
        b.write_text("def go():\n    try:\n        warm()\n"
                     "    except Exception:\n        pass\n")
        out = run_paths([str(a), str(b)])
        assert rules_of(out) == ["RPT205"] and out[0].path == str(b)

    @pytest.mark.parametrize("src", [
        "import torch\nf = torch.compile(g)\n",
        "import torch\ntorch._dynamo.reset()\n",
        "import torch._dynamo\n",
        "from torch import compile\n",
        "import triton\n",
        "from triton import language as tl\n",
        "try:\n    import triton\nexcept ImportError:\n    triton = None\n",
        "LIB = library('cache_combine')\n",
        "class K:\n    libs = build_all()\n",
        "from torch.utils import cpp_extension\n"
        "m = cpp_extension.load(name='m', sources=['m.cu'])\n",
    ])
    def test_rpt205_compile_and_import_time_builds(self, src):
        out = check(src)
        assert out and set(rules_of(out)) == {"RPT205"}, src

    def test_rpt205_negative_lazy_build_and_import(self):
        src = """\
def launch(x):
    import triton
    lib = library("cache_combine")
    return triton, lib, build_all()
"""
        assert check(src) == []

    def test_rpt205_noqa_and_unused(self):
        src = self.FALLBACK.replace(
            "    except RuntimeError:",
            "    except RuntimeError:  # noqa: RPT205 - test double")
        assert check(src) == []
        assert rules_of(check("import torch  # noqa: RPT205 - x\n")) == [
            "RPT000"]


# --------------------------------------------------------------------------
# RPT3xx determinism & accounting
# --------------------------------------------------------------------------

class TestDeterminism:
    @pytest.mark.parametrize("call", [
        "np.random.seed(0)", "np.random.randint(10)",
        "torch.manual_seed(0)", "torch.seed()", "torch.random.manual_seed(1)",
        "torch.cuda.manual_seed(1)", "torch.cuda.manual_seed_all(1)",
        "torch.rand(3)", "torch.randn(2, 3, device=dev)",
        "torch.randint(0, 5, (3,))", "torch.randperm(8)",
        "torch.bernoulli(p)", "torch.multinomial(p, 1)",
        "torch.normal(0.0, 1.0, (3,))", "torch.randn_like(x)",
        "torch.rand_like(x, generator=g)", "x.uniform_()",
        "x.normal_(0, 1)", "x.random_(0, 7)", "x.bernoulli_(0.5)",
        "x.exponential_()",
    ])
    def test_rpt301_global_rng(self, call):
        out = check(f"import numpy as np\nimport torch\nv = {call}\n")
        assert rules_of(out) == ["RPT301"], call
        assert check(f"import torch\nv = {call}  # noqa: RPT301 - ok\n") == []

    @pytest.mark.parametrize("call", [
        "np.random.default_rng(7).integers(10)",
        "np.random.Generator(np.random.PCG64(3))",
        "torch.Generator().manual_seed(0)",
        "torch.Generator(device=dev).manual_seed(0)",
        "g.manual_seed(3)", "torch.rand(3, generator=g)",
        "torch.randint(0, 1 << 30, (4, 2), generator=g, device=dev)",
        "torch.randperm(8, generator=g)",
        "torch.multinomial(p, 1, generator=g)",
        "x.uniform_(generator=g)", "x.normal_(0, 1, generator=g)",
        "torch.zeros_like(x)", "rng.normal(size=3)",
    ])
    def test_rpt301_negative_explicit_generators(self, call):
        assert check(f"import numpy as np\nimport torch\nv = {call}\n") == []

    def test_rpt301_unused_noqa(self):
        out = check("import torch\nv = torch.zeros(3)  # noqa: RPT301 - x\n")
        assert rules_of(out) == ["RPT000"]

    @pytest.mark.parametrize("handler,rules", [
        ("    except:\n        pass\n", ["RPT302"]),
        ("    except BaseException:\n        pass\n", ["RPT302"]),
        ("    except (ValueError, BaseException):\n        pass\n",
         ["RPT302"]),
        ("    except BaseException:\n        raise\n", []),
        ("    except BaseException as e:\n        log.append(e)\n", []),
        ("    except Exception:\n        pass\n", []),
    ])
    def test_rpt302(self, handler, rules):
        src = f"def f(job, log):\n    try:\n        job()\n{handler}"
        assert rules_of(check(src)) == rules

    def test_rpt302_noqa_and_unused(self):
        src = ("def f(job):\n    try:\n        job()\n"
               "    except:  # noqa: RPT302 - test\n        pass\n")
        assert check(src) == []
        assert rules_of(check(src.replace("except:", "except Exception:"))
                        ) == ["RPT000"]


# --------------------------------------------------------------------------
# Engine mechanics
# --------------------------------------------------------------------------

class TestEngine:
    def test_rpt999_syntax_error_cannot_be_suppressed(self, tmp_path):
        assert rules_of(check("def broken(:\n")) == ["RPT999"]
        src = "def broken(:  # noqa: RPT999 - no\n"
        assert rules_of(check(src)) == ["RPT000", "RPT999"]
        p = tmp_path / "broken.py"
        p.write_text(src)
        assert rules_of(run_paths([str(p)])) == ["RPT000", "RPT999"]

    def test_rpt000_cannot_be_suppressed(self):
        src = guarded("    def peek(self):\n        with self._lock:\n"
                      "            return self.done  # noqa: RPT000\n")
        assert rules_of(check(src)) == ["RPT000"]

    def test_noqa_lists_rpr_codes_first(self):
        # one line both analyzers flag: RPR codes first, then RPT ones
        body = ("    def peek(self):\n        return self.pending"
                "  # noqa: RPR101, RPT101 - single writer\n")
        src = guarded(body)
        assert check(src) == []
        ref_src = src.replace("repro_torch.annotations",
                              "repro.analysis.annotations")
        eng = ref_analysis.Engine(ref_analysis.default_rules())
        assert eng.check_file("fixture.py", source=ref_src) == []
        # the other order hides the RPR code from the reference analyzer
        swapped = ref_src.replace("RPR101, RPT101", "RPT101, RPR101")
        assert check(swapped) == []
        assert [f.rule for f in eng.check_file("fixture.py",
                                               source=swapped)] == ["RPR101"]

    def test_rpr_codes_never_reported_unused(self):
        src = "x = 1  # noqa: RPR101, RPR103, E501 - reference's business\n"
        assert check(src) == []

    def test_findings_sorted_and_rendered(self):
        src = guarded("    def two(self):\n        self.pending = 0\n"
                      "        return self.done\n")
        out = check(src)
        assert out == sorted(out) and len(out) == 2
        rendered = out[0].render()
        assert "fixture.py:" in rendered and "RPT104" in rendered
        assert "[fix:" in rendered

    def test_walker_visits_every_node_exactly_once(self):
        files = [Path(p) for p in PORT_FILES if p.endswith(".py")][:30]
        assert files
        for path in files:
            source = path.read_text()
            expected = sum(1 for _ in ast.walk(ast.parse(source)))
            node_types = {type(n) for n in ast.walk(ast.parse(source))}
            seen = set()

            class Counter(Rule):
                types = tuple(node_types)

                def __init__(self):
                    self.visits = 0

                def visit(self, node, ctx):
                    self.visits += 1
                    if hasattr(node, "lineno"):
                        assert id(node) not in seen, "node visited twice"
                        seen.add(id(node))

            counter = Counter()
            eng = Engine([counter])
            eng.check_file(str(path), source=source, raw=True)
            assert eng.visited_nodes == expected
            assert counter.visits == expected

    def test_text_rules_see_only_cuda_and_python_rules_only_python(self,
                                                                  tmp_path):
        calls = []

        class Probe(Rule):
            types = (ast.Module,)

            def visit(self, node, ctx):
                calls.append(("py", Path(ctx.path).suffix))

            def check_text(self, ctx):
                calls.append(("text", Path(ctx.path).suffix))

        for name in ("a.py", "b.cu", "c.cuh"):
            (tmp_path / name).write_text("x = 1\n" if name.endswith(".py")
                                         else "int x;\n")
        Engine([Probe()]).run(iter_files(tmp_path))
        assert sorted(calls) == [("py", ".py"), ("text", ".cu"),
                                 ("text", ".cuh")]

    def test_raw_keeps_suppressed_findings(self, tmp_path):
        p = tmp_path / "f.py"
        p.write_text("import torch\nv = torch.rand(3)  # noqa: RPT301 - x\n")
        assert run_paths([str(p)]) == []
        assert rules_of(run_paths([str(p)], raw=True)) == ["RPT301"]

    def test_annotations_are_the_ports_own(self):
        assert guarded_by is port_annotations.guarded_by
        assert requires_lock is port_annotations.requires_lock

    def test_cli_exit_codes_without_torch(self, tmp_path):
        bad = tmp_path / "bad.py"
        bad.write_text("import torch\ntorch.manual_seed(0)\n")
        code = ("import runpy, sys\n"
                "sys.modules['torch'] = None\n"
                "sys.argv = ['repro_torch.analysis'] + sys.argv[1:]\n"
                "runpy.run_module('repro_torch.analysis', "
                "run_name='__main__')\n")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        ok = subprocess.run([sys.executable, "-c", code, "src/repro_torch"],
                            cwd=ROOT, env=env, capture_output=True,
                            text=True, timeout=300)
        assert ok.returncode == 0, ok.stdout + ok.stderr
        assert "repro_torch.analysis: 0 findings" in ok.stdout
        fail = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                              cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=300)
        assert fail.returncode == 1
        assert f"{bad}:2: RPT301" in fail.stdout

    def test_self_check_port_is_clean(self):
        # findings-as-errors over the port's Python, its CUDA sources and
        # chip_smoke.py
        assert any(p.endswith(".cu") for p in PORT_FILES)
        assert any(p.endswith(".cuh") for p in PORT_FILES)
        findings = run_paths(PORT_FILES)
        assert findings == [], "\n".join(f.render() for f in findings)


# --------------------------------------------------------------------------
# Parity with repro.analysis on the rules both analyzers share
# --------------------------------------------------------------------------

SHARED_EQUAL = {"101", "102", "104", "302", "303"}
SHARED_SUPERSET = {"103", "301"}   # the port's rules add torch's calls


def _reference_fixtures():
    """The reference's own fixture snippets for its lock and determinism
    rules, read from tests/test_analysis.py."""
    tree = ast.parse((ROOT / "tests" / "test_analysis.py").read_text())
    consts = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(
                node.targets[0], ast.Name) and isinstance(node.value,
                                                          ast.Constant):
            consts[node.targets[0].id] = node.value.value
    out = []
    for cls in tree.body:
        if not (isinstance(cls, ast.ClassDef) and cls.name in (
                "TestLockDiscipline", "TestDeterminism")):
            continue
        for fn in cls.body:
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) and \
                        isinstance(node.targets[0], ast.Name) and \
                        node.targets[0].id == "src":
                    v = node.value
                    if isinstance(v, ast.BinOp):
                        src = consts[v.left.id] + v.right.value
                    else:
                        src = v.value
                    out.append((f"{cls.name}.{fn.name}", src))
    return out


REF_FIXTURES = _reference_fixtures()


def _by_rule(findings):
    """rule number -> Counter of (path, line)."""
    out = {}
    for f in findings:
        out.setdefault(f.rule[3:], Counter())[(f.path, f.line)] += 1
    return out


def _assert_parity(ref, port):
    assert {f.rule[:3] for f in ref} <= {"RPR"}
    assert {f.rule[:3] for f in port} <= {"RPT"}
    ref_by, port_by = _by_rule(ref), _by_rule(port)
    for code in SHARED_EQUAL:
        assert ref_by.get(code, Counter()) == port_by.get(code, Counter()), \
            code
    for code in SHARED_SUPERSET:
        missing = ref_by.get(code, Counter()) - port_by.get(code, Counter())
        assert not missing, (code, missing)
    # the global numpy draws are the reference's rule unchanged
    np_port = Counter((f.path, f.line) for f in port
                      if f.rule == "RPT301" and "np.random" in f.message)
    assert np_port == ref_by.get("301", Counter())


def test_reference_fixtures_found():
    names = {n.split(".")[1] for n, _ in REF_FIXTURES}
    assert {"test_rpr101_read_outside_lock", "test_rpr102_lock_order_"
            "inversion_both_sites", "test_rpr103_blocking_calls_under_lock",
            "test_rpr104_write_outside_lock",
            "test_rpr303_augassign_outside_lock",
            "test_rpr301_global_state_np_random",
            "test_rpr302_bare_except_swallows"} <= names


@pytest.mark.parametrize("name,src", REF_FIXTURES,
                         ids=[n for n, _ in REF_FIXTURES])
def test_parity_on_reference_fixtures(name, src):
    ref = raw_findings(ref_analysis.Engine(ref_analysis.default_rules()),
                       ["fixture.py"], {"fixture.py": src})
    port = raw_findings(Engine(default_rules()), ["fixture.py"],
                        {"fixture.py": src})
    _assert_parity(ref, port)
    # and the fixtures that fire fire on both sides
    assert bool(ref) == bool([f for f in port if f.rule[3:] in
                              SHARED_EQUAL | SHARED_SUPERSET])


def test_parity_on_port_tree_raw():
    py = [p for p in PORT_FILES if p.endswith(".py")]
    ref = raw_findings(ref_analysis.Engine(ref_analysis.default_rules()), py)
    port = run_paths(py, raw=True)
    _assert_parity(ref, port)
    # the port's tree really exercises the comparison: both analyzers see
    # its suppressed findings, and RPT103 sees the torch copies RPR103 misses
    assert any(f.rule == "RPR101" for f in ref)
    assert sum(f.rule == "RPT103" for f in port) > sum(
        f.rule == "RPR103" for f in ref)
