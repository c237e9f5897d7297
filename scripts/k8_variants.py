"""Time design variants of K8's bf16 body (flash attention) on one card.

    python3 scripts/k8_variants.py [--rounds 2] [--parent DIR]
                                   [--variants a,b] [--out DIR]

Each variant is a copy of ``src/repro_torch/kernels/csrc`` with one named
change to ``flash_attention.cu`` (a text patch whose anchor must occur
exactly once), built with nvcc (all at once, the port's flags) into
``build/k8_variants/``.  ``--parent DIR`` adds the ``csrc`` of another
checkout (say ``git archive`` of the parent commit) unchanged, as
``parent``.  Every variant runs at the three shapes ``chip_smoke.py``
times K8 at (the serving prefill of llama3.2-1b, llama4-scout's and
zamba2-7b's heads: q [B, S, Hkv, G, D] bf16, seeded), must be within
1e-2 of the plain version there, and is timed with chip_smoke's
yardsticks: ``ms``, the device time of one call alone with the L2 flushed
before it, and ``call_ms``, one host-inclusive call.  The variants run in
turns, in order and then reversed, ``--rounds`` times, so a drift of the
card shows as a spread; ``scaled_dot_product_attention`` on the same
inputs (timed only; the port never calls it) runs in every round.

Prints the card's name and power limit, the bf16 body's registers, spills,
ptxas's note that it serialised the wgmma products (C7520) and shared
bytes per head dim and variant (``-Xptxas -v``), one JSON line
per variant, shape and round, and last one summary line; with ``--out``
every line also goes to ``DIR/k8_variants.jsonl``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts src/ on the path)
import torch  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT_DIR = ROOT / "build" / "k8_variants"
FLASH = "flash_attention.cu"
# name -> (B, S, Hkv, G, D)
SHAPES = {"prefill": (4, 4096, 8, 4, 64), "scout": (4, 4096, 8, 5, 128),
          "zamba": (4, 4096, 32, 1, 112)}

# the overlap steps, each a patch that takes it out of the shipped body
NO_INTRA = [("    wgmma_wait<1>();\n", "    wgmma_wait<0>();\n")]
NO_PINGPONG = [
    ("  auto take_turn = [&] { named_bar_sync(3 + wc, 2 * kWg); };",
     "  auto take_turn = [&] {};"),
    ("  auto pass_turn = [&] { named_bar_arrive(4 - wc, 2 * kWg); };",
     "  auto pass_turn = [&] {};"),
    ("  if (wc == 1) named_bar_arrive(3, 2 * kWg);\n", ""),
    ("  if (wc == 0) named_bar_sync(3, 2 * kWg);\n", "")]
EXACT_EXP = [
    ("      alpha[hf] = exp2_ftz(", "      alpha[hf] = exp2f("),
    ("const float p = exp2_ftz(fmaf(sc[4 * j + e]",
     "const float p = exp2f(fmaf(sc[4 * j + e]")]
DIVIDE = [("      const float inv = 1.f / fmaxf(lt, 1e-30f);\n",
           "      const float inv = fmaxf(lt, 1e-30f);\n"),
          ("            pack_bf16x2(acc[4 * j + 2 * hf] * inv,\n"
           "                        acc[4 * j + 2 * hf + 1] * inv);",
           "            pack_bf16x2(acc[4 * j + 2 * hf] / inv,\n"
           "                        acc[4 * j + 2 * hf + 1] / inv);")]
PERSISTENT = [("  const int64_t grid = ceil_div(s * g, kWsRows) * hkv * b;\n",
               "  const int64_t n_items = ceil_div(s * g, kWsRows) * hkv"
               " * b;\n"
               "  int64_t grid = n_items;\n"
               "  err = persistent_grid(n_items, 1, &grid);\n"
               "  if (err != cudaSuccess) return err;\n")]
# name -> [(anchor, replacement)] in flash_attention.cu
VARIANTS: dict = {
    # (a) + (b) + (c): the TMA ring, the ping-pong, the overlap within a
    # warpgroup (softmax of tile t while P V of tile t-1 runs)
    "shipped": [],
    # (a) + (b): softmax only after both products are done
    "no_intra": NO_INTRA,
    # (a) + (c): the consumers issue whenever they are ready
    "no_pingpong": NO_PINGPONG,
    # (a) alone: the producer / consumer overlap through the ring
    "ring_only": NO_INTRA + NO_PINGPONG,
    # the shipped body with a 2-stage ring
    "two_stages": [("  static constexpr int kStages = 3;",
                    "  static constexpr int kStages = 2;")],
    # a 4-stage ring where it fits (Dp <= 64)
    "four_stages": [("  static constexpr int kStages = 3;",
                     "  static constexpr int kStages = kDp >= 128 ? 3 : 4;")],
    # exp2f (accurate for subnormal results) in place of one MUFU.EX2
    "exact_exp": EXACT_EXP,
    # the epilogue divides by max(l, 1e-30) instead of one reciprocal a row
    "divide": DIVIDE,
    # a persistent grid (one CTA an SM, each walking a fixed share of the
    # items) instead of one CTA an item
    "persistent": PERSISTENT,
    # the body before the fast exp and the reciprocal
    "exact_divide": EXACT_EXP + DIVIDE,
}
_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 4 + [
    ctypes.c_int, ctypes.c_int64, ctypes.c_void_p]


def emit(fh, **line) -> None:
    text = json.dumps(line, default=float)
    print(text, flush=True)
    if fh is not None:
        fh.write(text + "\n")


def make_variant(name: str, src_dir: Path, patches: list) -> Path:
    dst = OUT_DIR / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src_dir, dst)
    path = dst / FLASH
    text = path.read_text()
    for old, new in patches:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: anchor {old!r} occurs "
                               f"{text.count(old)} times in {FLASH}")
        text = text.replace(old, new)
    path.write_text(text)
    return dst


def build(dirs: dict) -> dict:
    """One nvcc per variant, all started together; returns name ->
    (library path, -Xptxas -v log)."""
    from repro_torch.kernels import build as kbuild
    nvcc = kbuild._nvcc()
    procs = {}
    for name, d in dirs.items():
        lib = d / "libflash_attention.so"
        cmd = [nvcc, *kbuild.NVCC_FLAGS, "-I", str(d), "-o", str(lib),
               str(d / FLASH)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    out, failed = {}, []
    for name, (proc, lib) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{text}")
        out[name] = (lib, text)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def bf16_registers(log: str) -> list:
    """The ptxas lines of the bf16 body's kernels (every head dim): head
    dim, registers, spill stores and loads, and whether ptxas serialised
    the wgmma products (its C7520 note)."""
    serialised = {int(m.group(1)) for m in re.finditer(
        r"C7520\).*?wgmma_kernelILi(\d+)E", log)}
    res, fn, spill = [], None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn, spill = m.group(1), None
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn and ("wgmma" in fn or "bf16" in fn):
            d = re.search(r"ILi(\d+)E", fn)
            dim = int(d.group(1)) if d else None
            res.append(dict(d=dim, registers=int(m.group(1)), spill=spill,
                            wgmma_serialised=dim in serialised))
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--parent", default=None,
                    help="root of another checkout whose csrc is timed "
                    "unchanged as 'parent'")
    ap.add_argument("--variants", default=None,
                    help="comma-separated names to run (default: all)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k8_variants: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    import torch.nn.functional as F
    from repro_torch.kernels import ref

    fh = None
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        fh = open(Path(args.out) / "k8_variants.jsonl", "w")
    print(chip_smoke.nvidia_smi(), flush=True)
    chosen = args.variants.split(",") if args.variants else list(VARIANTS)
    dirs = {name: make_variant(name, CSRC, VARIANTS[name])
            for name in chosen if name in VARIANTS}
    if args.parent:
        dirs["parent"] = make_variant(
            "parent", Path(args.parent) / "src/repro_torch/kernels/csrc", [])
    fns = {}
    for name, (lib, log) in build(dirs).items():
        fn = ctypes.CDLL(str(lib)).flash_attention_bf16
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGS
        fns[name] = fn
        smem = getattr(ctypes.CDLL(str(lib)),
                       "flash_attention_bf16_smem_bytes", None)
        if smem is not None:
            smem.restype, smem.argtypes = ctypes.c_int64, [ctypes.c_int]
        emit(fh, variant=name, ptxas=bf16_registers(log),
             smem_bytes=None if smem is None else {
                 d: smem(d) for d in (16, 32, 64, 112, 128)})

    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    readings: dict = {(v, s): [] for v in [*fns, "sdpa"] for s in SHAPES}
    inputs = {}
    for shape_name, shape in SHAPES.items():
        b, s, hkv, g, d = shape
        gen = torch.Generator(device=dev).manual_seed(1)
        q = torch.randn(b, s, hkv, g, d, generator=gen,
                        device=dev).bfloat16()
        k = torch.randn(b, s, hkv, d, generator=gen, device=dev).bfloat16()
        v = torch.randn(b, s, hkv, d, generator=gen, device=dev).bfloat16()
        want = ref.flash_attention(q, k, v, 512)
        out = torch.empty_like(q)
        inputs[shape_name] = (q, k, v, out)
        for name, fn in fns.items():
            out.fill_(float("nan"))
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    b, s, hkv, g, d, 0, stream)
            torch.cuda.synchronize()
            chip_smoke.check(rc == 0, f"{name}: CUDA error {rc}")
            err = chip_smoke.close(out, want, 1e-2, 1e-2,
                                   f"{name} at {shape_name}")
            emit(fh, variant=name, shape=shape_name, max_abs_err=err)
        del want

    def call(name: str, shape_name: str) -> None:
        q, k, v, out = inputs[shape_name]
        b, s, hkv, g, d = SHAPES[shape_name]
        if name == "sdpa":
            F.scaled_dot_product_attention(
                q.view(b, s, hkv * g, d).transpose(1, 2), k.transpose(1, 2),
                v.transpose(1, 2), is_causal=True, enable_gqa=True)
            return
        rc = fns[name](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), b, s, hkv, g, d, 0, stream)
        if rc != 0:
            raise RuntimeError(f"{name}: CUDA error {rc}")

    order = [*fns, "sdpa"]
    for rnd in range(args.rounds):
        for name in (order if rnd % 2 == 0 else order[::-1]):
            for shape_name in SHAPES:
                t = chip_smoke.timed(lambda: call(name, shape_name))
                readings[(name, shape_name)].append(t)
                emit(fh, variant=name, shape=shape_name, round=rnd, **t)
    summary = {}
    for (name, shape_name), rs in readings.items():
        b, s, hkv, g, d = SHAPES[shape_name]
        flops = 2 * b * hkv * g * d * s * s
        ms = statistics.mean(r["ms"] for r in rs)
        summary.setdefault(name, {})[shape_name] = dict(
            ms=ms, ms_all=[r["ms"] for r in rs],
            call_ms=statistics.mean(r["call_ms"] for r in rs),
            tflops=flops / (ms * 1e-3) / 1e12,
            bound_fraction=flops / chip_smoke.BF16_TFLOPS / (ms * 1e-3))
    emit(fh, summary=summary, timing=chip_smoke.TIMING["method"],
         nvidia_smi=chip_smoke.nvidia_smi())
    if fh is not None:
        fh.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
