#!/usr/bin/env python3
"""What bounds the dense decode kernel, measured on one NVIDIA card.

    python3 tools/decode_study.py

At ``chip_smoke.DECODE_TIMED``'s shapes (one full-width layer of each dense
config: B 4, T 2080, kv_len 2064, D 128), by CUDA-graph replay on K/V
cycled past the L2 (``chip_smoke.graph_ms`` and ``cold_copies``), it times
``csrc/decode_attention.cu`` beside variants written from the same source:

* ``no_compute``: the chunk loop's copies and waits only;
* ``no_copy``: its compute only, on whatever shared memory holds;
* ``tensor_map``: each chunk's K (and V) rows as one TMA tensor copy, a 4-D
  map over (D, T, Hkv, B) encoded on the host at every call, instead of one
  bulk copy a row (rows dense, not skewed);
* the plan's spans against power-of-two spans of 64, 128 and 256 keys;
* ``phases``: a build that adds clock64 counts of each phase of warp 0's
  chunk loop, read after one launch (cycles a chunk, median over CTAs);
* MLA's absorbed decode at full width (``chip_smoke.MLA_SHAPE``) as the
  plan runs it (8 row warps over one chunk, V read from K's rows) beside
  V passed as a separate tensor and beside one row warp a CTA (the row
  tiles on the grid, each re-reading the keys).

The kernel and the tensor-map variant are held to the plain version
first.  Variants go to ``build/study/`` (listed in ``.gitignore``) and are
built with the port's nvcc flags.  It imports no JAX.
"""

from __future__ import annotations

import ctypes
import importlib
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402

SRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "decode_attention.cu"
OUT = ROOT / "build" / "study"
PHASES = ["wait K", "QK", "issue K", "softmax", "wait V", "P V", "issue V"]


def patch(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"decode_study: the kernel source changed; no single {old[:60]!r}")
        text = text.replace(old, new)
    return text


LOOP_START = "    for (int k = 0; k < my_n; ++k) {\n"
WAIT_K = "      mbar_wait(kbar(k), parity(k));\n      __syncwarp();\n"
QK_END = "      if (!shared_kv) {\n        group_sync();  // the K rows free\n"
SOFTMAX = "      // softmax of each row over the chunk"
WAIT_V = "      mbar_wait(vbar(k), parity(k));\n      __syncwarp();\n"
PV_END = "      group_sync();  // the V rows (with shared K/V, the chunk's slot) and P free\n"
LOOP_END = "        if (shared_kv && k + 2 < my_n) issue(k + 2, true);\n      }\n    }\n"
ISSUE = "  auto issue = [&](int k, bool is_k) {\n"


def ablated(src: str, part: str) -> str:
    """``part`` 'compute': no QK, softmax or P V; 'copy': no copies, no waits."""
    if part == "compute":
        return patch(src, [
            (WAIT_K, WAIT_K + "#if 0\n"), (QK_END, "#endif\n" + QK_END),
            (SOFTMAX, "#if 0\n" + SOFTMAX), (WAIT_V, "#endif\n" + WAIT_V + "#if 0\n"),
            (PV_END, "#endif\n" + PV_END)])
    return patch(src, [(ISSUE, ISSUE + "    return;\n"),
                       (WAIT_K, "      __syncwarp();\n"), (WAIT_V, "      __syncwarp();\n")])


def traced(src: str) -> str:
    """Count clock64 cycles in each phase of the loop; export them."""
    return patch(src, [
        ("namespace {\n\nconstexpr", "__device__ long long g_phase[1 << 16][8];\n"
         "namespace {\n\nconstexpr"),
        (LOOP_START, "    long long ph[8] = {}, tprev = clock64();\n"
         "#define PH(i) { long long tn = clock64(); ph[i] += tn - tprev; tprev = tn; }\n"
         + LOOP_START),
        (WAIT_K, WAIT_K + "      PH(0)\n"), (QK_END, "      PH(1)\n" + QK_END),
        (SOFTMAX, "      PH(2)\n" + SOFTMAX), (WAIT_V, "      PH(3)\n" + WAIT_V + "      PH(4)\n"),
        (PV_END, "      PH(5)\n" + PV_END),
        (LOOP_END, LOOP_END.replace("      }\n    }\n", "      }\n      PH(6)\n    }\n")
         + "    if (tid == 0) {\n      const int blin = blockIdx.x + gridDim.x * "
         "(blockIdx.y + gridDim.y * blockIdx.z);\n"
         "      for (int i = 0; i < 8; ++i) g_phase[blin][i] = ph[i] / my_n;\n    }\n"),
        ('extern "C" {\n', 'extern "C" {\n\nint decode_phases(long long* host, int n) {\n'
         "  return (int)cudaMemcpyFromSymbol(host, g_phase, (size_t)n * 64);\n}\n"),
    ])


def tensor_map(src: str) -> str:
    """Each chunk's rows as one TMA tensor copy through maps encoded per call."""
    return patch(src, [
        ("#include <cuda_runtime.h>\n", "#include <cuda.h>\n#include <cudaTypedefs.h>\n"
         "#include <cuda_runtime.h>\n"),
        ("struct Params {\n", "struct alignas(64) Params {\n  CUtensorMap kmap, vmap;\n"),
        ("  L.krow = round16(D * esize) + (t < 8 ? 16 * t : 0);",
         "  L.krow = round16(D * esize) + 0 * t;"),
        ("decode_kernel(const Params p) {", "decode_kernel(const __grid_constant__ Params p) {"),
        ("    uint64_t* bar = is_k ? kbar(k) : vbar(k);\n",
         "    uint64_t* bar = is_k ? kbar(k) : vbar(k);\n"
         "    if (lane == 0) {\n      mbar_expect_tx(bar, (uint32_t)(CK * bytes));\n"
         "      asm volatile(\"cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
         "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\\n\" ::\"r\"(smem_u32(dst)),"
         " \"l\"(reinterpret_cast<uint64_t>(is_k ? &p.kmap : &p.vmap)), \"r\"(0), \"r\"(key),"
         " \"r\"(ih), \"r\"(ib), \"r\"(smem_u32(bar)) : \"memory\");\n    }\n    return;\n"),
        ("  cudaStream_t st = static_cast<cudaStream_t>(stream);\n",
         "  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;\n"
         "  cudaDriverEntryPointQueryResult qres;\n"
         "  if (encode == nullptr && (cudaGetDriverEntryPoint(\"cuTensorMapEncodeTiled\", "
         "(void**)&encode, cudaEnableDefault, &qres) != cudaSuccess || encode == nullptr))\n"
         "    return (int)cudaErrorNotSupported;\n"
         "  const int es = dtype == 0 ? 4 : 2;\n"
         "  for (int w = 0; w < 2; ++w) {\n"
         "    const int width = w == 0 ? D : Dv;\n"
         "    cuuint64_t dims[4] = {(cuuint64_t)width, (cuuint64_t)T, (cuuint64_t)Hkv, "
         "(cuuint64_t)B};\n"
         "    cuuint64_t strides[3] = {(cuuint64_t)((w == 0 ? sk_t : sv_t) * es), "
         "(cuuint64_t)((w == 0 ? sk_h : sv_h) * es), (cuuint64_t)((w == 0 ? sk_b : sv_b) * es)};\n"
         "    cuuint32_t box[4] = {(cuuint32_t)width, (cuuint32_t)chunk, 1, 1}, "
         "estr[4] = {1, 1, 1, 1};\n"
         "    if (encode(w == 0 ? &p.kmap : &p.vmap, dtype == 0 ? "
         "CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, "
         "const_cast<void*>(w == 0 ? k : v), dims, strides, box, estr, "
         "CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, "
         "CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != "
         "CUDA_SUCCESS)\n      return (int)cudaErrorInvalidValue;\n  }\n"
         "  cudaStream_t st = static_cast<cudaStream_t>(stream);\n"),
    ])


def build(variants: dict) -> dict:
    """One nvcc per variant, all at once; returns the loaded libraries."""
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants.items():
        src = OUT / f"{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(OUT / f"lib{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"decode_study: nvcc failed for {name}:\n{out[-4000:]}")
    return {name: ctypes.CDLL(str(OUT / f"lib{name}.so")) for name in variants}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("decode_study: torch sees no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    dm = importlib.import_module("repro_torch.kernels.decode_attention")
    torch.backends.cuda.matmul.allow_tf32 = False
    src = SRC.read_text()
    libs = build({"kernel": src, "no_compute": ablated(src, "compute"),
                  "no_copy": ablated(src, "copy"), "tensor_map": tensor_map(src),
                  "phases": traced(src)})
    dev = torch.device("cuda", 0)
    cs.log(f"[study] {torch.cuda.get_device_name(0)}; nvidia-smi: {cs.nvidia_smi()}")
    gen = torch.Generator(device=dev).manual_seed(7)
    b, d, t, kv = cs.BATCH, 128, cs.PROMPT + cs.NEW_TOKENS, cs.DECODE_KV
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, dt, hkv, g in cs.DECODE_TIMED:
        dtype, h = getattr(torch, dt), hkv * g
        n = cs.cold_copies(2 * b * t * hkv * d * dtype.itemsize)
        sets = [tuple(torch.randn(s, generator=gen, device=dev).to(dtype)
                      for s in ((b, 1, h, d), (b, t, hkv, d), (b, t, hkv, d)))
                for _ in range(n)]
        key = (dev, b, h, hkv, t, d, d, dtype.itemsize, False)
        plan = dm.decode_plan(b, h, hkv, t, d, d, dtype.itemsize, False, sms)
        _, nbytes = cs.decode_work(b, h, hkv, d, d, kv, dtype.itemsize)
        bound = nbytes / cs.PEAK_BYTES * 1e3

        def timed(lib, pl=plan):
            _build._LIBS["decode_attention"] = lib
            dm._DECODE_PLANS[key] = pl
            return cs.graph_ms(torch, lambda i: dm.decode_attention(*sets[i % n], kv_len=kv),
                               reps=50)

        row = {}
        for name in ("kernel", "no_compute", "no_copy", "tensor_map"):
            if name in ("kernel", "tensor_map"):
                _build._LIBS["decode_attention"] = libs[name]
                dm._DECODE_PLANS[key] = plan
                err = max((dm.decode_attention(*sets[0], kv_len=x, window=w).float()
                           - dm.decode_attention_ref(*sets[0], kv_len=x, window=w).float())
                          .abs().max().item() for x, w in ((kv, 0), (1700, 600), (1, 0)))
                cs.check(err <= cs.TOL[dt], f"decode_study {label} {name}: max|err| {err}")
            row[name] = timed(libs[name])
        cs.log(f"[study] {label}: kernel {row['kernel']:.4f} ms, no_compute "
               f"{row['no_compute']:.4f}, no_copy {row['no_copy']:.4f}, tensor_map "
               f"{row['tensor_map']:.4f} (graph replays, {n} copies cycled); byte bound "
               f"{bound:.4f} ms; plan span {plan['span']} x {plan['nspan']}, "
               f"{plan['ctas']} CTAs")
        spans = []
        for span in (64, 128, 256):
            pl = dict(plan, span=span, nspan=-(-t // span))
            spans.append(f"span {span} ({b * hkv * pl['nspan']} CTAs) {timed(libs['kernel'], pl):.4f}")
        cs.log(f"[study] {label} spans: plan's {row['kernel']:.4f} ms; " + "; ".join(spans))
        lib = libs["phases"]
        lib.decode_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
        _build._LIBS["decode_attention"] = lib
        dm._DECODE_PLANS[key] = plan
        dm.decode_attention(*sets[0], kv_len=kv)
        torch.cuda.synchronize()
        ctas = plan["ctas"]
        buf = (ctypes.c_longlong * (ctas * 8))()
        cs.check(lib.decode_phases(ctypes.addressof(buf), ctas) == 0, "decode_study: phases")
        ph = np.frombuffer(buf, dtype=np.int64).reshape(ctas, 8)[:, :7]
        live = ph.sum(1) > 0
        cs.log(f"[study] {label} phases (cycles a chunk, warp 0, median of {int(live.sum())} "
               f"CTAs): " + ", ".join(f"{nm} {int(np.median(ph[live, i]))}"
                                      for i, nm in enumerate(PHASES)))
        dm._DECODE_PLANS.pop(key)
        del sets
    _build._LIBS["decode_attention"] = libs["kernel"]
    m = cs.MLA_SHAPE
    caches = [torch.randn((m["b"], t, m["hkv"], m["d"]), generator=gen, device=dev)
              for _ in range(cs.cold_copies(m["b"] * t * m["hkv"] * m["d"] * 4))]
    values = [c[..., :m["dv"]].contiguous() for c in caches]
    q = torch.randn((m["b"], 1, m["h"], m["d"]), generator=gen, device=dev)
    n = len(caches)
    plan = dm.decode_plan(m["b"], m["h"], m["hkv"], t, m["d"], m["dv"], 4, True, sms)
    grid_plan = dm.decode_plan(m["b"], m["h"], m["hkv"], t, m["d"], m["dv"], 4, False, sms)
    grid_plan.update(row_warps=1, groups=m["h"] // grid_plan["rows_tile"])
    grid_plan["nspan"] = -(-t // grid_plan["span"])
    row = {}
    for name, vals, pl in (("plan", None, plan), ("separate V", values, None),
                           ("row tiles on the grid", values, grid_plan)):
        dm._DECODE_PLANS.clear()
        if pl is not None:
            shared = vals is None
            dm._DECODE_PLANS[(dev, m["b"], m["h"], m["hkv"], t, m["d"], m["dv"], 4,
                              shared)] = pl

        def call(i, vals=vals):
            v = caches[i % n][..., :m["dv"]] if vals is None else vals[i % n]
            return dm.decode_attention(q, caches[i % n], v, kv_len=m["kv"])

        err = (call(0) - dm.decode_attention_ref(q, caches[0], caches[0][..., :m["dv"]],
                                                 kv_len=m["kv"])).abs().max().item()
        cs.check(err <= cs.TOL["float32"], f"decode_study MLA {name}: max|err| {err}")
        row[name] = cs.graph_ms(torch, call, reps=20)
    dm._DECODE_PLANS.clear()
    cs.log(f"[study] MLA full width (B {m['b']}, H {m['h']}, D {m['d']}, Dv {m['dv']}, kv "
           f"{m['kv']}, f32): " + "; ".join(f"{k} {v:.4f} ms" for k, v in row.items())
           + f" (graph replays, {n} caches cycled)")
    _build._LIBS.pop("decode_attention")
    return 0


if __name__ == "__main__":
    sys.exit(main())
