#!/usr/bin/env python3
"""Where K4 (`gather_along`, `gather_along_many`, `walk_parents`) spends its
time, on one GPU: the redesigned kernels, each rebuilt with one part of the
design taken out at a time, beside the kernel before the redesign
(`chip_studies/k4_before.cu`, one thread per element, one array a launch),
at the shapes the planning path's search gives them.

    python3 chip_studies/k4_ablation.py

Shapes: the dedup table `best_g` at `cells` ([256, 440,000] f32 by
[256, 10,240] int32) with uniform random cells and with the cells of round
6 of a real hill search (`chip_smoke.capture_search`); the two dedup tables
at once (`gather_along_many`, 2 arrays); the pool by `sel` (8 arrays
[256, 8192] by [256, 1024] int64) and by `keep` (8 arrays [256, 18,432] by
[256, 8192] int64); the walk back through the arena ([256, 163,841], 161
steps) on the real search's arena and at full depth.

Variants (text edits of `uneven_planner_tpu_torch/csrc/gather.cu`, or
arguments of its C entry): `full`; `hints` (evict-first hints, `__ldcs`
and `__stcs`, on the index and output streams); `vec1`, `vec2` (one or
two indices a thread, in
place of four in one vector load); `scalar4` (four indices a thread, loaded
and stored one by one); `off64` (64-bit offsets); `block256` (blocks of 256
threads); `rows32`, `rows128` (at most 32 or 128 rows of the grid's y
dimension at once, the rest by the loop over rows); `ldcg`, `plain_ld` (the
table reads through the L2 only, or as plain loads, in place of the
read-only path); for the arrays read at
one index, `one_launch_each` (the same kernel launched once per array); for
the walk, `thread_walk` (a thread per scenario storing its row one element
at a time, the first version of this kernel).  Every variant keeps the
results, so each is held to the plain twin bit for bit.  Prints the card,
one JSON line per variant and shape (`device_ms`, the median of CUDA-graph
replays), and the registers `nvcc -Xptxas -v` reports for each K4 function.
"""

import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

THREAD_WALK = r'''__global__ void __launch_bounds__(kAlongThreads)
    walk_parents_kernel(const int* __restrict__ parent,
                        const int* __restrict__ start,
                        int* __restrict__ rev_ids,
                        uint8_t* __restrict__ rev_valid, int batch,
                        long long arena, int steps) {
  const int b = blockIdx.x * kAlongThreads + threadIdx.x;
  if (b >= batch) return;
  const int* row = parent + (long long)b * arena;
  int* ids = rev_ids + (long long)b * steps;
  uint8_t* valid = rev_valid + (long long)b * steps;
  int node = start[b];
  int s = 0;
  for (; s < steps && node >= 0; ++s) {
    ids[s] = node;
    valid[s] = 1;
    if (s + 1 < steps) node = row[node < arena ? node : arena - 1];
  }
  for (; s < steps; ++s) {
    ids[s] = 0;
    valid[s] = 0;
  }
}
'''

# the scalar index and output paths only (the vector path assumes four)
SCALAR_ONLY = [("  if constexpr (VEC) {\n    if constexpr (sizeof(IdxT) == 4) {",
                "  if constexpr (false) {\n    if constexpr (sizeof(IdxT) == 4) {"),
               ("      if constexpr (VEC && sizeof(T) == 4) {",
                "      if constexpr (false) {"),
               ("      } else if constexpr (VEC) {",
                "      } else if constexpr (false) {")]
EDITS = {
    "full": [],
    "hints": [
        ("const int4 q = *reinterpret_cast<const int4*>(idx + base);",
         "const int4 q = __ldcs(reinterpret_cast<const int4*>(idx + base));"),
        ("const longlong2 a = p[0], b = p[1];",
         "const longlong2 a = __ldcs(p), b = __ldcs(p + 1);"),
        ("v[k] = c0 + k < cols ? idx[base + k] : IdxT(0);",
         "v[k] = c0 + k < cols ? __ldcs(idx + base + k) : IdxT(0);"),
        ("*reinterpret_cast<uint4*>(out) =\n"
         "            make_uint4(v[j][0], v[j][1], v[j][2], v[j][3]);",
         "__stcs(reinterpret_cast<uint4*>(out),\n"
         "            make_uint4(v[j][0], v[j][1], v[j][2], v[j][3]));"),
        ("o[0] = make_ulonglong2(v[j][0], v[j][1]);",
         "__stcs(o, make_ulonglong2(v[j][0], v[j][1]));"),
        ("o[1] = make_ulonglong2(v[j][2], v[j][3]);",
         "__stcs(o + 1, make_ulonglong2(v[j][2], v[j][3]));"),
        ("if (c0 + k < cols) out[k] = v[j][k];",
         "if (c0 + k < cols) __stcs(out + k, v[j][k]);")],
    "vec1": [("constexpr int kAlongVec = 4; ", "constexpr int kAlongVec = 1; ")]
    + SCALAR_ONLY,
    "vec2": [("constexpr int kAlongVec = 4; ", "constexpr int kAlongVec = 2; ")]
    + SCALAR_ONLY,
    "block256": [("constexpr int kAlongThreads = 128;",
                  "constexpr int kAlongThreads = 256;")],
    "rows32": [("constexpr int kMaxGridY = 65535;",
                "constexpr int kMaxGridY = 32;")],
    "rows128": [("constexpr int kMaxGridY = 65535;",
                 "constexpr int kMaxGridY = 128;")],
    "ldcg": [("v[j][k] = __ldg(x + src[k]);", "v[j][k] = __ldcg(x + src[k]);")],
    "plain_ld": [("v[j][k] = __ldg(x + src[k]);", "v[j][k] = x[src[k]];")],
    "thread_walk": "walk",
}
# variants run through an argument of the C entry rather than an edit
CALLS = {"scalar4": dict(vec=False), "off64": dict(off32=False),
         "one_launch_each": dict(split=True)}


def thread_walk(src: str) -> str:
    """The source with the walk kernel replaced by the thread-per-scenario
    version and its launch sized for it."""
    s = src.index("__global__ void __launch_bounds__(kAlongThreads)\n"
                  "    walk_parents_kernel(")
    e = src.index("\n}\n", s) + 3
    src = src[:s] + THREAD_WALK + src[e:]
    old = "(unsigned)((batch + kWalkWarps - 1) /\n" \
          "                                     kWalkWarps);"
    if src.count(old) != 1:
        raise RuntimeError("walk launch anchor not found")
    return src.replace(old, "(unsigned)((batch + kAlongThreads - 1) / "
                       "kAlongThreads);")


def registers(log: str) -> list:
    out, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m and name and ("along" in name or "walk" in name):
            out.append(dict(function=name, registers=int(m.group(1))))
            name = None
    return out


def main():
    import ctypes
    import torch
    import chip_smoke as cs
    from k1_ablation import edited
    from k6_iterations import build_variants
    from uneven_planner_tpu_torch.config import FrontendConfig
    from uneven_planner_tpu_torch.kernels import gather
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    src = open(os.path.join(ROOT, "uneven_planner_tpu_torch/csrc/gather.cu")
               ).read()
    sources = {name: (thread_walk(src) if edits == "walk"
                      else edited(src, edits))
               for name, edits in EDITS.items()}
    before = open(os.path.join(ROOT, "chip_studies/k4_before.cu")).read()
    logs = {}
    libs = build_variants(sources, os.path.join(
        ROOT, "uneven_planner_tpu_torch/_build/studies"),
        declare=gather._declare, logs=logs)
    libs.update(build_variants({"before": before}, os.path.join(
        ROOT, "uneven_planner_tpu_torch/_build/studies"),
        declare=lambda lib: cs.before_library("k4_before")._declare(lib)))
    print(cs.nvidia_smi_line(), flush=True)
    for r in registers(logs["full"]):
        print(json.dumps(r), flush=True)

    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def along(lib, xs, idx, off32=True, vec=None, split=False):
        """K4 of `lib` on arrays xs at idx (axis 1), as the wrapper would
        launch it, or once per array (`split`)."""
        if split:
            return [o for x in xs for o in along(lib, [x], idx, off32, vec)]
        rows, cols = idx.shape
        outs = [torch.empty((rows, cols), dtype=x.dtype, device=dev)
                for x in xs]
        if vec is None:
            vec = cols % gather.ALONG_VEC == 0
        ptrs = lambda ts: (ctypes.c_void_p * len(ts))(
            *[t.data_ptr() for t in ts])
        err = lib.gather_along(ptrs(xs), ptrs(outs), len(xs), idx.data_ptr(),
                               rows, cols, xs[0].shape[1], xs[0].shape[1], 0,
                               1, xs[0].element_size(),
                               int(idx.dtype == torch.int64), int(off32),
                               int(vec), stream())
        if err:
            raise RuntimeError(f"launch failed ({err})")
        return outs

    def walk(lib, parent, start, steps):
        B = parent.shape[0]
        ids = torch.empty((B, steps), dtype=torch.int32, device=dev)
        valid = torch.empty((B, steps), dtype=torch.bool, device=dev)
        err = lib.walk_parents(parent.data_ptr(), start.data_ptr(),
                               ids.data_ptr(), valid.data_ptr(), B,
                               parent.shape[1], steps, stream())
        if err:
            raise RuntimeError(f"walk launch failed ({err})")
        return ids, valid

    gen = torch.Generator(device="cpu").manual_seed(5)
    rand = lambda shape: torch.randn(shape, generator=gen).to(dev)
    seen = cs.capture_search(dev)
    (round_best, best_g), cells = seen["cells"]
    B = PLAN = cs.PLAN_BATCH
    uniform = cs._edge_indices(440000, (B, 10240), 13, torch.int32, dev)
    wide = [rand((B, 440000)), rand((B, 440000))]
    pool = [(rand((B, 8192)) * 1e3).to(t)
            for t in [torch.float32] * 7 + [torch.int32]]
    merged = [(rand((B, 18432)) * 1e3).to(t)
              for t in [torch.float32] * 7 + [torch.int32]]
    gathers = {
        "best_g[cells] uniform": ([wide[1]], uniform),
        "best_g[cells] real": ([best_g], cells),
        "round_best, best_g [cells] uniform": (wide, uniform),
        "round_best, best_g [cells] real": ([round_best, best_g], cells),
        "pool[sel] 8 arrays": (pool, cs._edge_indices(
            8192, (B, 1024), 17, torch.int64, dev)),
        "new_pool[keep] 8 arrays": (merged, cs._edge_indices(
            18432, (B, 8192), 17, torch.int64, dev)),
    }
    for shape, (xs, idx) in gathers.items():
        want = gather.gather_along_many_twin(xs, idx)
        runs = {"before": lambda: [cs._k4_before(libs["before"], x, idx)
                                   for x in xs]}
        for name in EDITS:
            if name != "thread_walk":
                runs[name] = (lambda lib=libs[name], vec=(
                    False if name in ("vec1", "vec2") else None):
                    along(lib, xs, idx, vec=vec))
        for name, kw in CALLS.items():
            if name == "one_launch_each" and len(xs) == 1:
                continue
            runs[name] = lambda kw=kw: along(libs["full"], xs, idx, **kw)
        for name, run in runs.items():
            got = run()
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise RuntimeError(f"{name} on {shape} differs from the twin")
            print(json.dumps(dict(kernel="gather_along_many" if len(xs) > 1
                                  else "gather_along", variant=name,
                                  shape=shape, arrays=len(xs),
                                  device_ms=cs.device_ms(run))), flush=True)
    del wide, pool, merged, round_best, best_g
    torch.cuda.empty_cache()

    fe = FrontendConfig()
    walks = {"real search arena": seen["walk"],
             "full depth": (*cs._forest(PLAN, fe.frontier_size,
                                        fe.max_rounds, 19, dev),
                            fe.max_rounds + 1)}
    for shape, (parent, start, steps) in walks.items():
        want = gather.walk_parents_twin(parent, start, steps)
        for name in ("full", "thread_walk", "block256"):
            run = lambda lib=libs[name]: walk(lib, parent, start, steps)
            got = run()
            torch.cuda.synchronize()
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise RuntimeError(f"{name} walk on {shape} differs")
            print(json.dumps(dict(kernel="walk_parents", variant=name,
                                  shape=shape, steps=steps,
                                  device_ms=cs.device_ms(run))), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
