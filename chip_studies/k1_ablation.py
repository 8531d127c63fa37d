#!/usr/bin/env python3
"""Where K1 `terrain_tv_packed16` spends its time, on one GPU: the kernel
before its redesign and the redesigned one, each rebuilt with one part
taken out at a time, timed at the headline's shape (M = 368,640) and the
planning step's (M = 43,520), hi-only table with J (the solver's mode);
the full kernels also at the pipeline's step (M = 5,760) and the planning
search (M = 2,621,440, no J).

    python3 chip_studies/k1_ablation.py

The kernel before the redesign is `chip_studies/k1_before.cu` (a copy of
`uneven_planner_tpu_torch/csrc/terrain_lookup.cu` as it was, one thread per
sample, reading the table with its cells in (x, y, w) order, which the
study rebuilds for it; it is on no path of the package).  The redesigned one is the
package's own source, timed in both layouts (`thread`, `quad`) in full and
in the ablations' shapes in the layout its wrapper picks.
Variants (text edits of each source): `full`; `stcs` (the new kernel with
streaming stores, `st.global.cs`, for tv and J); `block256` (the new kernel
in blocks of 256 threads, as before, in place of 128); `no_j_stores` (J is not
written, so its math goes too); `const_rows` (the table rows do not depend on the pose: the loads can
issue at once and hit the same row); `adjacent_rows` (the two x corners
read one 64-byte aligned pair of rows: what a table that kept both
corners of every cell in one 64-byte record would read); `no_tail` (the 7-tuple tail and
its Jacobian without their square roots, divisions and cos/sin).  The time
a part costs is `full` less the variant without it; results are wrong by
design and are not checked, except that the `full`, `stcs` and `block256`
kernels must equal the plain twin bit for bit.  Prints the card, one JSON line per kernel, variant
and shape, and the registers and spills that `nvcc -Xptxas -v` reports for
each K1 function.
"""

import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (M, want_jac) of K1 on the main paths: the headline's and the planning
# path's solver steps, the pipeline's solver step, the planning search
SHAPES = {"headline": (4096 * 90, True), "planning step": (256 * 170, True),
          "pipeline step": (64 * 90, True),
          "planning search": (256 * 10240, False)}
# the ablations run at these two; the whole kernel and the variants that
# keep its results at every shape, in both layouts
ABLATED = ("headline", "planning step")
WHOLE = ("full", "stcs", "block256")

EDITS = {
    "before": {
        "no_j_stores": [(
            "  for (int k = 0; k < 21; ++k) jac[(long long)k * M + i] = J[k];",
            "")],
        "const_rows": [(
            "  const long long row[2] = {\n"
            "      clampll((c.ix0 * g.ny + c.iy0) * g.nyaw + c.iw, 0, last),\n"
            "      clampll((c.ix1 * g.ny + c.iy0) * g.nyaw + c.iw, 0, last)};",
            "  const long long row[2] = {0, 1};")],
        "no_tail": [
            ("  const float c = sqrtf(floor_at(q, 1e-12f));\n"
             "  const float inv_c = 1.f / c;\n"
             "  const float cy = cosf(yaw), sy = sinf(yaw);",
             "  const float c = q;\n  const float inv_c = c;\n"
             "  const float cy = yaw, sy = yaw;"),
            ("  const float sq = sqrtf(floor_at(p, 1e-12f));\n"
             "  const float inv_sq = 1.f / sq;",
             "  const float sq = p;\n  const float inv_sq = sq;"),
            ("-(zb0 * dzb0[k] + zb1 * dzb1[k]) / c",
             "-(zb0 * dzb0[k] + zb1 * dzb1[k]) * c"),
            ("-t * dt / sq", "-t * dt * sq")],
    },
    "new": {
        "no_j_stores": [
            ("  for (int k = 0; k < 21; ++k) jac[(long long)k * M + i] = J[k];",
             ""),
            ("    for (int r = 0; r < 7; ++r) jac[(long long)(3 * r + q) * M + i]"
             " = Jk[r];", "")],
        "const_rows": [
            ("  return clamp_to<Idx>((iy * (Idx)g.nyaw + iw) * (Idx)g.nx + ix, 0,\n"
             "                       (Idx)(2 * g.ncells - 1));",
             "  return Idx(0);")],
        "adjacent_rows": [(
            "    const Idx row = packed_row<T, Idx>(g, cx ? c.ix1 : c.ix0,"
            " c.iy0, c.iw);",
            "    const Idx row = (packed_row<T, Idx>(g, c.ix0, c.iy0, c.iw) &"
            " ~Idx(1)) + cx;", 2)],
        "block256": [("constexpr int kK1Block = 128;",
                      "constexpr int kK1Block = 256;")],
        "stcs": [
            ("  for (int k = 0; k < 7; ++k) tv[(long long)k * M + i] = t[k];",
             "  for (int k = 0; k < 7; ++k) __stcs(tv + (long long)k * M + i,"
             " t[k]);"),
            ("  for (int k = 0; k < 21; ++k) jac[(long long)k * M + i] = J[k];",
             "  for (int k = 0; k < 21; ++k) __stcs(jac + (long long)k * M + i,"
             " J[k]);"),
            ("    for (int r = 0; r < 7; ++r) jac[(long long)(3 * r + q) * M + i]"
             " = Jk[r];", "    for (int r = 0; r < 7; ++r) __stcs(jac + "
             "(long long)(3 * r + q) * M + i, Jk[r]);"),
            ("      if (JAC || (r & 3) == q) tv[(long long)r * M + i] = t[r];",
             "      if (JAC || (r & 3) == q) __stcs(tv + (long long)r * M + i,"
             " t[r]);")],
        "no_tail": [
            ("  a.c = sqrt_(floor_at(a.q, Num<T>::tiny));\n"
             "  a.inv_c = T(1) / a.c;\n  a.cy = cos_(yaw);\n"
             "  a.sy = sin_(yaw);",
             "  a.c = a.q;\n  a.inv_c = a.c;\n  a.cy = yaw;\n  a.sy = yaw;"),
            ("  a.sq = sqrt_(floor_at(a.p, Num<T>::tiny));\n"
             "  a.inv_sq = T(1) / a.sq;",
             "  a.sq = a.p;\n  a.inv_sq = a.sq;"),
            ("-(a.zb0 * dzb0 + a.zb1 * dzb1) / a.c",
             "-(a.zb0 * dzb0 + a.zb1 * dzb1) * a.c"),
            ("-a.t * dt / a.sq", "-a.t * dt * a.sq")],
    },
}


def edited(src, edits):
    """Apply (old, new) or (old, new, times) text edits; each old must occur
    exactly `times` (default once)."""
    for old, new, *times in edits:
        if src.count(old) != (times[0] if times else 1):
            raise RuntimeError(f"edit anchor not found as expected: "
                               f"{old[:60]!r}")
        src = src.replace(old, new)
    return src


def declare_before(lib):
    """The C interface of the kernel before the redesign (no index width or
    layout arguments)."""
    import ctypes
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.terrain_tv_packed16.argtypes = [p] * 6 + [i] + [i, i, i] + [f] * 11 \
        + [i, i, p]
    lib.terrain_tv_packed16.restype = i


def registers(log: str) -> list:
    """(function, registers, spill stores, spill loads) of every K1 function
    in an `nvcc -Xptxas -v` log."""
    out, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name, spills = m.group(1), (None, None)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name and "packed16" in name:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name and "packed16" in name:
            out.append(dict(function=name, registers=int(m.group(1)),
                            spill_stores=spills[0], spill_loads=spills[1]))
            name = None
    return out


def main():
    import torch
    import chip_smoke as cs
    from k6_iterations import build_variants
    from uneven_planner_tpu_torch import headline
    from uneven_planner_tpu_torch.kernels import terrain_lookup as tl
    from uneven_planner_tpu_torch.terrain import grid as tgrid
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    here = os.path.dirname(os.path.abspath(__file__))
    srcs = {"before": open(os.path.join(here, "k1_before.cu")).read(),
            "new": open(os.path.join(
                ROOT, "uneven_planner_tpu_torch/csrc/terrain_lookup.cu"))
            .read()}
    sources = {}
    for kern, src in srcs.items():
        sources[f"{kern}_full"] = src
        for variant, edits in EDITS[kern].items():
            sources[f"{kern}_{variant}"] = edited(src, edits)
    logs, libs = {}, {}
    for kern, declare in (("before", declare_before), ("new", tl._declare)):
        libs.update(build_variants(
            {k: v for k, v in sources.items() if k.startswith(kern + "_")},
            os.path.join(ROOT, "uneven_planner_tpu_torch", "_build",
                         "studies"), declare=declare, logs=logs))
    print(cs.nvidia_smi_line(), flush=True)
    for name in ("before_full", "new_full"):
        for r in registers(logs[name]):
            print(json.dumps(dict(kernel=name.split("_")[0], **r)),
                  flush=True)

    _, grid = headline.scene_setup(device="cuda")
    geom = tgrid.kernel_geometry(grid)
    # the kernel before the redesign reads the cells in (x, y, w) order
    nx, ny, nyaw = grid.voxel_num
    tables = {"new": grid.data_packed16,
              "before": grid.data_packed16.reshape(2, ny, nyaw, nx, 8)
              .permute(0, 3, 1, 2, 4).contiguous().reshape(-1, 8)}
    stream = lambda: torch.cuda.current_stream().cuda_stream
    for shape, (M, want_jac) in SHAPES.items():
        px, py, yaw = cs.smoke_poses(grid, M, seed=1)
        tv = torch.empty((7, M), device="cuda")
        jac = torch.empty((7, 3, M), device="cuda") if want_jac else None
        head = lambda kern: [
            px.data_ptr(), py.data_ptr(), yaw.data_ptr(),
            tables[kern].data_ptr(), tv.data_ptr(),
            jac.data_ptr() if want_jac else None, M, *geom, 0, int(want_jac)]
        picked = tl.packed16_layout(M, tl._sm_count(px.device))
        want = tgrid.packed16_tv_jac(grid, px, py, yaw, False, want_jac)
        for name, lib in libs.items():
            kern, variant = name.split("_", 1)
            if variant not in WHOLE and shape not in ABLATED:
                continue
            layouts = [None] if kern == "before" else (
                tl.LAYOUTS if variant in WHOLE else [picked])
            for layout in layouts:
                args = head(kern) if layout is None else head(kern) + [
                    1, int(layout == "quad")]
                call = lambda: lib.terrain_tv_packed16(*args, stream())
                if call() != 0:
                    raise RuntimeError(f"{name} {layout}: launch failed")
                torch.cuda.synchronize()
                row = dict(kernel=kern, variant=variant, shape=shape, M=M,
                           want_jac=want_jac,
                           layout=layout or "thread per sample",
                           layout_picked=layout == picked
                           if layout else None,
                           device_ms=cs.device_ms(call))
                if variant in WHOLE:
                    row["equal_to_twin"] = bool(
                        torch.equal(tv, want[0]) and (
                            not want_jac or torch.equal(jac, want[1])))
                    if not row["equal_to_twin"]:
                        raise RuntimeError(f"{name} {layout} differs from "
                                           "the twin")
                print(json.dumps(row), flush=True)
        del px, py, yaw, tv, jac, want
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
