#!/usr/bin/env python3
"""Where K2 `terrain_tv_pair` spends its time, on one GPU: the kernel before
its redesign (`chip_studies/k2_before.cu`: a thread per sample in blocks of
256, the pair table in (x, y, w) cell order, 64-bit index math, want_jac a
run-time flag) and the redesigned one, with one part taken out at a time,
at the sizes K2 is given on the main paths and between them (with J, as
init_scaling asks; the headline's also without).

    python3 chip_studies/k2_ablation.py

Variants of `uneven_planner_tpu_torch/csrc/terrain_lookup.cu`: `full`, in
both layouts (`thread`, `quad`: a thread or a quad of lanes per sample) and
with 64-bit index math (`idx64`); `xyw_order` (the redesigned kernel on the
table in the old (x, y, w) cell order, so a lookup's two x corners are rows
ny * nyaw apart); `block256` (blocks of 256 threads).  Every variant keeps
the results and is held to the plain twin bit for bit.  Prints the card,
one JSON line per variant, layout and size (`device_ms`, the median of
CUDA-graph replays), and the registers `nvcc -Xptxas -v` reports for each
K2 function.
"""

import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SIZES = (5760, 11520, 21760, 43520, 87040, 218880, 368640, 1653760)
EDITS = {
    "full": [],
    "xyw_order": [(
        "  return clamp_to<Idx>((iy * (Idx)g.nyaw + iw) * (Idx)g.nx + ix, 0,\n"
        "                       (Idx)(g.ncells - 1));",
        "  return clamp_to<Idx>((ix * (Idx)g.ny + iy) * (Idx)g.nyaw + iw, 0,\n"
        "                       (Idx)(g.ncells - 1));")],
    "block256": [("constexpr int kK2Block = 128;",
                  "constexpr int kK2Block = 256;")],
}


def registers(log: str) -> list:
    out, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m and name and "pair" in name:
            out.append(dict(function=name, registers=int(m.group(1))))
            name = None
    return out


def main():
    import torch
    import chip_smoke as cs
    from k1_ablation import edited
    from k6_iterations import build_variants
    from uneven_planner_tpu_torch import headline
    from uneven_planner_tpu_torch.kernels import terrain_lookup as tl
    from uneven_planner_tpu_torch.terrain import grid as tgrid
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    src = open(os.path.join(
        ROOT, "uneven_planner_tpu_torch/csrc/terrain_lookup.cu")).read()
    out_dir = os.path.join(ROOT, "uneven_planner_tpu_torch/_build/studies")
    logs = {}
    libs = build_variants({f"k2_{k}": edited(src, e)
                           for k, e in EDITS.items()}, out_dir,
                          declare=tl._declare, logs=logs)
    before = cs.before_library("k2_before")
    libs.update(build_variants(
        {"k2_before": open(before.source).read()}, out_dir,
        declare=before._declare))
    print(cs.nvidia_smi_line(), flush=True)
    for r in registers(logs["k2_full"]):
        print(json.dumps(r), flush=True)

    _, grid = headline.scene_setup(device="cuda")
    geom = tgrid.kernel_geometry(grid)
    nx, ny, nyaw = grid.voxel_num
    xyw = grid.data_pair.reshape(ny, nyaw, nx, 8).permute(2, 0, 1, 3) \
        .contiguous().reshape(-1, 8)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    sms = tl._sm_count(torch.device("cuda"))
    cases = [(M, True) for M in SIZES] + [(368640, False)]
    for M, want_jac in cases:
        px, py, yaw = cs.smoke_poses(grid, M, seed=1)
        tv = torch.empty((7, M), device="cuda")
        jac = torch.empty((7, 3, M), device="cuda") if want_jac else None
        want = tgrid.pair_tv_jac(grid, px, py, yaw, want_jac)
        head = lambda table: [px.data_ptr(), py.data_ptr(), yaw.data_ptr(),
                              table.data_ptr(), tv.data_ptr(),
                              jac.data_ptr() if want_jac else None, M, *geom,
                              int(want_jac)]
        runs = {("before", "thread"): lambda: libs["k2_before"]
                .terrain_tv_pair(*head(xyw), stream())}
        for layout in tl.LAYOUTS:
            q = int(layout == "quad")
            runs[("full", layout)] = lambda q=q: libs["k2_full"] \
                .terrain_tv_pair(*head(grid.data_pair), 1, q, stream())
            runs[("idx64", layout)] = lambda q=q: libs["k2_full"] \
                .terrain_tv_pair(*head(grid.data_pair), 0, q, stream())
            runs[("xyw_order", layout)] = lambda q=q: libs["k2_xyw_order"] \
                .terrain_tv_pair(*head(xyw), 1, q, stream())
            runs[("block256", layout)] = lambda q=q: libs["k2_block256"] \
                .terrain_tv_pair(*head(grid.data_pair), 1, q, stream())
        for (variant, layout), run in runs.items():
            if run() != 0:
                raise RuntimeError(f"{variant} {layout}: launch failed")
            torch.cuda.synchronize()
            if not (torch.equal(tv, want[0])
                    and (not want_jac or torch.equal(jac, want[1]))):
                raise RuntimeError(f"{variant} {layout} at M = {M} differs "
                                   "from the twin")
            print(json.dumps(dict(
                variant=variant, layout=layout, M=M, want_jac=want_jac,
                layout_picked=layout == tl.pair_layout(M, sms),
                device_ms=cs.device_ms(run))), flush=True)
        del px, py, yaw, tv, jac, want
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
