#!/usr/bin/env python3
"""Where K6 `admm_iterations` spends an iteration, on one GPU: the kernel
rebuilt with one part of its loop taken out at a time, each timed on the
first QP pass of a real figure-eight tick.

    python3 chip_studies/k6_ablation.py

Every lane runs the whole 400-iteration budget (tolerances 0), so a variant
that no longer converges is timed over the same count.  Variants (text
edits of `uneven_planner_tpu_torch/csrc/admm_qp.cu`, at its compiled shape
n = 60, m = 118): `full`; `no_columns` (stage C without the column groups:
A'y, A'v, P x and the dual residual); `no_rows` (stage C without A x and
the primal residual); `no_product_b` (stage B without its product);
`no_test` (no warp or block maxima, no termination test); `bare` (all four
out: the barriers, the updates and the loop).  The time a part costs is
`full` less the variant without it; results are wrong by design and are
not checked.  One JSON line per variant and batch width (256 and 64 lanes).
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

EDITS = {
    "no_columns": [("        if (g < NT / 4) columns(4 * g, tid & (kSlices - 1));",
                    "        if (g < 0) columns(4 * g, tid & (kSlices - 1));")],
    "no_rows": [("        if (tid < MT) row(tid);", "        if (tid < 0) row(tid);")],
    "no_product_b": [("      if (tid < NT + MT) d = reg_dot<NT>(w, s_rhs);",
                      "      if (tid < NT + MT) d = s_rhs[tid & 31];")],
    "no_test": [("    if (k > 0) {\n      const int wl = tid & 31;",
                 "    if (k > 0) {\n      it += 1;\n      done = it >= a.max_iter;\n    }\n"
                 "    if (false) {\n      const int wl = tid & 31;"),
                ("    rp = warp_absmax(rp);\n    rd = warp_absmax(rd);\n"
                 "    pn = warp_absmax(pn);\n    dn = warp_absmax(dn);\n", "")],
}
EDITS["bare"] = [e for k in ("no_columns", "no_rows", "no_product_b", "no_test")
                 for e in EDITS[k]]


def edited(src, edits):
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"edit anchor not found once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def main():
    import torch
    import chip_smoke as cs
    from k6_iterations import build_variants
    from uneven_planner_tpu_torch.kernels import admm
    from uneven_planner_tpu_torch.solver import admm_qp
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    src_path = os.path.join(ROOT, "uneven_planner_tpu_torch/csrc/admm_qp.cu")
    src = open(src_path).read()
    libs = build_variants({"full": src, **{k: edited(src, e)
                                          for k, e in EDITS.items()}},
                          os.path.join(os.path.dirname(src_path), "..",
                                       "_build", "studies"))
    print(cs.nvidia_smi_line(), flush=True)
    for lanes in (cs.MPC_LANES, cs.PIPE_LANES):
        cases, cfg = cs._tick_qps("cuda", lanes=lanes)
        label, qp, x0, y0 = cases[0]
        setup = admm_qp.setup_qp(*qp, rho=cfg.qp_rho, sigma=cfg.qp_sigma,
                                 x0=x0, y0=y0)
        d, s = setup.data, setup.state
        kw = dict(sigma=cfg.qp_sigma, alpha=cfg.qp_alpha, eps_abs=0.0,
                  eps_rel=0.0, max_iter=cfg.qp_max_iter, n_iters=400)
        kernel = admm.LIBRARY.load()
        try:
            for name, lib in libs.items():
                admm.LIBRARY._lib = lib
                ms = cs.device_ms(lambda: admm.admm_iterations(d, s, **kw),
                                  reps=15, inner=4)
                print(json.dumps(dict(variant=name, lanes=lanes,
                                      qp=label, iterations=400,
                                      device_ms=ms)), flush=True)
        finally:
            admm.LIBRARY._lib = kernel


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
