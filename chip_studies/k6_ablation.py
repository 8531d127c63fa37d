#!/usr/bin/env python3
"""Where K6 `admm_iterations` spends an iteration, on one GPU: the kernel
rebuilt with one part of its loop taken out at a time, each timed on the
first QP pass of a real figure-eight tick.

    python3 chip_studies/k6_ablation.py
    python3 chip_studies/k6_ablation.py --qp full [--before PATH]

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

`--qp full` takes the sparse instantiation apart instead, on the full QP of
a real tick (`chip_smoke._tick_qps_full`: 256 lanes in float32, the first
64 in float64), each variant launched as "sparse" through `launch_variant`:
`full`; `staging` (the loop leaves before its first iteration: the
compression and the first rhs); `no_b1` (no Minv product); `no_b2` (no rows
of A); `no_c` (no columns of A, no rows of P); `no_test` (no maxima, no
termination test); `bare` (all four out).  Beside them the global
instantiation as built (`global`) and, with `--before PATH`, as built from
the admm_qp.cu at PATH (`global_before`: an earlier version, to tell a
change of its code from a change of the card).
"""

import argparse
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

# edits of the sparse instantiation, applied after SPARSE_MARK only
SPARSE_MARK = "admm_sparse_kernel(GlobalArgs<T> a, int cap_a, int cap_p) {"
SPARSE_EDITS = {
    "staging": [("    if (done || k >= a.n_iters) break;",
                 "    if (done || k >= 0) break;")],
    "no_b1": [("minv_dot(s_minv + tid * ld, s_rhs, words)", "s_rhs[tid]")],
    "no_b2": [("    for (int i = tid; i < m; i += kThreads) {\n"
               "      T zt = T(0), ax = T(0);",
               "    for (int i = tid; i < 0; i += kThreads) {\n"
               "      T zt = T(0), ax = T(0);")],
    "no_c": [("    stage_c(rd, dn);\n    rp = warp_nan_max(rp);",
              "    rp = warp_nan_max(rp);")],
    "no_test": [("    if (k > 0) {\n      T v0 = T(0)",
                 "    if (k > 0) {\n      it += 1;\n      done = it >= "
                 "a.max_iter;\n    }\n    if (false) {\n      T v0 = T(0)"),
                ("    rp = warp_nan_max(rp);\n    rd = warp_nan_max(rd);\n"
                 "    pn = warp_nan_max(pn);\n    dn = warp_nan_max(dn);\n", "")],
}
SPARSE_EDITS["bare"] = [e for k in ("no_b1", "no_b2", "no_c", "no_test")
                        for e in SPARSE_EDITS[k]]


def edited(src, edits, after=None):
    """src with each (old, new) replaced; `old` must occur once (after the
    text `after`, where given, and only there is it replaced)."""
    head, tail = "", src
    if after is not None:
        if src.count(after) != 1:
            raise RuntimeError(f"marker not found once: {after[:60]!r}")
        cut = src.index(after)
        head, tail = src[:cut], src[cut:]
    for old, new in edits:
        if tail.count(old) != 1:
            raise RuntimeError(f"edit anchor not found once: {old[:60]!r}")
        tail = tail.replace(old, new)
    return head + tail


def main_full(before):
    """The sparse instantiation taken apart on the full QP (`--qp full`)."""
    import torch
    import chip_smoke as cs
    from k6_iterations import build_variants
    from uneven_planner_tpu_torch.kernels import admm
    from uneven_planner_tpu_torch.solver import admm_qp
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    src_path = os.path.join(ROOT, "uneven_planner_tpu_torch/csrc/admm_qp.cu")
    src = open(src_path).read()
    out = os.path.join(os.path.dirname(src_path), "..", "_build", "studies")
    libs = build_variants({"full": src, **{
        k: edited(src, e, after=SPARSE_MARK)
        for k, e in SPARSE_EDITS.items()}}, out)
    runs = [(name, "sparse", lib) for name, lib in libs.items()]
    runs.append(("global", "global", libs["full"]))
    if before:
        runs += [("global_before", "global", lib) for lib in build_variants(
            {"global_before": open(before).read()}, out).values()]
    print(cs.nvidia_smi_line(), flush=True)
    qp, x0, y0, cfg = cs._tick_qps_full("cuda")
    n64 = cs.ADMM_F64_LANES
    kernel = admm.LIBRARY.load()
    try:
        for dtype, q, xw, yw in [
                (torch.float32, qp, x0, y0),
                (torch.float64, tuple(a[:n64].double() for a in qp),
                 x0[:n64].double(), y0[:n64].double())]:
            setup = admm_qp.setup_qp(*q, rho=cfg.qp_rho, sigma=cfg.qp_sigma,
                                     x0=xw, y0=yw)
            d, s = setup.data, setup.state
            nnz = admm.nonzero_counts(d)
            kw = dict(sigma=cfg.qp_sigma, alpha=cfg.qp_alpha, eps_abs=0.0,
                      eps_rel=0.0, max_iter=cfg.qp_max_iter, n_iters=400)
            for name, which, lib in runs:
                admm.LIBRARY._lib = lib
                extra = dict(nnz=nnz) if which == "sparse" else {}
                ms = cs.device_ms(lambda: admm.launch_variant(
                    which, d, s, **extra, **kw), reps=5, inner=2)
                print(json.dumps(dict(
                    variant=name, instantiation=which, lanes=d.P.shape[0],
                    dtype=str(dtype).replace("torch.", ""),
                    qp="full-QP tick pass 1", iterations=400,
                    device_ms=ms)), flush=True)
    finally:
        admm.LIBRARY._lib = kernel


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
    ap = argparse.ArgumentParser()
    ap.add_argument("--qp", choices=("condensed", "full"),
                    default="condensed")
    ap.add_argument("--before", default=None,
                    help="with --qp full: an earlier admm_qp.cu to time "
                    "the global instantiation of")
    args = ap.parse_args()
    if args.qp == "full":
        main_full(args.before)
    else:
        main()
