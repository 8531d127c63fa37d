#!/usr/bin/env python3
"""How far K6's sparse or global instantiation lies from its twin in
float32 on the full tracking QP (n = 150, m = 208), on one GPU: the
readings that `chip_smoke.py`'s TOL_ADMM_REL_GLOBAL_F32 is set from.

    python3 chip_studies/k6_global_tolerance.py [--variant sparse|global]

(default: sparse, the instantiation the full QP takes).

For each case, the first QP pass of a real figure-eight tick at 256 lanes
(`chip_smoke._tick_qps_full`, start states drawn with the seed, after the
warm ticks), over the path's 400-iteration budget with the termination test
off: the kernel against the twin, each against the twin run in float64,
and two lower-precision controls (the twin with P, A and the inverse
rounded to TF32's and bfloat16's mantissa) against the twin
(`chip_smoke.k6_f32_readings`).  Prints the card, one JSON line per
case, and a summary line: the largest kernel-vs-twin distance and the
smallest distance of each control.  A sound limit lies between the two.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SEEDS = (31, 32, 33, 34)
WARM_TICKS = (4, 12, 24, 40)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--variant", choices=("sparse", "global"),
                   default="sparse")
    which = p.parse_args().variant
    import torch
    import chip_smoke as cs
    from uneven_planner_tpu_torch.solver import admm_qp
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    print(cs.nvidia_smi_line(), flush=True)
    rows = []
    for seed in SEEDS:
        for warm in WARM_TICKS:
            qp, x0, y0, cfg = cs._tick_qps_full("cuda", warm_ticks=warm,
                                                seed=seed)
            setup = admm_qp.setup_qp(*qp, rho=cfg.qp_rho, sigma=cfg.qp_sigma,
                                     x0=x0, y0=y0)
            kw = dict(sigma=cfg.qp_sigma, alpha=cfg.qp_alpha, eps_abs=0.0,
                      eps_rel=0.0, max_iter=cfg.qp_max_iter)
            r = cs.k6_f32_readings(setup.data, setup.state,
                                   cfg.qp_scan_iters, kw, which)
            r = dict(variant=which, seed=seed, warm_ticks=warm,
                     lanes=int(x0.shape[0]),
                     kernel_vs_twin=max(r["max_rel_err_x"],
                                        r["max_rel_err_y"]), **r)
            print(json.dumps(r), flush=True)
            rows.append(r)
    print(json.dumps(dict(
        summary=True, variant=which, cases=len(rows),
        max_kernel_vs_twin=max(r["kernel_vs_twin"] for r in rows),
        max_twin_vs_f64=max(max(r["twin_vs_f64_rel_x"],
                                r["twin_vs_f64_rel_y"]) for r in rows),
        max_kernel_vs_f64=max(max(r["kernel_vs_f64_rel_x"],
                                  r["kernel_vs_f64_rel_y"]) for r in rows),
        min_tf32_control=min(r["tf32_control_rel"] for r in rows),
        min_bf16_control=min(r["bf16_control_rel"] for r in rows),
        iters_differ=sum(r["iters_differ"] for r in rows))), flush=True)


if __name__ == "__main__":
    main()
