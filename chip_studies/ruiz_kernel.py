#!/usr/bin/env python3
"""K7 `ruiz_equilibrate` against its byte bound and its twin, on one GPU.

    python3 chip_studies/ruiz_kernel.py [--out PATH]

On the first QPs of a real tick at LANES lanes (`chip_smoke.tick_qp`: the
figure-eight, starts within 5 cm and 0.1 rad of its start pose, two warm
ticks) of both forms,
condensed (n = 60, m = 118) and full (n = 150, m = 208), as the tracker
hands them to `setup_qp` (the full QP's P and the condensed QP's A, l and u
broadcast over the lanes), in float32 and float64, prints one JSON line a
case: K7's device ms (median of CUDA-graph replays, `chip_smoke.device_ms`,
the L2 warm; and with the 50 MB L2 emptied before every call), K7 with no
iteration (its copy in and its writes alone), the plain twin's device ms,
and the bound: the bytes of every input's storage read once and every
output written once over 3.35 TB/s, beside the same with every lane's P
and A read dense.  Then whether K7 moves K6 (`k6_downstream`), and the
kernel's registers and shared memory from the build log.
"""

import argparse
import json
import os
import sys
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from uneven_planner_tpu_torch.kernels import admm, ruiz  # noqa: E402
from uneven_planner_tpu_torch.solver import admm_qp  # noqa: E402

LANES = 4096   # the fleet cells' batch
SEED = 7


def case(condense, lanes, dtype, dev):
    qp, _ = cs.tick_qp(condense, lanes, dtype, dev, seed=SEED)
    n, m = qp[1].shape[1], qp[3].shape[1]
    out = ruiz.ruiz_equilibrate(*qp)
    nbytes = cs.ruiz_bytes(qp, out)
    dense = cs.ruiz_bytes([t.contiguous() for t in qp], out)
    k7 = cs.device_ms(lambda: ruiz.ruiz_equilibrate(*qp), reps=25, inner=10)
    k7_cold = cs.device_ms_cold(lambda: ruiz.ruiz_equilibrate(*qp), reps=15,
                                inner=4)
    k7_copy = cs.device_ms(lambda: ruiz.ruiz_equilibrate(*qp, iters=0),
                           reps=25, inner=10)
    twin = cs.device_ms(lambda: admm_qp.ruiz_equilibrate_twin(*qp), reps=5,
                        inner=1)
    bound = nbytes / cs.PEAK_BYTES * 1e3
    row = dict(qp="condensed" if condense else "full", n=n, m=m,
               lanes=lanes, dtype=str(dtype).replace("torch.", ""),
               instantiation=ruiz.instantiation(n, m, dtype),
               shared_bytes=ruiz.shared_bytes(n, m, dtype)[0],
               bytes=nbytes, bound_ms=bound,
               dense_bytes=dense, dense_bound_ms=dense / cs.PEAK_BYTES * 1e3,
               k7_ms=k7, k7_cold_ms=k7_cold, k7_no_iteration_ms=k7_copy,
               twin_ms=twin, k7_over_bound=k7 / bound,
               roofline_pct=100.0 * bound / k7)
    print(json.dumps(row), flush=True)
    return row


def k6_downstream(dev):
    """Whether K7's other order of summing a mean moves K6: the QPs of a
    real tick at LANES lanes as `chip_smoke.py`'s K6 phase builds them (the
    condensed QP's first and second relinearisation pass and the full QP's
    first, warm-started as the tracker starts them), set up once with K7
    and once with its twin (`setup_qp` with `ruiz_equilibrate` swapped for
    `ruiz_equilibrate_twin`), and K6 run on both with the tracker's
    settings.  One JSON line a QP: the scaled data's largest relative gap,
    K6's iteration counts lane by lane and the unscaled solutions' gap."""
    cond, cfg = cs._tick_qps(dev, lanes=LANES)
    full, x0, y0, cfg_full = cs._tick_qps_full(dev, lanes=LANES)
    cases = [("condensed " + label, qp, x, y, cfg)
             for label, qp, x, y in cond]
    cases.append(("full tick pass 1 (x warm, y = 0)", full, x0, y0,
                  cfg_full))
    rows = []
    for label, qp, x, y, cfg in cases:
        kw = dict(rho=cfg.qp_rho, sigma=cfg.qp_sigma, x0=x, y0=y)
        with_k7 = admm_qp.setup_qp(*qp, **kw)
        with mock.patch.object(admm_qp, "ruiz_equilibrate",
                               admm_qp.ruiz_equilibrate_twin):
            with_twin = admm_qp.setup_qp(*qp, **kw)
        got, want = (admm.admm_iterations(
            st.data, st.state, n_iters=cfg.qp_scan_iters, sigma=cfg.qp_sigma,
            alpha=cfg.qp_alpha, eps_abs=cfg.qp_abs_tol,
            eps_rel=cfg.qp_rel_tol, max_iter=cfg.qp_max_iter)
            for st in (with_k7, with_twin))
        torch.cuda.synchronize()
        unscaled = lambda st, sol: (st.D * sol.x,
                                    st.data.cinv[:, None] * st.E * sol.y)
        (xa, ya), (xb, yb) = unscaled(with_k7, got), unscaled(with_twin, want)
        flat = lambda t: t.flatten(1)
        its_a, its_b = got.it.long(), want.it.long()
        row = dict(
            check="k6_downstream", qp=label, lanes=LANES,
            n=qp[1].shape[1], m=qp[3].shape[1], budget=cfg.qp_scan_iters,
            data_rel_gap={k: cs._rel(flat(getattr(with_k7.data, k)),
                                     flat(getattr(with_twin.data, k)))
                          for k in ("P", "q", "A", "minv")},
            iters_equal_share=float((its_a == its_b).float().mean()),
            lanes_iters_differ=int((its_a != its_b).sum()),
            iters_max_diff=int((its_a - its_b).abs().max()),
            iters_mean_k7=float(its_a.float().mean()),
            iters_mean_twin=float(its_b.float().mean()),
            at_budget_k7=int((its_a >= cfg.qp_scan_iters).sum()),
            at_budget_twin=int((its_b >= cfg.qp_scan_iters).sum()),
            x_rel_gap=cs._rel(xa, xb), y_rel_gap=cs._rel(ya, yb),
            finite=bool(torch.isfinite(xa).all() and torch.isfinite(xb).all()))
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="JSON file for the rows")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ruiz_kernel: needs a CUDA device")
    dev = torch.device("cuda", 0)
    print("#", cs.nvidia_smi_line(), "| torch", torch.__version__,
          flush=True)
    ruiz.LIBRARY.build()
    rows = [case(condense, LANES, dtype, dev)
            for dtype in (torch.float32, torch.float64)
            for condense in (True, False)]
    rows += k6_downstream(dev)
    for ln in ruiz.LIBRARY.build_log.splitlines():
        if "ruiz_kernel" in ln or "registers" in ln or "spill" in ln:
            print("# ptxas:", ln.strip())
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
