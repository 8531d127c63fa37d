"""The yardstick's peaks and work counts.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W
limit): 67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s of HBM.
A roofline share is the least time the chip could take (the larger of
operations over the peak rate and bytes over the peak bandwidth) over the
device time measured; each input is counted read once and each output
written once.
"""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def share(flops: float, nbytes: float, device_s: float) -> float | None:
    """Percent of the roofline, or None where nothing was measured."""
    if device_s <= 0 or (flops <= 0 and nbytes <= 0):
        return None
    least = max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)
    return 100.0 * least / device_s


# ---------------------------------------------------------------------------
# K6, the ADMM iterations of the tracking QP
# ---------------------------------------------------------------------------

def tracking_qp_shape(mpc: dict) -> dict:
    """n, m and the nonzeros of P and A of the tracking QP the
    configuration states (mpc.cpp:322-511): condensed to the inputs, or
    with the states as variables.  Horizon H = predict_steps - delay_num."""
    H = mpc["predict_steps"] - mpc["delay_num"]
    box, rate = 2 * H, 2 * H - 2          # rows; a rate row has 2 entries
    if mpc["qp_condense"]:
        n = 2 * H
        return dict(n=n, m=box + rate, nnz_p=n * n, nnz_a=box + 2 * rate)
    # states x_1..x_H as variables: dynamics rows x_{j+1} - A_j x_j - B_j u_j
    # = C_j, with x_{j+1}'s identity, B_j's entries (4 for the Ackermann
    # model, 3 for differential drive) and, from j = 1, A_j's identity and
    # its two heading terms; the input-cost Hessian is a diagonal with the
    # +-2 couplings of the input-rate weights
    b_entries = 4 if mpc["model_type"] == 2 else 3
    dyn = 3 * H + b_entries * H + 5 * (H - 1)
    return dict(n=5 * H, m=box + 3 * H + rate,
                nnz_p=3 * H + 2 * H + 2 * rate,
                nnz_a=box + dyn + 2 * rate)


def k6_work(shape: dict, lane_iterations: float, lane_launches: float):
    """(operations, bytes) of K6 over `lane_iterations` ADMM iterations
    summed over lanes and `lane_launches` lanes' launches (a lane's data
    read once and its state written once a launch).  An iteration is one
    solve with the dense factor and the products with P, A and A'
    (2 (n^2 + nnz(P) + 4 nnz(A)) operations, PERF.md's count from the
    nonzeros); a lane's launch reads the factor, P and A, and q, l, u,
    rho, the two scalings and its start (3n + 7m + 1 words) and writes x,
    z, y and its count, in float32."""
    n, m = shape["n"], shape["m"]
    flops = lane_iterations * 2 * (n * n + shape["nnz_p"]
                                   + 4 * shape["nnz_a"])
    words = (n * n + shape["nnz_p"] + shape["nnz_a"] + 3 * n + 7 * m + 1
             + n + 2 * m + 1)
    return flops, lane_launches * 4 * words
