"""Where the port lies against the JAX package on this host's CPU: the
readings behind the parity tests that measure JAX's own spread
(tests/torch_parity.py:jax_envelope and the copies of
tests/test_torch_bench.py), and planted faults those tests must catch.

    python cpu_studies/parity_margins.py [section ...]

Sections (all by default):
  compacted  the compacted solve's envelope: per lane whose counts move,
             JAX's runs, count groups, groups seen once, the port's share
             and how far its x lies outside the range (negative: inside)
             beside the widening allowed
  stepper    debug_stepper's envelope: JAX's 1-ulp spread of the values
             and where the port's lie (run it again with
             OMP_NUM_THREADS=1 to see JAX move)
  copies     the precision study's and the scene report's numbers of both
             packages over the tests' copies, at copy seeds 0-3
  controls   the two float32 tests with a planted fault in the port each:
             they must fail
  plan_demo  plan_demo's nested solve: JAX's counts at 64 random 1-ulp
             changes of x0 and at x0 (1 + e), the port's at x0

Each test function runs as pytest would run it, with recorders on the
calls whose results are printed; nothing here runs on the card."""

import os
import pathlib
import sys
import tempfile

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

import conftest  # noqa: E402,F401  (the tests' JAX setup: CPU, float64)
import torch  # noqa: E402

import test_torch_bench as tbench  # noqa: E402
import test_torch_examples as texamples  # noqa: E402
import test_torch_pipeline as tpipeline  # noqa: E402
from torch_parity import RUNS_PER_LANE  # noqa: E402


def recorded(mp, module, name, into):
    """Record every result of module.name into `into`."""
    fn = getattr(module, name)

    def call(*a, **k):
        into.append(fn(*a, **k))
        return into[-1]
    mp.setattr(module, name, call)


def run(call, patches=()):
    """call(mp) with a fresh MonkeyPatch `mp`, `patches` applied to it
    first; -> "passed" or the first line of the AssertionError."""
    with pytest.MonkeyPatch.context() as mp:
        for p in patches:
            p(mp)
        try:
            call(mp)
        except AssertionError as e:
            return "FAILED: " + (str(e).strip().splitlines() or [""])[0]
    return "passed"


def captured(module, got):
    """A patch recording the envelope a test builds (got["env"]) and the
    port's side it asserts against it (got["port"]: counts, values,
    floor)."""
    def patch(mp):
        recorded(mp, module, "jax_envelope", got.setdefault("env", []))
        check = module.assert_in_envelope

        def call(env, counts, values, floor=None):
            got.setdefault("port", []).append((counts, values, floor))
            return check(env, counts, values, floor)
        mp.setattr(module, "assert_in_envelope", call)
    return patch


def margins(env, counts, values, floor=None):
    """Per lane: (runs, count groups, groups seen once, {name: Envelope.
    margin}) of the port's counts and values."""
    floor = floor or {}
    out = []
    for b, lane in enumerate(env.rows):
        c = tuple(int(v) for v in counts[b])
        groups = {}
        for cc, _ in lane:
            groups[cc] = groups.get(cc, 0) + 1
        out.append((len(lane), len(groups),
                    sum(1 for n in groups.values() if n == 1),
                    {name: env.margin(b, c, name, got[b], floor.get(name))
                     for name, got in values.items()}))
    return out


def compacted():
    jg = tpipeline.jax_grid()
    grids = (jg, tpipeline.port_grid(jg))
    got = {}
    print("  test:", run(lambda mp: tpipeline.
                         test_compacted_warm_solve_matches_jax_lane_by_lane(
                             grids), [captured(tpipeline, got)]))
    env, (counts, values, _) = got["env"][0], got["port"][0]
    dx = np.abs(values["x"] - env.at_x0("x")).max(1)
    for b, (n, g, once, per) in enumerate(margins(env, counts, values)):
        off, w, m = per["x"] or (np.nan, np.nan, 0)
        tag = f"{RUNS_PER_LANE} more runs" if n > 3 else "stable"
        print(f"  lane {b:2d} ({tag}): {n} runs, {g} count group(s), "
              f"{once} seen once, port's counts in {m}; x outside by "
              f"{off:+.3e}, allowed {w:.3e}; |x - JAX at x0| {dx[b]:.3e}")


def stepper():
    got = {}
    with tempfile.TemporaryDirectory() as tmp:
        print("  test:", run(lambda mp: texamples.
                             test_debug_stepper_csv_matches_jax(
                                 pathlib.Path(tmp)),
                             [captured(texamples, got)]))
    env, (counts, values, floor) = got["env"][0], got["port"][0]
    f_scale = np.abs(env.at_x0("f")).max()
    (n, _, _, per), = margins(env, counts, values, floor)
    print(f"  JAX's 1-ulp spread: values {env.spread(0, 'f') / f_scale:.3e}"
          f" of the largest, iterates {env.spread(0, 'x'):.3e}; the port's "
          f"counts in {per['x'][2]} of {n} runs")
    for name, (off, w, _) in per.items():
        scale = f_scale if name in ("f", "csv_f") else 1.0
        print(f"  {name}: outside by {off / scale:+.3e}, allowed "
              f"{w / scale:.3e}" + (" (of the largest value)"
                                    if scale != 1.0 else ""))


def recorders(rec):
    """A patch recording, per package, the study records and scene reports
    (rec["jax_study"], ...), the pipeline results behind a report
    (rec["jax_lanes"], rec["port_lanes"]) and the port's study solves
    (rec["port_solves"])."""
    def patch(mp):
        from uneven_planner_tpu.bench import precision_study as jps
        from uneven_planner_tpu.bench import scene_eval as jscene
        from uneven_planner_tpu.parallel import pipeline as jpipeline
        from uneven_planner_tpu_torch.parallel import pipeline
        for key, module, name in (
                ("jax_study", jps, "run_study"),
                ("port_study", tbench.precision_study, "run_study"),
                ("jax_scene", jscene, "run_scene"),
                ("port_scene", tbench.scene_eval, "run_scene"),
                ("jax_lanes", jpipeline, "plan_track_batch_chunked"),
                ("port_lanes", pipeline, "plan_track_batch"),
                ("port_solves", tbench.precision_study, "_solve")):
            recorded(mp, module, name, rec.setdefault(key, []))
    return patch


def lane_metrics(rec):
    """Per package: the first pass's per-lane final tracking errors and
    metrics (each package's own max_metrics, as the test computes them)."""
    import jax

    from uneven_planner_tpu.minco import traj as jtraj
    from uneven_planner_tpu.terrain import grid as jgrid
    from uneven_planner_tpu_torch.minco import traj as ttraj
    from uneven_planner_tpu_torch.terrain import grid as tgrid

    out = {}
    grid = jgrid.with_pair_table(tbench.jax_hill_grid(
        tbench._coarse_hill_config(tbench.jscene_config).map,
        dtype=np.float32))
    r = rec["jax_lanes"][0]
    mm = jax.jit(jax.vmap(lambda t: jtraj.max_metrics(
        t, grid, num_samples=1024)))(r.traj)
    out["JAX"] = (np.asarray(r.final_track_err),
                  {k: np.asarray(v) for k, v in mm.items()})
    tg = tgrid.with_pair_table(tbench.make_synthetic_grid(
        tbench._coarse_hill_config(tbench.scene_config).map,
        dtype=np.float32, device="cpu"))
    r = rec["port_lanes"][0]
    out["port"] = (r.final_track_err.numpy(),
                   {k: v.numpy() for k, v in ttraj.max_metrics(
                       r.traj, tg, num_samples=1024).items()})
    return out


def report(rec):
    """The numbers the two float32 tests compare, over the copies."""
    if len(rec.get("port_study", ())) == 2:
        j, p = rec["jax_study"][-1], rec["port_study"][-1]
        for k, lim in (("x_gap_p50", tbench.TOL_STUDY_X_GAP),
                       ("jerk_rel_gap_p50", tbench.TOL_STUDY_JERK_GAP)):
            print(f"    {k}: JAX {j[k]:.4e}, port {p[k]:.4e} (limit "
                  f"{lim:g}), port/JAX {p[k] / j[k]:.3f} (limit "
                  f"{tbench.STUDY_RATIO:g})")
        # the port's float32 and float64 solves of the copies, per lane
        (x32, _), (x64, _) = [(o["x"], jk) for o, jk in
                              rec["port_solves"][-3:-1]]
        gap = np.abs(x32.astype(np.float64) - x64).max(1)
        q = np.percentile(gap, [10, 50, 90])
        print(f"    port's x gap per lane: p10 {q[0]:.3e}, p50 {q[1]:.3e},"
              f" p90 {q[2]:.3e}, max {gap.max():.3e}")
    if rec.get("port_scene"):
        j, p = rec["jax_scene"][-1], rec["port_scene"][-1]
        for k in ("mean_track_err_m", "final_track_err_m"):
            print(f"    {k}: JAX {j[k]!r}, port {p[k]!r}, port/JAX - 1 "
                  f"{p[k] / j[k] - 1:+.4f} (limit "
                  f"{tbench.TOL_SCENE_TRACK_REL:g})")
        for k, bound in tbench.SCENE_METRIC_BOUNDS.items():
            a, b = j["metrics"][k], p["metrics"][k]
            print(f"    {k} (largest of the lanes, not compared): JAX {a!r}"
                  f", port {b!r}, |port - JAX| / bound "
                  f"{abs(b - a) / abs(j['metrics'][bound]):.3e}")
        per = lane_metrics(rec)
        n = tbench.SCENE_COPIES
        for s in (0, 1):
            for name, (err, mm) in per.items():
                e = err[s::2]
                print(f"    scenario {s} {name}: final tracking error per "
                      f"lane {e.mean():.6g}, relative standard deviation "
                      f"{e.std() / e.mean():.4f}")
            for k, key in tbench.SCENE_LANE_KEYS.items():
                bound = abs(j["metrics"][tbench.SCENE_METRIC_BOUNDS[k]])
                a, b = per["JAX"][1][key][s::2], per["port"][1][key][s::2]
                tol = max(tbench.TOL_SCENE_METRIC_OF_BOUND * bound,
                          tbench.SCENE_SIGMAS * a.std() * np.sqrt(2.0 / n))
                print(f"    scenario {s} {k}: lane standard deviation / "
                      f"bound JAX {a.std() / bound:.3e}, port "
                      f"{b.std() / bound:.3e}; |mean port - mean JAX| / "
                      f"bound {abs(b.mean() - a.mean()) / bound:.3e}, "
                      f"allowed {tol / bound:.3e}")


def copies():
    for seed in range(4):
        def reseed(mp, seed=seed):
            copy = tbench._ulp_copies
            mp.setattr(tbench, "_ulp_copies",
                       lambda a, n, s=0: copy(a, n, seed))
        for test in (tbench.test_precision_study_matches_jax,
                     tbench.test_scene_eval_matches_jax_on_a_coarse_hill):
            rec = {}
            print(f"  seed {seed} {test.__name__}:",
                  run(test, [reseed, recorders(rec)]))
            report(rec)


def controls():
    import dataclasses

    from uneven_planner_tpu_torch.bench import precision_study
    from uneven_planner_tpu_torch.sim import rollout

    def loose_f32(factor):
        """The port's float32 solve stops at `factor` x the ALM's
        constraint tolerance (the float64 solve as it is)."""
        def patch(mp):
            solve = precision_study._solve

            def call(x0s, bounds, cfg, shape, device, dtype, overrides):
                if dtype == torch.float32:
                    cfg = dataclasses.replace(cfg, alm=dataclasses.replace(
                        cfg.alm, epsilon_con=cfg.alm.epsilon_con * factor))
                return solve(x0s, bounds, cfg, shape, device, dtype,
                             overrides)
            mp.setattr(precision_study, "_solve", call)
        return patch

    def fast_plant(mp):
        """The port's simulated robot drives 1% faster than commanded."""
        step = rollout.plant_step
        mp.setattr(rollout, "plant_step", lambda s, cmd, *a, **k: step(
            s, cmd * cmd.new_tensor([1.01, 1.0]), *a, **k))

    def loose_scene(mp):
        """The port's scene solves stop at 3 x the ALM's constraint
        tolerance."""
        cfg = tbench.scene_config
        mp.setattr(tbench, "scene_config", lambda name: dataclasses.replace(
            cfg(name), alm=dataclasses.replace(
                cfg(name).alm, epsilon_con=cfg(name).alm.epsilon_con * 3)))
    for name, test, patch in (
            ("float32 solve at 3 x epsilon_con",
             tbench.test_precision_study_matches_jax, loose_f32(3.0)),
            ("float32 solve at 1.5 x epsilon_con",
             tbench.test_precision_study_matches_jax, loose_f32(1.5)),
            ("plant 1% fast",
             tbench.test_scene_eval_matches_jax_on_a_coarse_hill,
             fast_plant),
            ("scene solves at 3 x epsilon_con",
             tbench.test_scene_eval_matches_jax_on_a_coarse_hill,
             loose_scene)):
        rec = {}
        print(f"  {name}: {test.__name__}",
              run(test, [patch, recorders(rec)])[:160])
        report(rec)


def plan_demo(n=64):
    import jax
    import jax.numpy as jnp

    from torch_parity import TEST_CFG, port_grid
    from uneven_planner_tpu import manager as jmanager
    from uneven_planner_tpu.config import scene_config as jscene_config
    from uneven_planner_tpu.frontend import kino_init as jkino
    from uneven_planner_tpu.solver import alm as jalm
    from uneven_planner_tpu.terrain import grid as jgrid
    from uneven_planner_tpu.terrain.synthetic import make_synthetic_grid
    from uneven_planner_tpu_torch.config import scene_config
    from uneven_planner_tpu_torch.examples import plan_demo as demo
    from uneven_planner_tpu_torch.solver import alm as talm

    g = jgrid.with_packed_f16(jgrid.with_pair_table(
        make_synthetic_grid(TEST_CFG, dtype=np.float64)))
    cfg = jscene_config("hill")
    kres = jax.jit(lambda s, e, gr: jkino.plan(gr, cfg.frontend, s, e))(
        jnp.asarray([-3.0, -3.0, 0.0]), jnp.asarray([0.0, -3.0, 0.0]), g)
    shape = (10, 20, 16)
    x0, bound = jmanager.init_guess_fixed_jax(
        kres.path, kres.path_mask, cfg.manager, *shape[:2])
    solve = jax.jit(jax.vmap(lambda x, b: jalm.solve(
        x, b, jalm.ProblemShape(*shape), g, cfg.alm,
        lbfgs_overrides=demo.LBFGS_OVERRIDES), in_axes=(0, None)))
    X = np.asarray(x0)[None]
    xs = X * (1 + np.random.default_rng(0).uniform(-1e-15, 1e-15,
                                                   (n, X.shape[1])))
    r = solve(jnp.asarray(xs), bound)
    seen = sorted(set(zip(np.asarray(r.outer_iters).tolist(),
                          np.asarray(r.inner_iters).tolist())))
    print(f"  JAX at {n} 1-ulp changes of x0: (outer, inner) {seen}")
    for e in (1e-15, -1e-15, 1e-14, -1e-14, 1e-13, 1e-12, 1e-11, 1e-10):
        r = solve(jnp.asarray(X * (1 + e)), bound)
        print(f"  JAX at x0 (1 {e:+.0e}): ({int(r.outer_iters[0])}, "
              f"{int(r.inner_iters[0])})")
    res = talm.solve(
        torch.as_tensor(X), talm.Boundary(*(torch.as_tensor(
            np.array(a))[None] for a in bound)),
        talm.ProblemShape(*shape), port_grid(g), scene_config("hill").alm,
        lbfgs_overrides=demo.LBFGS_OVERRIDES)
    print(f"  port at JAX's x0: ({int(res.outer_iters[0])}, "
          f"{int(res.inner_iters[0])})")


SECTIONS = {"compacted": compacted, "stepper": stepper, "copies": copies,
            "controls": controls, "plan_demo": plan_demo}


def main(argv):
    torch.set_num_threads(1)
    for name in argv or list(SECTIONS):
        print(f"{name}:", flush=True)
        SECTIONS[name]()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
