"""`chip_smoke.py`'s phase switch and the shape limits of the port's
kernels, checked without a card (the kernels themselves are held against
their twins on the card by `tests/test_torch_kernels.py`)."""

import importlib.util
import os
import subprocess
import sys

import pytest
import torch

from uneven_planner_tpu_torch.kernels import admm, gather

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_phases_default_is_every_phase():
    cs = _chip_smoke()
    assert cs.parse_phases([]) == list(cs.PHASES)
    assert len(cs.PHASES) == 23 and len(set(cs.PHASES)) == 23
    assert cs.PHASES[-7] == "build"
    assert cs.PHASES[-10:-7] == ("nested-reference", "nested", "packed")
    assert cs.PHASES[-6:-2] == ("dist", "bench-track", "precision",
                                "scene-eval")
    assert cs.PHASES[-2:] == ("oracle", "demo")


@pytest.mark.parametrize("arg,want", [
    ("admm", ["admm"]),
    ("admm,gather", ["gather", "admm"]),          # the script's order
    (" mpc , terrain ,mpc", ["terrain", "mpc"]),
    ("pipeline,small-reference", ["small-reference", "pipeline"]),
    ("mpc-full,track-full-ref,mpc", ["track-full-ref", "mpc", "mpc-full"]),
    ("build,pipeline", ["pipeline", "build"]),
    ("packed,nested,nested-reference",
     ["nested-reference", "nested", "packed"]),
    ("scene-eval,precision,dist,bench-track,terrain",
     ["terrain", "dist", "bench-track", "precision", "scene-eval"]),
    ("demo,oracle,scene-eval", ["scene-eval", "oracle", "demo"]),
    ("demo,admm", ["admm", "demo"])])
def test_phases_subset(arg, want):
    assert _chip_smoke().parse_phases(["--phases", arg]) == want


@pytest.mark.parametrize("arg", ["gathers", "admm,nope", "", ","])
def test_phases_unknown_or_empty_raises(arg):
    with pytest.raises(ValueError, match="phase"):
        _chip_smoke().parse_phases(["--phases", arg])


def test_smoke_without_a_card_prints_no_result(tmp_path):
    """Without CUDA, or alone in a directory, the script exits non-zero and
    prints neither the ok line nor a partial one."""
    if torch.cuda.is_available():
        pytest.skip("checks the run without a card")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    for script, args in ((os.path.join(ROOT, "chip_smoke.py"), []),
                         (str(alone), ["--phases", "admm"])):
        r = subprocess.run([sys.executable, script, *args],
                           capture_output=True, text=True, timeout=120,
                           cwd=tmp_path)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout and '"partial"' not in r.stdout


def _old_shared_bytes(n, m):
    """The layout of the thread-per-output kernel this one replaced: its
    limits are the shapes the card must still take."""
    ld = n | 1
    return 4 * (2 * n * ld + m * ld + 8 * n + 9 * m + 32)


def test_admm_shared_bytes_admits_every_shape_admitted_before():
    admitted = [(n, m) for n in range(1, 151) for m in range(1, 461)
                if _old_shared_bytes(n, m) <= admm.MAX_SHARED_BYTES]
    assert (1, 1) in admitted and (116, 230) in admitted
    refused = [s for s in admitted
               if admm.shared_bytes(*s) > admm.MAX_SHARED_BYTES]
    assert refused == []
    assert admm.shared_bytes(150, 268) > admm.MAX_SHARED_BYTES
    assert admm.shared_bytes(*admm.FIXED_SHAPE) == 61992


def test_gather_rows_route_and_vector_head():
    """Which byte tables go to the shared-memory kernel, and the scalar
    head the wrapper computes for an index view."""
    lim = gather.SMEM_TABLE_BYTES
    b = lambda *s: torch.zeros(s, dtype=torch.bool)
    assert gather.uses_shared_table(b(40000))
    assert gather.uses_shared_table(b(lim)) and gather.uses_shared_table(
        b(lim, 1))
    assert not gather.uses_shared_table(b(lim + 1))
    assert not gather.uses_shared_table(b(100, 2))
    assert not gather.uses_shared_table(torch.zeros(100))
    out = torch.empty(64, dtype=torch.uint8)
    for dtype, per_vec in ((torch.int32, 4), (torch.int64, 2)):
        base = torch.zeros(64, dtype=dtype)
        assert base.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
        assert gather._vector_head(base, out) == 0
        # one element in: the head runs to the next 16 bytes, and the output
        # after it is then misaligned, so every index goes one by one
        view = base[1:]
        assert gather._vector_head(view, out) == view.shape[0]
        assert gather._vector_head(view, out[1:]) == per_vec - 1
        assert gather._vector_head(base[:1], out) == 0


@pytest.mark.parametrize("n,length", [(40000, 0), (40000, 7),
                                      (40000, 4099), (gather.SMEM_TABLE_BYTES
                                                      + 1, 33)])
def test_gather_rows_byte_table_on_cpu_clips(n, length):
    """On the CPU the wrapper is the twin: clipped reads of a byte table."""
    g = torch.Generator().manual_seed(n + length)
    table = torch.rand(n, generator=g) < 0.3
    idx = torch.randint(-n, 2 * n, (length,), generator=g,
                        dtype=torch.int32)
    got = gather.gather_rows(table, idx)
    want = table[idx.long().clamp(0, n - 1)]
    assert torch.equal(got, want)
    assert torch.equal(gather.gather_rows(table, idx.long()), want)


@pytest.mark.parametrize("dtype,rows,along", [
    (torch.float64, True, True), (torch.int64, True, True),
    (torch.float32, True, True), (torch.int32, True, True),
    (torch.bool, True, False), (torch.uint8, True, False),
    (torch.float16, False, False), (torch.int16, False, False)])
def test_gather_element_widths(dtype, rows, along):
    """The element widths each gather kernel is compiled for, checked
    before a launch: K3 1, 4 and 8 bytes, K4 4 and 8 (float64 and int64
    tracking runs on the card); the others raise TypeError."""
    t = torch.zeros(4, dtype=dtype)
    for sizes, ok in ((gather.ROWS_ELEMENT_BYTES, rows),
                      (gather.ALONG_ELEMENT_BYTES, along)):
        if ok:
            gather.check_element_size(t, sizes, "k")
        else:
            with pytest.raises(TypeError, match="bytes"):
                gather.check_element_size(t, sizes, "k")


@pytest.mark.parametrize("elem,row_bytes,align,want", [
    (8, 96, 16, 16),      # float64 piece rows [N, 12]
    (8, 48, 16, 16),      # [N, 6]
    (8, 24, 16, 8),       # [N, 3]: 8-byte words
    (8, 96, 8, 8),        # a view 8 bytes off 16-byte alignment
    (4, 48, 16, 16), (4, 4, 16, 4), (1, 3, 16, 1),
    (4, 24, 16, 8),       # float32 tracking rows [N, 6]: 8-byte words
    (4, 12, 16, 4),       # Dubins' WORD_TYPES rows [6, 3] int32
    (4, 48, 4, 4),        # a view one float off 16-byte alignment
    (1, 4, 16, 4), (1, 2, 16, 1), (1, 8, 4, 4),
    (4, 560, 16, 16),     # the build's bucket rows [N, 140] int32
    (4, 560, 8, 8)])
def test_gather_rows_word_width(elem, row_bytes, align, want):
    """The widest word (16, 8 or 4 bytes) that divides the row and the
    alignment table and output share, else the element's width."""
    assert gather.row_word_bytes(elem, row_bytes, align) == want


@pytest.mark.parametrize("ptrs,want", [
    ((0, 0, 0, 0), 16), ((0, 4, 0, 8), 4), ((48, 0, 16, 32), 16),
    ((24, 0, 0, 0), 8), ((1, 0, 0, 0), 1), ((6, 2, 0, 0), 2)])
def test_gather_rows_alignment(ptrs, want):
    assert gather.alignment(*ptrs) == want


# (row bytes, element bytes, table and output addresses) -> word bytes
@pytest.mark.parametrize("args,want", [
    # e1 C2: rows of one float, aligned or not
    ((4, 4, 0, 0), 4), ((4, 4, 0, 4), 4),
    # the bare grid's corner rows [N, 4] f32 and the build's 16-byte cloud
    # rows: one 16-byte word; the output one float in: four 4-byte words
    ((16, 4, 0, 0), 16), ((16, 4, 0, 4), 4), ((16, 4, 0, 8), 8),
    # 8-byte float64 rows of one word
    ((8, 8, 0, 0), 8), ((8, 8, 8, 0), 8),
    # a byte table wider than the shared-memory one, and byte rows
    ((1, 1, 0, 0), 1), ((4, 1, 0, 0), 4), ((4, 1, 0, 2), 1),
    # rows of several words: e1 C 2 x 16 B, split-bf16 3 x 16 B, tracking
    # [N, 6] f32 3 x 8 B, Dubins 3 x 4 B, float64 [N, 12] 6 x 16 B, probe B
    # 32 x 16 B, the build's buckets 35 x 16 B
    ((32, 4, 0, 0), 16), ((48, 4, 0, 0), 16), ((24, 4, 0, 0), 8),
    ((12, 4, 0, 0), 4), ((12, 4, 0, 4), 4), ((96, 8, 0, 0), 16),
    ((512, 4, 0, 0), 16),
    ((560, 4, 0, 0), 16),
    # a 48-byte table view one row in is 16-byte aligned; one float in, 4
    ((48, 4, 48, 0), 16), ((48, 4, 4, 0), 4),
    # 24-byte rows one row in: 8-byte words either way
    ((24, 8, 24, 24), 8), ((24, 4, 0, 24), 8),
    # 560-byte rows into an output 8 bytes off 16-byte alignment
    ((560, 4, 0, 8), 8)])
def test_gather_rows_route(args, want):
    """K3's route for a table that is not a shared-memory byte table: the
    word path, in the widest word that divides the row and the alignment
    of table and output."""
    row, elem, t, o = args
    word = gather.rows_word(row, elem, t, o)
    assert word == want
    assert word == gather.row_word_bytes(elem, row, gather.alignment(t, o))
    assert row % word == 0 and t % word == 0 and o % word == 0


def test_build_phase_cloud_and_oracle():
    """The build phase's cloud (a triangulated hill, sampled, with trunks)
    and its brute-force oracle, on the CPU at a small size: every sample
    on the lifted surface or on a trunk, and the oracle's fit of a flat
    patch level with sigma 0."""
    import numpy as np
    cs = _chip_smoke()
    from uneven_planner_tpu_torch.config import MapConfig
    from uneven_planner_tpu_torch.terrain.synthetic import hill_height
    verts, faces = cs.hill_cloud_mesh(step=0.4)
    assert faces.max() < len(verts) and faces.shape[1] == 3
    np.testing.assert_allclose(
        verts[:, 2], hill_height(verts[:, 0], verts[:, 1]) + cs.BUILD_LIFT)
    rng = np.random.default_rng(0)
    flat = np.concatenate([rng.uniform(-1, 1, (4000, 2)),
                           np.full((4000, 1), 0.3)], 1)
    fit = cs._reference_fit(np.array([0.1, 0.2, 0.5]), np.zeros(4), flat,
                            MapConfig())
    np.testing.assert_allclose(fit, [0.3, 0.0, 0.0, 0.0], atol=1e-12)
