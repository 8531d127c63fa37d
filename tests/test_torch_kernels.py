"""The port's CUDA kernels against their plain PyTorch twins on the same
CUDA tensors (fp32).  Needs a card: every test here is marked `cuda` and
skips without one.  Imports no JAX, so it runs where only PyTorch is
installed:

    python -m pytest tests/test_torch_kernels.py -m cuda
"""

import ctypes

import numpy as np
import pytest
import torch

from uneven_planner_tpu_torch.config import MapConfig
from uneven_planner_tpu_torch.kernels import terrain_lookup as kernels
from uneven_planner_tpu_torch.terrain import grid as tgrid
from uneven_planner_tpu_torch.terrain.synthetic import make_synthetic_grid


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """The CPU loops of these tests are thousands of small tensor
    operations, where PyTorch's thread pool only adds hand-off cost (and
    oversubscribes the cores under parallel test workers): run them on one
    thread and put the setting back."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MODES = ["pair", "packed16", "packed16_exact"]


@pytest.fixture(scope="module")
def cuda_grid():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    g = make_synthetic_grid(MapConfig(xy_resolution=0.2, yaw_resolution=0.45),
                            dtype=np.float32, device="cuda")
    return tgrid.with_packed_f16(tgrid.with_pair_table(g))


def _poses(M, seed, device):
    """Interior, edge, yaw-wrap and out-of-map samples."""
    rng = np.random.default_rng(seed)
    px = rng.uniform(-5.3, 5.3, M)
    py = rng.uniform(-5.3, 5.3, M)
    yaw = rng.uniform(-np.pi, np.pi, M)
    py[:64] = -5.0 + rng.uniform(0.0, 0.1, 64)      # iyf < 0 strip
    yaw[64:128] = -np.pi
    return [torch.tensor(a, dtype=torch.float32, device=device)
            for a in (px, py, yaw)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("want_jac", [False, True])
def test_kernel_matches_twin_on_card(cuda_grid, mode, want_jac):
    g = cuda_grid
    px, py, yaw = _poses(8192, 5, g.device)
    geom = tgrid.kernel_geometry(g)
    before = dict(kernels.launches)
    if mode == "pair":
        want = tgrid.pair_tv_jac(g, px, py, yaw, want_jac)
        got = kernels.terrain_tv_pair(g.data_pair, geom, px, py, yaw,
                                      want_jac)
        name = "terrain_tv_pair"
    else:
        exact = mode == "packed16_exact"
        want = tgrid.packed16_tv_jac(g, px, py, yaw, exact, want_jac)
        got = kernels.terrain_tv_packed16(g.data_packed16, geom, px, py, yaw,
                                          exact, want_jac)
        name = "terrain_tv_packed16"
    torch.cuda.synchronize()
    assert kernels.launches[name] == before[name] + 1
    # fp32: both sides round each operation; differences come from the
    # transcendental functions' last bits (tv ~1, J ~1e2)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
    if want_jac:
        torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 255, 5760, 43520, 100003])
@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("want_jac", [False, True])
def test_packed16_kernel_equals_twin_bit_for_bit_on_card(cuda_grid, M, exact,
                                                         want_jac):
    """K1 equals its twin bit for bit in the instantiation its wrapper picks
    and in every other one: both layouts, each with 32- and 64-bit index
    math (the wrapper takes 64 bits only for tables of 2^31 16-byte words
    or more, which no test can hold), at sizes below one wave of the card,
    at sizes that are no multiple of a block, and beyond the quads'
    range."""
    g = cuda_grid
    px, py, yaw = (t[:M].contiguous() for t in _poses(max(M, 256), 9,
                                                       g.device))
    geom = tgrid.kernel_geometry(g)
    want = tgrid.packed16_tv_jac(g, px, py, yaw, exact, want_jac)
    runs = {"picked": lambda: kernels.terrain_tv_packed16(
        g.data_packed16, geom, px, py, yaw, exact, want_jac)}
    for layout in kernels.LAYOUTS:
        for idx32 in (True, False):
            runs[(layout, idx32)] = (
                lambda layout=layout, idx32=idx32: kernels._launch_packed16(
                    g.data_packed16, geom, px, py, yaw, exact, want_jac,
                    layout=layout, idx32=idx32))
    for which, run in runs.items():
        got = run()
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]), which
        if want_jac:
            assert torch.equal(got[1], want[1]), which
        else:
            assert got[1] is None


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 255, 5760, 43520, 100003])
@pytest.mark.parametrize("want_jac", [False, True])
def test_pair_kernel_equals_twin_bit_for_bit_on_card(cuda_grid, M, want_jac):
    """K2 equals its twin bit for bit in the instantiation its wrapper picks
    and in every other one (both layouts, 32- and 64-bit index math), at
    the pipeline's and the planning path's init_scaling sizes, below a
    block and beyond the quads' range."""
    g = cuda_grid
    px, py, yaw = (t[:M].contiguous() for t in _poses(max(M, 256), 11,
                                                       g.device))
    geom = tgrid.kernel_geometry(g)
    want = tgrid.pair_tv_jac(g, px, py, yaw, want_jac)
    runs = {"picked": lambda: kernels.terrain_tv_pair(
        g.data_pair, geom, px, py, yaw, want_jac)}
    for layout in kernels.LAYOUTS:
        for idx32 in (True, False):
            runs[(layout, idx32)] = (
                lambda layout=layout, idx32=idx32: kernels._launch_pair(
                    g.data_pair, geom, px, py, yaw, want_jac, layout=layout,
                    idx32=idx32))
    for which, run in runs.items():
        got = run()
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]), which
        if want_jac:
            assert torch.equal(got[1], want[1]), which
        else:
            assert got[1] is None


@pytest.mark.cuda
def test_autograd_on_card_goes_through_kernel(cuda_grid):
    """Reverse and forward mode on CUDA tensors launch the kernel (once per
    forward) and agree with the twin's J."""
    g = cuda_grid
    px, py, yaw = _poses(4096, 6, g.device)
    ins = [t.clone().requires_grad_(True) for t in (px, py, yaw)]
    before = kernels.launches["terrain_tv_packed16"]
    tv = tgrid.get_terrain_variables_cm(g, *ins, exact=False)
    grads = torch.autograd.grad(tv.sum(), ins)
    assert kernels.launches["terrain_tv_packed16"] == before + 1
    _, jac = tgrid.packed16_tv_jac(g, px, py, yaw, False, True)
    for k in range(3):
        torch.testing.assert_close(grads[k], jac[:, k].sum(0), rtol=1e-4,
                                   atol=1e-3)


@pytest.mark.cuda
def test_launcher_rejects_float64_on_card(cuda_grid):
    """float32 and float64 poses are served (float64 since the kernels took
    it, `test_float64_kernels_equal_twin_bit_for_bit_on_card`); every other
    pose dtype, poses of mixed dtypes and a pair table of another dtype than
    the poses' raise TypeError before any launch."""
    g = cuda_grid
    geom = tgrid.kernel_geometry(g)
    before = dict(kernels.launches)
    for dtype in (torch.float16, torch.bfloat16):
        x = torch.zeros(16, dtype=dtype, device=g.device)
        with pytest.raises(TypeError):
            kernels.terrain_tv_pair(g.data_pair, geom, x, x, x, False)
        with pytest.raises(TypeError):
            kernels.terrain_tv_packed16(g.data_packed16, geom, x, x, x,
                                        False, False)
    x32 = torch.zeros(16, dtype=torch.float32, device=g.device)
    x64 = x32.double()
    with pytest.raises(TypeError):
        kernels.terrain_tv_packed16(g.data_packed16, geom, x64, x32, x64,
                                    False, False)
    with pytest.raises(TypeError):
        kernels.terrain_tv_pair(g.data_pair.half(), geom, x32, x32, x32,
                                False)
    with pytest.raises(TypeError):      # a float32 table under float64 poses
        kernels.terrain_tv_pair(g.data_pair, geom, x64, x64, x64, False)
    assert kernels.launches == before


@pytest.fixture(scope="module")
def cuda_grid64():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    g = make_synthetic_grid(MapConfig(xy_resolution=0.2, yaw_resolution=0.45),
                            dtype=np.float64, device="cuda")
    return tgrid.with_packed_f16(tgrid.with_pair_table(g))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("M", [1, 255, 5760, 43520, 100003])
@pytest.mark.parametrize("want_jac", [False, True])
def test_float64_kernels_equal_twin_bit_for_bit_on_card(cuda_grid64, mode, M,
                                                        want_jac):
    """On a float64 grid, K1 (float64 poses over its f16 table, the blends
    in float64) and K2 (the float64 pair table) equal their twins bit for
    bit in the instantiation the wrapper picks and in every other one:
    both layouts, 32- and 64-bit index math."""
    g = cuda_grid64
    px, py, yaw = (t[:M].double().contiguous()
                   for t in _poses(max(M, 256), 13, g.device))
    geom = tgrid.kernel_geometry(g)
    if mode == "pair":
        want = tgrid.pair_tv_jac(g, px, py, yaw, want_jac)
        runs = {"picked": lambda: kernels.terrain_tv_pair(
            g.data_pair, geom, px, py, yaw, want_jac)}
        launch = lambda **kw: kernels._launch_pair(
            g.data_pair, geom, px, py, yaw, want_jac, **kw)
    else:
        exact = mode == "packed16_exact"
        want = tgrid.packed16_tv_jac(g, px, py, yaw, exact, want_jac)
        runs = {"picked": lambda: kernels.terrain_tv_packed16(
            g.data_packed16, geom, px, py, yaw, exact, want_jac)}
        launch = lambda **kw: kernels._launch_packed16(
            g.data_packed16, geom, px, py, yaw, exact, want_jac, **kw)
    for layout in kernels.LAYOUTS:
        for idx32 in (True, False):
            runs[(layout, idx32)] = (lambda layout=layout, idx32=idx32:
                                     launch(layout=layout, idx32=idx32))
    assert want[0].dtype == torch.float64
    for which, run in runs.items():
        got = run()
        torch.cuda.synchronize()
        assert got[0].dtype == torch.float64, which
        assert torch.equal(got[0], want[0]), which
        if want_jac:
            assert torch.equal(got[1], want[1]), which
        else:
            assert got[1] is None


@pytest.mark.cuda
def test_float64_grid_lookup_and_gradient_go_through_kernels(cuda_grid64):
    """`get_terrain_variables_cm` on a float64 grid launches K1 (exact=False)
    and K2 (exact=True) once a forward, and autograd through them equals
    autograd through the twins' J."""
    g = cuda_grid64
    px, py, yaw = (t.double() for t in _poses(4096, 14, g.device))
    for exact, name in ((False, "terrain_tv_packed16"),
                        (True, "terrain_tv_pair")):
        ins = [t.clone().requires_grad_(True) for t in (px, py, yaw)]
        before = kernels.launches[name]
        tv = tgrid.get_terrain_variables_cm(g, *ins, exact=exact)
        grads = torch.autograd.grad(tv.sum(), ins)
        assert kernels.launches[name] == before + 1
        assert tv.dtype == torch.float64
        _, jac = (tgrid.pair_tv_jac(g, px, py, yaw, True) if exact else
                  tgrid.packed16_tv_jac(g, px, py, yaw, False, True))
        for k in range(3):
            torch.testing.assert_close(grads[k], jac[:, k].sum(0),
                                       rtol=1e-12, atol=1e-12)


def test_packed16_index_width_and_layout_choice():
    """K1's instantiation, decided before the launch: 32-bit index math for
    every table of fewer than 2^31 16-byte words, a quad of lanes per
    sample while a thread per sample would give some SM no block."""
    assert kernels.index_bits(4 * 200 * 200 * 64) == 32      # the hill map
    assert kernels.index_bits(2 ** 31 - 1) == 32
    assert kernels.index_bits(2 ** 31) == 64
    for M in (1, 255, 5760, 132 * 128):
        assert kernels.packed16_layout(M, 132) == "quad"
    for M in (132 * 128 + 1, 43520, 368640, 2621440):
        assert kernels.packed16_layout(M, 132) == "thread"
    assert kernels.packed16_layout(43520, 400) == "quad"


def test_pair_index_width_and_layout_choice():
    """K2's instantiation: 32-bit index math below 2^31 16-byte words (the
    hill's pair table has 5,120,000), a quad of lanes per sample while the
    quads fit in half a wave of 128-thread blocks (2,048 threads an SM), so
    at the pipeline's init_scaling size, a thread per sample from the
    planning step's up."""
    assert kernels.index_bits(2 * 200 * 200 * 64) == 32
    for M in (1, 5760, 21760, 132 * 256):
        assert kernels.pair_layout(M, 132) == "quad"
    for M in (132 * 256 + 1, 43520, 218880, 368640, 1653760):
        assert kernels.pair_layout(M, 132) == "thread"
    assert kernels.pair_layout(43520, 200) == "quad"


def test_index_width_counts_the_table_bytes():
    """The index width is chosen from the table's 16-byte words: a K1 row
    is two whatever the grid's dtype, a K2 row two in float32 and four (64
    bytes) in float64."""
    cells = 200 * 200 * 64
    f16 = torch.empty((2 * cells, 8), dtype=torch.int32, device="meta")
    assert kernels.words16(f16) == 4 * cells
    for dtype, words in ((torch.float32, 2), (torch.float64, 4)):
        pair = torch.empty((cells, 8), dtype=dtype, device="meta")
        assert kernels.words16(pair) == words * cells
    big = torch.empty((2 ** 29, 8), dtype=torch.float64, device="meta")
    assert kernels.index_bits(kernels.words16(big)) == 64
    assert kernels.index_bits(kernels.words16(big.float())) == 32


def test_launchers_refuse_other_dtypes_before_anything_else():
    """A pose dtype the kernels do not take (float16, bfloat16, mixed) is a
    TypeError on any device, before the device check, the build or a
    launch; float32 and float64 on the CPU reach the device check."""
    g = tgrid.with_pair_table(make_synthetic_grid(
        MapConfig(xy_resolution=0.4, yaw_resolution=1.1), dtype=np.float64,
        device="cpu"))
    geom = tgrid.kernel_geometry(g)
    before = dict(kernels.launches)
    for dtype in (torch.float16, torch.bfloat16):
        x = torch.zeros(8, dtype=dtype)
        with pytest.raises(TypeError):
            kernels.terrain_tv_pair(g.data_pair, geom, x, x, x, True)
    with pytest.raises(TypeError):
        kernels.terrain_tv_pair(g.data_pair, geom, torch.zeros(8),
                                torch.zeros(8, dtype=torch.float64),
                                torch.zeros(8), True)
    for dtype in (torch.float32, torch.float64):
        x = torch.zeros(8, dtype=dtype)
        with pytest.raises(ValueError):
            kernels.terrain_tv_pair(g.data_pair, geom, x, x, x, True)
    assert kernels.launches == before


# ---------------------------------------------------------------------------
# K3 gather_rows and K4 gather_along (csrc/gather.cu)
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _indices(rng, n, shape):
    """Random indices with out-of-range and negative ones mixed in."""
    idx = rng.integers(0, n, shape)
    flat = idx.reshape(-1)
    flat[::7] = rng.integers(n, 3 * n, len(flat[::7]))
    flat[3::11] = -rng.integers(1, 2 * n, len(flat[3::11]))
    flat[:4] = [0, n - 1, n, -1]
    return idx


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.uint8,
                                   torch.bool, torch.float64, torch.int64])
@pytest.mark.parametrize("width", [None, 1, 3, 4, 6, 8, 12, 128])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_gather_rows_kernel_matches_twin_on_card(card, dtype, width,
                                                 idx_dtype):
    from uneven_planner_tpu_torch.kernels import gather
    rng = np.random.default_rng(0)
    n, m = 1000, 20001
    shape = (n,) if width is None else (n, width)
    table = torch.tensor(rng.integers(0, 2 if dtype == torch.bool else 200,
                                      shape)).to(dtype).to(card)
    idx = torch.tensor(_indices(rng, n, m)).to(idx_dtype).to(card)
    before = gather.launches["gather_rows"]
    got = gather.gather_rows(table, idx)
    torch.cuda.synchronize()
    assert gather.launches["gather_rows"] == before + 1
    assert torch.equal(got, gather.gather_rows_twin(table, idx))
    # the twin on the CPU says the same
    assert torch.equal(got.cpu(), gather.gather_rows(table.cpu(), idx.cpu()))


# (row bytes, element bytes) of K3's word path: rows of one 4-, 8- and
# 16-byte word and of several words (12-byte Dubins rows, 24-byte rows as
# 8-byte words, the 48-byte split-bf16 and tracking rows, probe B's 512
# bytes, the build's 560)
WORD_ROWS = [(r, e) for r in (4, 8, 12, 16, 24, 32, 48, 512, 560)
             for e in (1, 4, 8) if r % e == 0]
WORD_DTYPES = {1: torch.uint8, 4: torch.int32, 8: torch.int64}


@pytest.mark.cuda
@pytest.mark.parametrize("row_bytes,elem", WORD_ROWS)
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_gather_rows_word_routes_match_twin_on_card(card, row_bytes, elem,
                                                    idx_dtype):
    """Every route of K3's word path equals the twin bit for bit: rows of
    4 to 560 bytes in elements of 1, 4 and 8 bytes, both index types, M
    from 1 to the split-bf16 headline's 737,280, with the table, the index
    and the output each whole or a view one element (row) off 16-byte
    alignment, indices below 0 and at or beyond N, and both offset
    widths.  Each launch adds one to `gather_rows` and one to
    `gather_rows_words`, in the word `rows_word` names."""
    from uneven_planner_tpu_torch.kernels import gather
    rng = np.random.default_rng(row_bytes * 16 + elem)
    n, width = 4099, row_bytes // elem
    dtype = WORD_DTYPES[elem]
    info = torch.iinfo(dtype)
    tbuf = torch.tensor(rng.integers(info.min, info.max, (n + 1, width),
                                     dtype=np.int64, endpoint=True)) \
        .to(dtype).to(card)
    for m in (1, 3, 5, 4 * 10007 + 3, 737280):
        # a launch of 737,280 rows takes several words a thread, fewer rows
        # one word a thread
        ibuf = torch.tensor(_indices(rng, n, m + 1) if m + 1 >= 4
                            else rng.integers(-n, 2 * n, m + 1))
        ibuf = ibuf.to(idx_dtype).to(card)
        obuf = torch.empty((m + 1, width), dtype=dtype, device=card)
        views = [(t, i, o) for t in (0, 1) for i in (0, 1) for o in (0, 1)]
        if m == 737280:
            views = [(0, 0, 0), (1, 1, 1), (0, 1, 1), (0, 0, 1)]
        for t, i, o in views:
            table, idx, out = tbuf[t:t + n], ibuf[i:i + m], obuf[o:o + m]
            want = gather.gather_rows_twin(table, idx)
            word = gather.rows_word(row_bytes, elem, table.data_ptr(),
                                    out.data_ptr())
            name = "gather_rows_words"
            for off32 in ((True, False) if m > 5 else (None,)):
                out.fill_(0)
                before = dict(gather.launches)
                got = gather._launch_rows(table, idx, out, off32=off32)
                torch.cuda.synchronize()
                assert got.data_ptr() == out.data_ptr()
                assert gather.launches["gather_rows"] == \
                    before["gather_rows"] + 1
                assert gather.launches[name] == before[name] + 1
                assert torch.equal(out, want), (m, t, i, o, off32, word)
        # the public wrapper, on its own output
        assert torch.equal(gather.gather_rows(tbuf, ibuf),
                           gather.gather_rows_twin(tbuf, ibuf))


@pytest.mark.cuda
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("length", [0, 1, 3, 5, 4 * 10007 + 3])
@pytest.mark.parametrize("offset", [0, 1])
def test_gather_rows_shared_table_matches_twin_on_card(card, idx_dtype,
                                                       length, offset):
    """The shared-memory path for byte tables (the 40,000-cell occupancy
    table of the search) equals the twin bit for bit: both index types,
    ragged lengths, an index view one element off its 16-byte alignment,
    and indices out of range on both sides."""
    from uneven_planner_tpu_torch.kernels import gather
    rng = np.random.default_rng(length + offset)
    n = 40000
    table = torch.tensor(rng.random(n) < 0.1).to(card)
    assert gather.uses_shared_table(table)
    base = torch.tensor(_indices(rng, n, length + 1) if length + 1 >= 4
                        else rng.integers(-n, 2 * n, length + 1))
    base = base.to(idx_dtype).to(card)
    idx = base[offset:offset + length]
    if length:
        assert idx.data_ptr() % 16 == (offset * idx.element_size()) % 16
    before = gather.launches["gather_rows"]
    got = gather.gather_rows(table, idx)
    torch.cuda.synchronize()
    assert gather.launches["gather_rows"] == before + (1 if length else 0)
    assert got.shape == (length,) and got.dtype == torch.bool
    assert torch.equal(got, gather.gather_rows_twin(table, idx))
    # a uint8 table (with the index view off its alignment, the output
    # after the head is not aligned either: the scalar loop takes it all)
    bytes_ = table.to(torch.uint8) * 7
    assert torch.equal(gather.gather_rows(bytes_, idx),
                       gather.gather_rows_twin(bytes_, idx))


@pytest.mark.cuda
def test_gather_rows_table_over_the_shared_limit_on_card(card):
    """A byte table one byte over the shared-memory limit takes the
    generic kernel, one at the limit the shared-memory one; both equal the
    twin."""
    from uneven_planner_tpu_torch.kernels import gather
    rng = np.random.default_rng(3)
    for n, shared in ((gather.SMEM_TABLE_BYTES + 1, False),
                      (gather.SMEM_TABLE_BYTES, True)):
        table = torch.tensor(rng.integers(0, 256, n)).to(torch.uint8) \
            .to(card)
        assert gather.uses_shared_table(table) == shared
        for idx_dtype in (torch.int32, torch.int64):
            idx = torch.tensor(_indices(rng, n, 100003)).to(idx_dtype) \
                .to(card)
            assert torch.equal(gather.gather_rows(table, idx),
                               gather.gather_rows_twin(table, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.float64,
                                   torch.int64])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_gather_along_kernel_matches_twin_on_card(card, dtype, axis,
                                                  idx_dtype):
    from uneven_planner_tpu_torch.kernels import gather
    rng = np.random.default_rng(1)
    for xs, ishape in (((256, 128), (256, 128)),
                       ((37, 1000), (37, 61) if axis == 1 else (90, 1000))):
        x = torch.tensor(rng.integers(-500, 500, xs)).to(dtype).to(card)
        idx = torch.tensor(_indices(rng, xs[axis], ishape)).to(idx_dtype) \
            .to(card)
        before = gather.launches["gather_along"]
        got = gather.gather_along(x, idx, axis)
        torch.cuda.synchronize()
        assert gather.launches["gather_along"] == before + 1
        assert torch.equal(got, gather.gather_along_twin(x, idx, axis))


_ALONG_KINDS = [(off32, vec) for off32 in (True, False)
                for vec in (True, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("width", [4, 8])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n_arrays", [1, 2, 3, 8])
def test_gather_along_many_matches_twin_on_card(card, width, idx_dtype,
                                                n_arrays):
    """`gather_along_many` equals one twin per array bit for bit, float and
    integer fields mixed (4-byte: float32 and int32; 8-byte: float64 and
    int64), in the instantiation the wrapper picks and in each of the
    others (32- and 64-bit offsets, vector and scalar index paths), on both
    axes, at a shape whose rows are no multiple of the vector width and at
    the search's [B, 8192] by [B, 1024]; `gather_along` is the one-array
    case and counts under its own name."""
    from uneven_planner_tpu_torch.kernels import gather
    rng = np.random.default_rng(width + n_arrays)
    dts = (torch.float32, torch.int32) if width == 4 else (torch.float64,
                                                           torch.int64)
    cases = [((37, 1000), (37, 61), 1), ((1000, 37), (90, 37), 0),
             ((64, 8192), (64, 1024), 1), ((5, 3), (5, 1), 1)]
    for xs_shape, ishape, axis in cases:
        xs = [torch.tensor(rng.normal(size=xs_shape) * 1e3)
              .to(dts[j % 2]).to(card) for j in range(n_arrays)]
        idx = torch.tensor(_indices(rng, xs_shape[axis], ishape)) \
            .to(idx_dtype).to(card)
        want = gather.gather_along_many_twin(xs, idx, axis)
        before = dict(gather.launches)
        got = gather.gather_along_many(xs, idx, axis)
        torch.cuda.synchronize()
        assert gather.launches["gather_along_many"] \
            == before["gather_along_many"] + 1
        assert gather.launches["gather_along"] == before["gather_along"]
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        for off32, vec in _ALONG_KINDS:
            if vec and ishape[1] % gather.ALONG_VEC:
                continue
            got = gather._launch_along(xs, idx, axis, "gather_along_many",
                                       off32=off32, vec=vec)
            torch.cuda.synchronize()
            assert all(torch.equal(g, w) for g, w in zip(got, want)), \
                (xs_shape, off32, vec)
        before = gather.launches["gather_along"]
        one = gather.gather_along(xs[-1], idx, axis)
        assert gather.launches["gather_along"] == before + 1
        assert torch.equal(one, want[-1])


@pytest.mark.cuda
def test_gather_along_many_refuses_mixed_widths_on_card(card):
    from uneven_planner_tpu_torch.kernels import gather
    idx = torch.zeros((4, 4), dtype=torch.int32, device=card)
    f32 = torch.zeros((4, 8), device=card)
    before = dict(gather.launches)
    with pytest.raises(TypeError, match="width"):
        gather.gather_along_many([f32, f32.double()], idx)
    with pytest.raises(TypeError):
        gather.gather_along_many([f32.half(), f32.half()], idx)
    with pytest.raises(ValueError):
        gather.gather_along_many([f32, f32.t().contiguous().t()], idx)
    assert gather.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("B,A,steps", [(256, 163841, 161), (5, 40, 61),
                                       (130, 300, 7), (3, 1, 4)])
def test_walk_parents_matches_twin_on_card(card, B, A, steps):
    """The walk in one launch equals its twin bit for bit on random parent
    forests (roots -1, chains as deep as the arena allows), from random
    nodes, from -1, from a root and from an id beyond the arena."""
    from uneven_planner_tpu_torch.kernels import gather
    rng = np.random.default_rng(B + steps)
    parent = np.full((B, A), -1, np.int32)
    if A > 1:
        # node i's parent is below i or -1; one long chain in lane 0
        parent[:, 1:] = (rng.random((B, A - 1)) * np.arange(1, A)) \
            .astype(np.int32)
        parent[:, 1:][rng.random((B, A - 1)) < 0.05] = -1
        parent[0, 1:] = np.arange(0, A - 1)
    start = rng.integers(0, A, B).astype(np.int32)
    start[0] = A - 1
    start[1:3] = [-1, A + 5][:min(2, B - 1)]
    parent_t, start_t = torch.tensor(parent).to(card), \
        torch.tensor(start).to(card)
    want = gather.walk_parents_twin(parent_t, start_t, steps)
    before = gather.launches["walk_parents"]
    got = gather.walk_parents(parent_t, start_t, steps)
    torch.cuda.synchronize()
    assert gather.launches["walk_parents"] == before + 1
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.int64])
def test_gather_kernels_take_8_byte_elements_at_tracking_shapes_on_card(
        card, dtype):
    """K3 and K4 on 8-byte elements equal their twins bit for bit at the
    shapes the reference sampling gives them in float64 (the piece rows
    [B x pieces, 12] and [B x pieces, 6] by int64, the cumulative piece
    times [B, pieces] by [B, 30]), with a row of odd width (8-byte words)
    and indices at and beyond both edges; on the card, not through the
    twin."""
    from uneven_planner_tpu_torch.kernels import gather
    rng = np.random.default_rng(8)
    for B, pieces, T in ((256, 16, 30), (64, 20, 1024)):
        for width in (12, 6, 3):
            table = torch.tensor(rng.normal(size=(B * pieces, width)) * 1e3) \
                .to(dtype).to(card)
            idx = torch.tensor(_indices(rng, B * pieces, B * T)).to(card)
            before = gather.launches["gather_rows"]
            got = gather.gather_rows(table, idx)
            torch.cuda.synchronize()
            assert gather.launches["gather_rows"] == before + 1
            assert got.dtype == dtype and got.is_cuda
            assert torch.equal(got, gather.gather_rows_twin(table, idx))
        x = torch.tensor(np.cumsum(rng.random((B, pieces)), 1) * 1e3) \
            .to(dtype).to(card)
        idx = torch.tensor(_indices(rng, pieces, (B, T))).to(card)
        before = gather.launches["gather_along"]
        got = gather.gather_along(x, idx)
        torch.cuda.synchronize()
        assert gather.launches["gather_along"] == before + 1
        assert torch.equal(got, gather.gather_along_twin(x, idx))
    # the bits of a NaN and of -0.0 survive the copy
    special = torch.tensor([[float("nan"), -0.0, float("inf")]],
                           dtype=torch.float64, device=card)
    ix = torch.tensor([[2, 1, 0]], device=card)
    got = gather.gather_along(special, ix).view(torch.int64)
    assert torch.equal(got, special.flip(1).view(torch.int64))


@pytest.mark.cuda
def test_gather_kernels_reject_what_they_do_not_take_on_card(card):
    """Element widths neither kernel is compiled for (2 bytes; 1 byte for
    K4), a wrong layout and mixed devices raise."""
    from uneven_planner_tpu_torch.kernels import gather
    x16 = torch.zeros((8, 8), dtype=torch.float16, device=card)
    idx = torch.zeros((8, 2), dtype=torch.int64, device=card)
    with pytest.raises(TypeError):
        gather.gather_along(x16, idx)
    with pytest.raises(TypeError):
        gather.gather_along(x16.bool(), idx)
    with pytest.raises(TypeError):
        gather.gather_rows(x16, idx[:, 0].contiguous())
    x = torch.zeros((8, 8), device=card)
    with pytest.raises(ValueError):
        gather.gather_along(x.t(), idx)                 # not contiguous
    with pytest.raises(ValueError):
        gather.gather_along(x, idx.cpu())               # devices differ


@pytest.mark.cuda
def test_search_on_card_launches_the_gather_kernels(cuda_grid):
    """A small search on the card goes through K1, K3 and K4 and returns
    valid paths."""
    from uneven_planner_tpu_torch.config import FrontendConfig
    from uneven_planner_tpu_torch.frontend import kino_init
    from uneven_planner_tpu_torch.kernels import gather
    import dataclasses
    fe = dataclasses.replace(FrontendConfig(), frontier_size=128,
                             max_rounds=60)
    start = torch.tensor([[-3.0, -3.0, 0.0], [-2.0, -3.0, 1.0]],
                         device=cuda_grid.device)
    goal = torch.tensor([[0.5, -3.0, 0.0], [-2.0, -0.5, 1.5]],
                        device=cuda_grid.device)
    before = dict(gather.launches), kernels.launches["terrain_tv_packed16"]
    res = kino_init.plan(cuda_grid, fe, start, goal)
    assert res.success.all()
    for name in ("gather_rows", "gather_along", "gather_along_many"):
        assert gather.launches[name] > before[0][name], name
    assert gather.launches["walk_parents"] == before[0]["walk_parents"] + 1
    # per round run: the pool by `sel` and by `keep`, the two dedup tables
    # at `cells` (float32: one launch each); after the rounds the arena by
    # the path's ids and by the shot node.  The loop runs until the first
    # poll of the `done` flags after the last scenario's last round
    poll = kino_init.POLL_EVERY
    run = min(fe.max_rounds, -(-int(res.rounds.max()) // poll) * poll)
    assert gather.launches["gather_along_many"] \
        - before[0]["gather_along_many"] == 3 * run + 2
    assert kernels.launches["terrain_tv_packed16"] > before[1]
    for lane in range(2):
        p = kino_init.extract_path(res, lane)
        np.testing.assert_allclose(p[-1], goal[lane].cpu().numpy(),
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# K5 tanh_affine (csrc/elementwise.cu)
# ---------------------------------------------------------------------------

def _ulp_distance(a, b):
    """Distance in units of the last place between two float32 tensors."""
    ia = a.contiguous().view(torch.int32).long()
    ib = b.contiguous().view(torch.int32).long()
    key = lambda i: torch.where(i < 0, -(i & 0x7fffffff), i)
    return (key(ia) - key(ib)).abs()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 512), (1,), (7, 13), (1023,),
                                   (3, 5, 9, 4)])
def test_tanh_affine_kernel_matches_twin_on_card(card, shape):
    from uneven_planner_tpu_torch.kernels import elementwise
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=shape) * 3.0, dtype=torch.float32,
                     device=card)
    x.view(-1)[:1] = 0.0
    before = elementwise.launches["tanh_affine"]
    got = elementwise.tanh_affine(x, 2.0, 1.0)
    torch.cuda.synchronize()
    assert elementwise.launches["tanh_affine"] == before + 1
    want = elementwise.tanh_affine_twin(x, 2.0, 1.0)
    # tanhf and torch.tanh need not round alike: 2 ulp of tanh itself (the
    # affine part cancels near tanh(x) = -1/2, so there the result is held
    # absolutely), and numpy's tanh as the TPU probe holds it
    pure = elementwise.tanh_affine(x, 1.0, 0.0)
    assert int(_ulp_distance(pure, torch.tanh(x)).max()) <= 2
    torch.testing.assert_close(got, want, rtol=0, atol=5e-7)
    np.testing.assert_allclose(got.cpu().numpy(),
                               np.tanh(x.cpu().numpy().astype(np.float64))
                               * 2.0 + 1.0, rtol=0, atol=5e-7)
    # an unaligned view takes the scalar path
    if x.numel() > 4:
        flat = x.reshape(-1)[1:].clone()
        odd = torch.empty(flat.numel() + 1, device=card)[1:]
        odd.copy_(flat)
        torch.testing.assert_close(
            elementwise.tanh_affine(odd, 0.5, -1.0),
            elementwise.tanh_affine_twin(odd, 0.5, -1.0), rtol=0, atol=5e-7)
    with pytest.raises(TypeError):
        elementwise.tanh_affine(x.double())
    if x.dim() == 2:
        with pytest.raises(ValueError):
            elementwise.tanh_affine(x.t())


# ---------------------------------------------------------------------------
# K6 admm_iterations (csrc/admm_qp.cu)
# ---------------------------------------------------------------------------

def _admm_case(B, n, m, seed, device, dtype=torch.float32):
    """Random SPD box QPs with their factorization, unit scalings."""
    from uneven_planner_tpu_torch.kernels import admm
    from uneven_planner_tpu_torch.solver import admm_qp
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(B, n, n))
    P = L @ L.transpose(0, 2, 1) + n * np.eye(n)
    q = rng.normal(size=(B, n)) * 3
    A = rng.normal(size=(B, m, n))
    l = -np.abs(rng.normal(size=(B, m))) - 0.1
    u = np.abs(rng.normal(size=(B, m))) + 0.1
    to = lambda a: torch.tensor(a, dtype=dtype, device=device)
    P, q, A, l, u = map(to, (P, q, A, l, u))
    rho = torch.full((B, m), 0.1, dtype=dtype, device=device)
    M = P + 1e-6 * torch.eye(n, dtype=dtype, device=device) \
        + (A.transpose(1, 2) * rho[:, None, :]) @ A
    ones = lambda *s: torch.ones(s, dtype=dtype, device=device)
    d = admm.ADMMData(P, q, A, l, u, rho,
                      admm_qp._spd_inverse(M).contiguous(),
                      ones(B, n) * 1.25, ones(B, m) * 0.8, ones(B) * 1.5)
    x = torch.zeros((B, n), dtype=dtype, device=device)
    z = torch.zeros((B, m), dtype=dtype, device=device)
    return d, admm.initial_state(x, z, z.clone())


ADMM_KW = dict(sigma=1e-6, alpha=1.6, eps_abs=1e-4, eps_rel=1e-4,
               max_iter=300)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(8, 12), (60, 118), (33, 7), (1, 1),
                                 (100, 198)])
def test_admm_kernel_matches_twin_on_card(card, n, m):
    """x, y within 1e-4 relative of the twin on the same CUDA tensors (the
    two sum in different orders), iteration counts within one, including a
    lane that converges at its first iteration, one that never converges
    and one with a NaN inverse."""
    from uneven_planner_tpu_torch.kernels import admm
    B = 6
    d, s = _admm_case(B, n, m, seed=n + m, device=card)
    # lane 0: unconstrained and started at its optimum -> done at it = 1
    d.l[0], d.u[0] = -1e6, 1e6
    x_opt = torch.linalg.solve(d.P[0].double(), -d.q[0].double()).float()
    s.x[0] = x_opt
    s.z[0] = d.A[0] @ x_opt
    # lane 1: infeasible (l > u on no row, but two rows contradict) ->
    # never converges
    if m >= 2:
        d.A[1, 1] = d.A[1, 0]
        d.l[1, 0], d.u[1, 0] = 1.0, 1.0
        d.l[1, 1], d.u[1, 1] = -1.0, -1.0
    # lane 2: failed factorization
    d.minv[2] = float("nan")
    before = dict(admm.launches)
    got = admm.admm_iterations(d, s, n_iters=400, **ADMM_KW)
    torch.cuda.synchronize()
    # the launch counts, and under its instantiation alone as well
    which = "admm_iterations_" + admm.variant(n, m, torch.float32)
    assert which in ("admm_iterations_fixed", "admm_iterations_runtime")
    for key in admm.launches:
        grew = 1 if key in ("admm_iterations", which) else 0
        assert admm.launches[key] == before[key] + grew, key
    want = admm.admm_iterations_twin(d, s, n_iters=400, **ADMM_KW)
    assert got.done.all() and want.done.all()
    assert int(got.it[0]) == 1 == int(want.it[0])
    assert int(got.it[2]) == 300 and got.x[2].isnan().all()
    if m >= 2:
        assert int(got.it[1]) == 300 == int(want.it[1])
    assert (got.it - want.it).abs().max() <= 1, (got.it, want.it)
    ok = [b for b in range(B) if b not in (1, 2)]
    for a, b in ((got.x, want.x), (got.y, want.y), (got.z, want.z)):
        scale = b[ok].abs().amax(-1, keepdim=True).clamp(min=1.0)
        assert ((a[ok] - b[ok]).abs() / scale).max() < 1e-4
    torch.testing.assert_close(got.r_prim[ok], want.r_prim[ok], rtol=1e-2,
                               atol=1e-5)
    # the inputs are left as they were
    assert int(s.it.max()) == 0 and not s.done.any()


@pytest.mark.cuda
def test_admm_kernel_is_resumable_bit_for_bit_on_card(card):
    from uneven_planner_tpu_torch.kernels import admm
    d, s = _admm_case(16, 60, 118, seed=3, device=card)
    kw = dict(ADMM_KW, eps_abs=1e-7, eps_rel=1e-7, max_iter=2000)
    whole = admm.admm_iterations(d, s, n_iters=400, **kw)
    part = admm.admm_iterations(d, s, n_iters=25, **kw)
    assert int(part.it.max()) == 25
    part = admm.admm_iterations(d, part, n_iters=375, **kw)
    torch.cuda.synchronize()
    for a, b in zip(whole, part):
        assert torch.equal(a, b)
    # n_iters = 0 and a finished state pass through unchanged
    same = admm.admm_iterations(d, whole, n_iters=0, **kw)
    done = whole._replace(done=torch.ones_like(whole.done))
    frozen = admm.admm_iterations(d, done, n_iters=50, **kw)
    for a, b, c in zip(whole, same, frozen[:-1] + (whole.done,)):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,m", [(60, 118), (8, 12), (116, 230),
                                 (150, 208), (150, 268)])
def test_admm_variant_is_chosen_by_shape_and_dtype(n, m, dtype):
    """Which instantiation of K6 serves a QP, decided before any launch:
    float32 QPs that fit in shared memory keep the shared-memory kernels
    (the compiled shape its own), the full tracking QP and every float64 QP
    take the global one."""
    from uneven_planner_tpu_torch.kernels import admm
    f32 = {(60, 118): "fixed", (8, 12): "runtime", (116, 230): "runtime",
           (150, 208): "global", (150, 268): "global"}
    want = f32[(n, m)] if dtype == torch.float32 else "global"
    assert admm.variant(n, m, dtype) == want
    nbytes, resident = admm.global_shared_bytes(n, m, dtype)
    assert resident and 0 < nbytes <= admm.MAX_SHARED_BYTES
    with pytest.raises(TypeError):
        admm.variant(n, m, torch.float16)


def _tick_qp(condense, lanes, dtype, device, seed=0, warm_ticks=2):
    """The first QP of a tracking tick as `mpc_step` assembles it, unscaled,
    and the config (`chip_smoke.tick_qp`)."""
    from chip_smoke import tick_qp
    return tick_qp(condense, lanes, dtype, device, seed, warm_ticks)


def _tick_setup(condense, lanes, dtype, device, seed=0, warm_ticks=2):
    """`setup_qp`'s result on `_tick_qp`'s QP (made contiguous), and the
    config."""
    from uneven_planner_tpu_torch.solver import admm_qp
    qp, cfg = _tick_qp(condense, lanes, dtype, device, seed, warm_ticks)
    return admm_qp.setup_qp(*[a.contiguous() for a in qp], rho=cfg.qp_rho,
                            sigma=cfg.qp_sigma), cfg


@pytest.mark.parametrize("qp,dtype,want", [
    ("full", torch.float32, "sparse"), ("full", torch.float64, "sparse"),
    ("condensed", torch.float32, "fixed"),
    ("condensed", torch.float64, "sparse"),
    ("dense", torch.float32, "global"), ("dense", torch.float64, "global")])
def test_admm_variant_is_chosen_with_the_nonzero_counts(qp, dtype, want):
    """With the lanes' nonzero counts, `variant` serves the full tracking
    QP (A: 531 of 31,200 entries, P: 266 of 22,500, counted on real ticks
    after Ruiz scaling) and the float64 condensed QP (A: 176, P dense) with
    the sparse instantiation, a dense QP of the full QP's shape with the
    global one, and the float32 condensed QP, as before, with the one
    compiled for its shape."""
    from uneven_planner_tpu_torch.kernels import admm
    if qp == "dense":
        d, _ = _admm_case(2, 150, 208, seed=4, device="cpu", dtype=dtype)
        counts = (208 * 150, 150 * 150)
    else:
        setup, _ = _tick_setup(qp == "condensed", 2, dtype, "cpu")
        d = setup.data
        counts = (531, 266) if qp == "full" else (176, 3600)
    assert admm.nonzero_counts(d) == counts
    n, m = d.P.shape[1], d.A.shape[1]
    assert admm.variant(n, m, dtype, admm.nonzero_counts(d)) == want
    # without the counts the shape alone decides, as before
    assert admm.variant(n, m, dtype) in ("fixed", "global")


def test_admm_sparse_shared_bytes_match_hand_counts():
    """The sparse variant's shared memory, reckoned by hand from its
    layout (`admm_sparse_kernel` in csrc/admm_qp.cu): the full tracking QP
    fits twice in an SM's 228 KB in float32 and once in float64; a dense
    lane of that shape does not fit."""
    from uneven_planner_tpu_torch.kernels import admm
    f32, f64 = torch.float32, torch.float64
    # float32, n = 150, m = 208, 531 + 266 entries: Minv at a row stride of
    # 156 (39 16-byte words, odd), 32 words of scratch, rhs at 156, five
    # n-vectors, seven m-vectors, 2 x 531 + 266 values, 511 int starts and
    # 150 column cursors, 1,328 16-bit indices
    assert admm.sparse_shared_bytes(150, 208, 531, 266, f32) == (
        4 * (32 + 150 * 156 + 156 + 5 * 150 + 7 * 208 + 2 * 531 + 266)
        + 4 * (511 + 150) + 2 * 1328) == 113788
    assert 2 * (113788 + 1024) <= 228 * 1024
    # float64: a stride of 150 (75 words)
    assert admm.sparse_shared_bytes(150, 208, 531, 266, f64) == (
        8 * (32 + 150 * 150 + 150 + 5 * 150 + 7 * 208 + 2 * 531 + 266)
        + 4 * (511 + 150) + 2 * 1328) == 215028
    # the condensed QP in float64: n = 60 at a stride of 62 (31 words)
    assert admm.sparse_shared_bytes(60, 118, 176, 3600, f64) == (
        8 * (32 + 60 * 62 + 62 + 5 * 60 + 7 * 118 + 2 * 176 + 3600)
        + 4 * (118 + 120 + 3 + 60) + 2 * (2 * 176 + 3600))
    for dtype in (f32, f64):
        assert admm.sparse_shared_bytes(150, 208, 208 * 150, 150 * 150,
                                        dtype) == 0
    assert admm.sparse_shared_bytes(257, 10, 10, 257, f32) == 0  # n > 256


def test_admm_nonzero_counts_keep_nan_and_skip_signed_zeros():
    """The counts the sparse variant is sized for are the largest over the
    lanes; an entry is skipped only when it is exactly zero (+0 or -0),
    and a NaN entry counts."""
    from uneven_planner_tpu_torch.kernels import admm
    d, _ = _sparse_admm_case(3, 30, 40, seed=1, device="cpu",
                             dtype=torch.float64)
    per_lane = lambda t: (t != 0).sum((1, 2)).tolist()
    assert admm.nonzero_counts(d) == (max(per_lane(d.A)), max(per_lane(d.P)))
    top = int(torch.tensor(per_lane(d.A)).argmax())
    i, j = (d.A[top] == 0).nonzero()[0].tolist()
    A = d.A.clone()
    A[top, i, j] = float("nan")
    assert admm.nonzero_counts(d._replace(A=A))[0] == max(per_lane(d.A)) + 1
    A[top, i, j] = -0.0
    assert admm.nonzero_counts(d._replace(A=A)) == admm.nonzero_counts(d)
    assert admm.nonzero_counts(d._replace(A=A[:0], P=d.P[:0])) == (0, 0)


@pytest.mark.cuda
def test_admm_kernel_rejects_what_it_does_not_take_on_card(card):
    """Mixed dtypes, a wrong layout and a CPU tensor raise; the full
    tracking QP (n = 150, m = 208) and float64 are served, by the global
    variant, and counted."""
    from uneven_planner_tpu_torch.kernels import admm
    d, s = _admm_case(2, 8, 12, seed=0, device=card)
    with pytest.raises(TypeError):
        admm.admm_iterations(
            admm.ADMMData(*[a.double() for a in d]), s, n_iters=1, **ADMM_KW)
    with pytest.raises(ValueError):
        admm.admm_iterations(d._replace(A=d.A.transpose(1, 2)), s, n_iters=1,
                             **ADMM_KW)
    with pytest.raises(ValueError):
        admm.admm_iterations(d, s._replace(x=s.x.cpu()), n_iters=1,
                             **ADMM_KW)
    with pytest.raises(ValueError):   # (8, 12) is not the compiled shape
        admm.launch_variant("fixed", d, s, n_iters=1, **ADMM_KW)
    lib = admm.LIBRARY.load()
    for n, m in ((60, 118), (8, 12), (116, 230), (150, 208), (150, 268)):
        assert int(lib.admm_shared_bytes(n, m)) == admm.shared_bytes(n, m)
        for dtype in (torch.float32, torch.float64):
            res = ctypes.c_int(-1)
            got = int(lib.admm_global_shared_bytes(
                n, m, int(dtype == torch.float64), ctypes.byref(res)))
            assert (got, bool(res.value)) == admm.global_shared_bytes(
                n, m, dtype)
        for dtype in (torch.float32, torch.float64):
            for nnz in ((531, 266), (176, n * n), (m * n, n * n)):
                got = int(lib.admm_sparse_shared_bytes(
                    n, m, *nnz, int(dtype == torch.float64)))
                assert got == admm.sparse_shared_bytes(n, m, *nnz, dtype)
    assert admm.shared_bytes(60, 118) == 61992
    for dtype in (torch.float32, torch.float64):
        big, sb = _admm_case(1, 150, 268, seed=1, device=card, dtype=dtype)
        before = dict(admm.launches)
        out = admm.admm_iterations(big, sb, n_iters=3, **ADMM_KW)
        torch.cuda.synchronize()
        # every K6 launch counts, the global ones also under their own key
        for key in ("admm_iterations", "admm_iterations_global"):
            assert admm.launches[key] == before[key] + 1
        assert int(out.it[0]) == 3 and out.x.dtype == dtype
        assert torch.isfinite(out.x).all()


def _rel(a, b):
    scale = b.abs().amax(-1, keepdim=True).clamp(min=1e-3)
    return float(((a - b).abs() / scale).max())


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,dtype,tol", [
    (150, 268, torch.float32, 5e-5), (150, 208, torch.float32, 5e-5),
    (116, 230, torch.float32, 5e-5), (150, 268, torch.float64, 1e-10),
    (60, 118, torch.float64, 1e-10)])
def test_admm_global_variant_matches_twin_at_a_fixed_count_on_card(
        card, n, m, dtype, tol):
    """The global variant (named directly where another one would serve the
    shape) against the twin over 200 iterations with the termination test
    off: x and y within `tol` of the lane's largest entry (float32: the
    chip smoke's TOL_ADMM_REL; float64: rounding of two summation orders),
    every lane at the same count."""
    from uneven_planner_tpu_torch.kernels import admm
    d, s = _admm_case(4, n, m, seed=n + m, device=card, dtype=dtype)
    kw = dict(ADMM_KW, eps_abs=0.0, eps_rel=0.0, max_iter=1000)
    got = admm.launch_variant("global", d, s, n_iters=200, **kw)
    want = admm.admm_iterations_twin(d, s, n_iters=200, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.it, want.it) and int(got.it.min()) == 200
    assert _rel(got.x, want.x) < tol and _rel(got.y, want.y) < tol
    assert _rel(got.z, want.z) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_admm_global_variant_is_resumable_bit_for_bit_on_card(card, dtype):
    """25 + 375 iterations equal 400 bit for bit in the global variant, and
    it stops where the twin stops on a loose test."""
    from uneven_planner_tpu_torch.kernels import admm
    d, s = _admm_case(8, 150, 268, seed=7, device=card, dtype=dtype)
    kw = dict(ADMM_KW, eps_abs=1e-7, eps_rel=1e-7, max_iter=2000)
    whole = admm.admm_iterations(d, s, n_iters=400, **kw)
    part = admm.admm_iterations(d, s, n_iters=25, **kw)
    part = admm.admm_iterations(d, part, n_iters=375, **kw)
    torch.cuda.synchronize()
    for a, b in zip(whole, part):
        assert torch.equal(a, b)
    got = admm.admm_iterations(d, s, n_iters=400, **ADMM_KW)
    want = admm.admm_iterations_twin(d, s, n_iters=400, **ADMM_KW)
    assert (got.it - want.it).abs().max() <= 1, (got.it, want.it)
    assert _rel(got.x, want.x) < 1e-3


def _sparse_admm_case(B, n, m, seed, device, dtype, density=0.04):
    """Random SPD box QPs with sparse P and A (P = L L' + n I with L
    lower-banded of width 3, A with `density` of its entries) and their
    factorization, unit scalings."""
    from uneven_planner_tpu_torch.kernels import admm
    from uneven_planner_tpu_torch.solver import admm_qp
    rng = np.random.default_rng(seed)
    L = np.tril(np.triu(rng.normal(size=(B, n, n)), -3))
    P = L @ L.transpose(0, 2, 1) + n * np.eye(n)
    A = rng.normal(size=(B, m, n)) * (rng.random((B, m, n)) < density)
    q = rng.normal(size=(B, n)) * 3
    l = -np.abs(rng.normal(size=(B, m))) - 0.1
    u = np.abs(rng.normal(size=(B, m))) + 0.1
    to = lambda a: torch.tensor(a, dtype=dtype, device=device)
    P, q, A, l, u = map(to, (P, q, A, l, u))
    rho = torch.full((B, m), 0.1, dtype=dtype, device=device)
    M = P + 1e-6 * torch.eye(n, dtype=dtype, device=device) \
        + (A.transpose(1, 2) * rho[:, None, :]) @ A
    ones = lambda *s: torch.ones(s, dtype=dtype, device=device)
    d = admm.ADMMData(P, q, A, l, u, rho,
                      admm_qp._spd_inverse(M).contiguous(),
                      ones(B, n) * 1.25, ones(B, m) * 0.8, ones(B) * 1.5)
    z = torch.zeros((B, m), dtype=dtype, device=device)
    return d, admm.initial_state(torch.zeros((B, n), dtype=dtype,
                                             device=device), z, z.clone())


@pytest.mark.cuda
@pytest.mark.parametrize("case,dtype,tol", [
    ("full", torch.float32, 2.5e-4), ("full", torch.float64, 1e-10),
    ("random", torch.float32, 5e-5), ("random", torch.float64, 1e-10),
    ("tall", torch.float32, 5e-5), ("tall", torch.float64, 1e-10)])
def test_admm_sparse_variant_matches_twin_at_a_fixed_count_on_card(
        card, case, dtype, tol):
    """The sparse variant against the twin over 400 iterations with the
    termination test off: on the full QP of a real tick, which `variant`
    gives it (float32 within chip_smoke.py's TOL_ADMM_REL_GLOBAL_F32, the
    floor of float32 sums on that QP), and named on random sparse QPs
    (n = 90, m = 140 at 4% density, which in float32 the run-time
    shared-memory kernel would serve; and m = 300 at 10%, more rows than a
    block has threads and more entries in a row or column than a thread
    keeps in registers; float32 within TOL_ADMM_REL), float64 within the
    rounding of two summation orders; every lane at the same count."""
    from uneven_planner_tpu_torch.kernels import admm
    if case == "full":
        setup, cfg = _tick_setup(False, 8, dtype, card, seed=5)
        d, s = setup.data, setup.state
        n, m = d.P.shape[1], d.A.shape[1]
        assert admm.variant(n, m, dtype, admm.nonzero_counts(d)) == "sparse"
    elif case == "random":
        d, s = _sparse_admm_case(6, 90, 140, seed=11, device=card,
                                 dtype=dtype)
    else:
        d, s = _sparse_admm_case(4, 90, 300, seed=12, device=card,
                                 dtype=dtype, density=0.1)
        per_row = (d.A != 0).sum(-1)
        assert int(per_row.max()) > 4 and int((d.A != 0).sum(1).max()) > 8
    kw = dict(ADMM_KW, eps_abs=0.0, eps_rel=0.0, max_iter=1000)
    before = dict(admm.launches)
    got = admm.launch_variant("sparse", d, s, n_iters=400, **kw)
    want = admm.admm_iterations_twin(d, s, n_iters=400, **kw)
    torch.cuda.synchronize()
    for key in admm.launches:
        grew = key in ("admm_iterations", "admm_iterations_sparse")
        assert admm.launches[key] == before[key] + grew, key
    assert torch.equal(got.it, want.it) and int(got.it.min()) == 400
    assert _rel(got.x, want.x) < tol and _rel(got.y, want.y) < tol
    assert _rel(got.z, want.z) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_admm_sparse_variant_is_resumable_bit_for_bit_on_card(card, dtype):
    """On the full QP of a real tick, 25 + 375 iterations equal 400 bit for
    bit in the sparse variant; n_iters = 0 and a finished lane pass through
    unchanged; it stops within one iteration of the twin on a loose
    test."""
    from uneven_planner_tpu_torch.kernels import admm
    setup, _ = _tick_setup(False, 8, dtype, card, seed=6)
    d, s = setup.data, setup.state
    kw = dict(ADMM_KW, eps_abs=1e-7, eps_rel=1e-7, max_iter=2000)
    whole = admm.launch_variant("sparse", d, s, n_iters=400, **kw)
    part = admm.launch_variant("sparse", d, s, n_iters=25, **kw)
    assert int(part.it.max()) == 25
    part = admm.launch_variant("sparse", d, part, n_iters=375, **kw)
    torch.cuda.synchronize()
    for a, b in zip(whole, part):
        assert torch.equal(a, b)
    same = admm.launch_variant("sparse", d, whole, n_iters=0, **kw)
    done = whole._replace(done=torch.ones_like(whole.done))
    frozen = admm.launch_variant("sparse", d, done, n_iters=50, **kw)
    for a, b, c in zip(whole, same, frozen[:-1] + (whole.done,)):
        assert torch.equal(a, b) and torch.equal(a, c)
    got = admm.launch_variant("sparse", d, s, n_iters=400, **ADMM_KW)
    want = admm.admm_iterations_twin(d, s, n_iters=400, **ADMM_KW)
    assert (got.it - want.it).abs().max() <= 1, (got.it, want.it)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_admm_sparse_variant_returns_nan_for_a_nan_inverse_on_card(card,
                                                                   dtype):
    """A lane whose inverse is NaN runs to its limit and returns NaN in the
    sparse variant: the dense Minv product carries it into every entry of
    x, every row of A with an entry carries it into z and y, and the
    residuals are NaN (a row of A with no entry, which the random QPs have
    and the tracking QPs do not, keeps a finite z and y: nothing multiplies
    x there); the other lanes are untouched by it and match the twin."""
    from uneven_planner_tpu_torch.kernels import admm
    d, s = _sparse_admm_case(4, 40, 70, seed=2, device=card, dtype=dtype)
    d.minv[1] = float("nan")
    got = admm.launch_variant("sparse", d, s, n_iters=400, **ADMM_KW)
    want = admm.admm_iterations_twin(d, s, n_iters=400, **ADMM_KW)
    torch.cuda.synchronize()
    assert int(got.it[1]) == ADMM_KW["max_iter"] and bool(got.done[1])
    assert got.x[1].isnan().all()
    rows = (d.A[1] != 0).any(-1)
    assert rows.any() and not rows.all()
    for t in (got.y, got.z):
        assert t[1][rows].isnan().all() and torch.isfinite(t[1][~rows]).all()
    assert got.r_prim[1].isnan() and got.r_dual[1].isnan()
    ok = [0, 2, 3]
    assert torch.isfinite(got.x[ok]).all()
    assert (got.it[ok] - want.it[ok]).abs().max() <= 1
    assert _rel(got.x[ok], want.x[ok]) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_admm_dense_lane_is_served_by_the_global_variant_on_card(card,
                                                                 dtype):
    """A dense QP of the full QP's shape does not fit compressed: it goes
    to the global variant, and naming the sparse one for it raises."""
    from uneven_planner_tpu_torch.kernels import admm
    d, s = _admm_case(2, 150, 208, seed=9, device=card, dtype=dtype)
    before = dict(admm.launches)
    out = admm.admm_iterations(d, s, n_iters=5, **ADMM_KW)
    torch.cuda.synchronize()
    for key in admm.launches:
        grew = key in ("admm_iterations", "admm_iterations_global")
        assert admm.launches[key] == before[key] + grew, key
    assert int(out.it[0]) == 5
    with pytest.raises(ValueError, match="does not fit"):
        admm.launch_variant("sparse", d, s, n_iters=5, **ADMM_KW)


@pytest.mark.cuda
def test_float64_tracking_on_card_launches_the_gather_kernels(card):
    """A float64 figure-eight rollout on the card (fault F2: the gathers of
    the reference sampling refused 8-byte elements) launches K3 and K4 on
    float64 tables and K6's sparse variant, and stays with the CPU's
    float64 rollout."""
    from uneven_planner_tpu_torch.config import MPCConfig
    from uneven_planner_tpu_torch.kernels import admm, gather
    from uneven_planner_tpu_torch.mpc import traj_msg
    from uneven_planner_tpu_torch.sim import rollout
    s0 = np.zeros((3, 3))
    s0[:, 0] = [0.02, -0.03, 0.04]
    s0[:, 2] = np.pi / 4
    run = lambda dev: rollout.track_trajectory_batched(
        traj_msg.figure_eight(0.5, dtype=torch.float64, device=dev), s0,
        MPCConfig(), 8, device=dev)
    before = dict(gather.launches), dict(admm.launches)
    res = run(card)
    torch.cuda.synchronize()
    for name in ("gather_rows", "gather_along"):
        assert gather.launches[name] > before[0][name]
    passes = int(res.sqp_iters.max(0).values.sum())
    assert admm.launches["admm_iterations_sparse"] \
        - before[1]["admm_iterations_sparse"] == passes
    assert res.states.dtype == torch.float64 and res.states.is_cuda
    torch.set_num_threads(1)
    cpu = run("cpu")
    assert float((res.states.cpu() - cpu.states).abs().max()) < 1e-6
    assert float((res.cmds.cpu() - cpu.cmds).abs().max()) < 1e-5


@pytest.mark.cuda
def test_solve_qp_on_card_goes_through_the_kernel(card):
    """`solve_qp` on CUDA tensors launches K6 (once with a fixed rho, once
    per interval with adaptive rho) and lands on the f64 CPU solution."""
    from uneven_planner_tpu_torch.kernels import admm
    from uneven_planner_tpu_torch.solver import admm_qp
    d, _ = _admm_case(8, 20, 30, seed=5, device=card)
    qp = (d.P, d.q, d.A, d.l, d.u)
    kw = dict(eps_abs=1e-6, eps_rel=1e-6, max_iter=2000, polish=False)
    ref = admm_qp.solve_qp(*[a.double().cpu() for a in qp],
                           adaptive_rho=False, **dict(kw, eps_abs=1e-10,
                                                      eps_rel=1e-10))
    before = admm.launches["admm_iterations"]
    got = admm_qp.solve_qp(*qp, adaptive_rho=False, fixed_iters=400, **kw)
    assert admm.launches["admm_iterations"] == before + 1
    assert (got.x.double().cpu() - ref.x).abs().max() < 1e-3
    stat, prim, comp = admm_qp.kkt_residuals(
        *[a.double().cpu() for a in qp], got.x.double().cpu(),
        got.y.double().cpu())
    assert float(stat.max()) < 1e-3 and float(prim.max()) < 1e-4
    before = admm.launches["admm_iterations"]
    ada = admm_qp.solve_qp(*qp, adaptive_rho=True, adaptive_rho_interval=25,
                           **kw)
    n_launch = admm.launches["admm_iterations"] - before
    assert n_launch >= 1 and n_launch == -(-int(ada.iters.max()) // 25)
    assert (ada.x.double().cpu() - ref.x).abs().max() < 1e-3
    # float64 on the card goes through the kernel too (the sparse variant:
    # the lane fits in shared memory with its 600 + 400 entries)
    before = dict(admm.launches)
    d64 = admm_qp.solve_qp(*[a.double() for a in qp], adaptive_rho=False,
                           **dict(kw, eps_abs=1e-10, eps_rel=1e-10))
    for key in ("admm_iterations", "admm_iterations_sparse"):
        assert admm.launches[key] == before[key] + 1
    assert (d64.x.cpu() - ref.x).abs().max() < 1e-7


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-2),
                                       (torch.float64, 1e-4)])
def test_full_qp_mpc_step_on_card_goes_through_the_kernel(card, dtype, tol):
    """`mpc_step` with the full QP (n = 150, m = 208) on the card, float32
    and float64: one K6 launch per relinearization pass, each the sparse
    variant, commands near the CPU's float64 step (float32: the QP's 1e-6
    test at the float32 floor; float64: summation order moves a count by
    one)."""
    from uneven_planner_tpu_torch.config import MPCConfig
    from uneven_planner_tpu_torch.kernels import admm
    from uneven_planner_tpu_torch.mpc import tracker, traj_msg
    from uneven_planner_tpu_torch.minco.traj import expand_traj
    from uneven_planner_tpu_torch.sim import rollout
    cfg = MPCConfig(qp_condense=False)
    B = 4
    # the reference horizon, sampled once on the CPU in float64, so that
    # both steps get the same references
    f8 = expand_traj(traj_msg.figure_eight(0.5, device="cpu"), B)
    s0 = torch.zeros((B, 3), dtype=torch.float64)
    s0[:, 0] = torch.tensor([0.02, -0.03, 0.0, 0.04])
    s0[:, 2] = np.pi / 4
    s = rollout.roll_init(s0, cfg)
    refs, _ = tracker.get_ref_points(f8, s.t, cfg)
    refs = tracker.smooth_yaw(refs, s.state[:, 2])

    def step(dev, dt):
        to = lambda a: a.to(device=dev, dtype=dt)
        return tracker.mpc_step(to(s.state), to(refs),
                                to(torch.zeros_like(refs[:, :2])),
                                to(s.output), to(s.buff), cfg)

    before = dict(admm.launches)
    got = step(card, dtype)
    torch.cuda.synchronize()
    for key in ("admm_iterations", "admm_iterations_sparse"):
        assert admm.launches[key] - before[key] == int(got.sqp_iters.max())
    want = step("cpu", torch.float64)
    assert got.cmd.dtype == dtype and not got.qp_failed.any()
    assert (got.cmd.double().cpu() - want.cmd).abs().max() < tol


@pytest.mark.cuda
def test_tracking_on_card_launches_the_admm_kernel(card):
    """A short figure-eight rollout on the card goes through K6 (one launch
    per relinearization pass), K3 and K4, and tracks."""
    from uneven_planner_tpu_torch.config import MPCConfig
    from uneven_planner_tpu_torch.kernels import admm, gather
    from uneven_planner_tpu_torch.mpc import traj_msg
    from uneven_planner_tpu_torch.sim import rollout
    f8 = traj_msg.figure_eight(0.5, dtype=torch.float32)
    s0 = np.zeros((4, 3), np.float32)
    s0[:, 0] = [0.02, -0.03, 0.0, 0.04]
    s0[:, 2] = np.pi / 4
    before = admm.launches["admm_iterations"], dict(gather.launches)
    res = rollout.track_trajectory_batched(f8, s0, MPCConfig(), 10)
    passes = int(res.sqp_iters.max(0).values.sum())
    assert admm.launches["admm_iterations"] - before[0] == passes
    assert gather.launches["gather_rows"] > before[1]["gather_rows"]
    assert gather.launches["gather_along"] > before[1]["gather_along"]
    assert res.states.is_cuda and torch.isfinite(res.states).all()
    assert not res.qp_failed.any() and float(res.mean_err.max()) < 0.06


# K3 on the map builder's two reads at a full hill build's shapes: the
# bucket table [60 x 60 x 10, K = 125] int32 by the bucket ids of one
# dispatch's 5 x 5 x 6 windows, and the cloud [M + 1, 4] float32 (16-byte
# rows) by the candidates those windows hold
BUILD_SHAPES = [("bucket rows", (36000, 125), torch.int32, 419 * 150),
                ("cloud rows", (268238, 4), torch.float32, 419 * 2208)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape,dtype,m", BUILD_SHAPES)
def test_gather_rows_at_the_map_builders_shapes_on_card(card, name, shape,
                                                        dtype, m):
    from uneven_planner_tpu_torch.kernels import gather
    rng = np.random.default_rng(9)
    table = torch.tensor(rng.integers(0, shape[0], shape)).to(dtype).to(card)
    idx = torch.tensor(rng.integers(0, shape[0], m), dtype=torch.int32,
                       device=card)
    idx[:2] = torch.tensor([0, shape[0] - 1])
    before = gather.launches["gather_rows"]
    got = gather.gather_rows(table, idx)
    torch.cuda.synchronize()
    assert gather.launches["gather_rows"] == before + 1
    assert torch.equal(got, gather.gather_rows_twin(table, idx))


@pytest.mark.cuda
def test_map_build_on_card_goes_through_k3_and_matches_the_cpu(card):
    """A small build on the card reads through K3 (two launches a dispatch)
    and gives the CPU build's map (float32 both; summation orders differ)."""
    from uneven_planner_tpu_torch.kernels import gather
    from uneven_planner_tpu_torch.terrain import build
    from uneven_planner_tpu_torch.terrain.synthetic import hill_height
    rng = np.random.default_rng(10)
    xy = rng.uniform(-5.5, 5.5, (40000, 2))
    pts = np.concatenate([xy, hill_height(xy[:, 0], xy[:, 1])[:, None]], 1)
    cfg = MapConfig(xy_resolution=0.4, yaw_resolution=0.8)
    before = gather.launches["gather_rows"]
    got = build.construct_map(pts, cfg, chunk=4096)
    torch.cuda.synchronize()
    n = gather.launches["gather_rows"] - before
    assert n > 0 and n % 2 == 0
    want = build.construct_map(pts, cfg, chunk=4096, device="cpu")
    d = (got.data.cpu() - want.data).abs()
    assert got.data.is_cuda and float(d.max()) < 2e-3
    assert float(d.median()) < 1e-6


# ---------------------------------------------------------------------------
# K7 ruiz_equilibrate (csrc/ruiz.cu)
# ---------------------------------------------------------------------------

RUIZ_ITERS = 10
RUIZ_OUT = ("Pb", "qb", "Ab", "lb", "ub", "D", "E", "c")


def _ruiz_rtol(n, dtype):
    """K7 against its twin, relative, on every output: the one place they
    round differently is the mean of P's n column maxima in each cost
    scale g, summed in another order on each side; a sum of n terms >= 0 is
    within (n - 1) u of the exact sum whatever the order (u the unit
    roundoff), so two orders differ by at most 2 n u, and the ten g's, each
    carried into c, P and q and through the column maxima into the next
    iteration's scales, by at most twice that together."""
    return 2 * RUIZ_ITERS * n * torch.finfo(dtype).eps


def _ruiz_gap(got, want):
    """The largest relative gap of got from want over the finite entries
    that are not zero in want; NaN, the infinities and zeros must sit where
    they sit in want."""
    assert torch.equal(got.isnan(), want.isnan())
    ok = ~want.isnan()
    g, w = got[ok], want[ok]
    assert torch.equal(g[w.isinf()], w[w.isinf()])
    assert torch.equal(g == 0, w == 0)
    nz = (w != 0) & w.isfinite()
    if not bool(nz.any()):
        return 0.0
    return float(((g[nz] - w[nz]).abs() / w[nz].abs()).max())


def _ruiz_case(B, n, m, seed, device, dtype, broadcast=False):
    """Random QP data over a wide range of magnitudes (rows and columns
    between 1e-6 and 1e6, so that both clips act), with exact zeros; with
    `broadcast`, P, A, l and u one lane expanded over B, as the tracker's
    constant parts come."""
    rng = np.random.default_rng(seed)
    k = 1 if broadcast else B
    scale = lambda *s: 10.0 ** rng.uniform(-6, 6, s)
    P = rng.normal(size=(k, n, n)) * scale(k, n, 1) * scale(k, 1, n)
    P[rng.random(P.shape) < 0.3] = 0.0
    A = rng.normal(size=(k, m, n)) * scale(k, m, 1) * scale(k, 1, n)
    A[rng.random(A.shape) < 0.3] = 0.0
    l = -np.abs(rng.normal(size=(k, m))) * scale(k, m)
    u = np.abs(rng.normal(size=(k, m))) * scale(k, m)
    l[:, ::5] = -np.inf
    q = rng.normal(size=(B, n)) * scale(B, n)
    to = lambda a: torch.tensor(a, dtype=dtype, device=device)
    P, A, l, u, q = map(to, (P, A, l, u, q))
    if broadcast:
        P, A, l, u = (t.expand((B,) + t.shape[1:]) for t in (P, A, l, u))
    return P, q, A, l, u


F32, F64 = torch.float32, torch.float64


@pytest.mark.parametrize("n,m,dtype,want", [
    (60, 118, F32, "shared"), (60, 118, F64, "shared"),
    (150, 208, F32, "shared"), (150, 208, F64, "global"),
    (150, 224, F32, "shared"), (150, 225, F32, "global"),
    (2, 9681, F32, "shared"), (2, 9682, F32, "global"),
    (2, 4839, F64, "shared"), (2, 4840, F64, "global"),
    (2, 14523, F32, "global"), (2, 14524, F32, None),
    (2, 7259, F64, "global"), (2, 7260, F64, None)])
def test_ruiz_instantiation_is_chosen_by_shape_and_dtype(n, m, dtype, want):
    """Where K7 keeps a lane, decided by shape and dtype before the launch:
    the condensed tracking QP in shared memory in both dtypes, the full one
    in float32 there and in float64 in place in device memory, and each
    shape just inside and just past a limit; the bytes counted by hand from
    the layout (`csrc/ruiz.cu`: P and A from 16-byte boundaries, then
    7 n + 4 m + 4 elements of vectors).  None: not even the vectors fit."""
    from uneven_planner_tpu_torch.kernels import ruiz
    elt = 4 if dtype == F32 else 8
    r16 = lambda b: -(-b // 16) * 16
    mat, vec = r16(elt * n * n) + r16(elt * m * n), elt * (7 * n + 4 * m + 4)
    nbytes, resident = ruiz.shared_bytes(n, m, dtype)
    assert resident == (want == "shared")
    assert nbytes == {"shared": mat + vec, "global": vec, None: 0}[want]
    assert nbytes <= ruiz.MAX_SHARED_BYTES
    if want is None:
        with pytest.raises(ValueError):
            ruiz.instantiation(n, m, dtype)
    else:
        assert ruiz.instantiation(n, m, dtype) == want
    with pytest.raises(TypeError):
        ruiz.instantiation(n, m, torch.float16)
    # the full QP in float32 is the largest tracking lane: one block an SM
    assert ruiz.shared_bytes(150, 208, F32) == (222344, True)
    assert ruiz.shared_bytes(60, 118, F32) == (46304, True)
    assert ruiz.shared_bytes(60, 118, F64) == (92608, True)
    assert ruiz.shared_bytes(150, 208, F64) == (15088, False)


@pytest.mark.parametrize("condense", [True, False])
def test_ruiz_takes_the_twin_on_the_cpu(condense):
    """On CPU tensors `ruiz_equilibrate` is its twin, output for output bit
    for bit, and `setup_qp` equilibrates through it under `up.qp.ruiz`;
    neither touches K7's launch counter."""
    from uneven_planner_tpu_torch.kernels import ruiz
    from uneven_planner_tpu_torch.solver import admm_qp
    qp, cfg = _tick_qp(condense, 3, torch.float64, "cpu")
    before = dict(ruiz.launches)
    got = admm_qp.ruiz_equilibrate(*qp)
    want = admm_qp.ruiz_equilibrate_twin(*qp)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    setup = admm_qp.setup_qp(*qp, rho=cfg.qp_rho, sigma=cfg.qp_sigma)
    assert torch.equal(setup.data.P, want[0])
    assert torch.equal(setup.D, want[5]) and torch.equal(setup.E, want[6])
    assert ruiz.launches == before
    if not torch.cuda.is_available():
        assert all(v == 0 for v in ruiz.launches.values())


def test_ruiz_launcher_refuses_other_devices_before_it_loads_the_kernel():
    """The launcher raises on tensors that are not on a CUDA device before
    it builds or loads anything, and counts nothing."""
    from uneven_planner_tpu_torch.kernels import ruiz
    qp = _ruiz_case(2, 5, 7, seed=0, device="cpu", dtype=torch.float32)
    before = dict(ruiz.launches)
    for dev in ("cpu", "meta"):
        with pytest.raises(ValueError, match="no kernel for device"):
            ruiz.ruiz_equilibrate(*[t.to(dev) for t in qp])
    assert ruiz.launches == before
    assert ruiz.LIBRARY._lib is None or torch.cuda.is_available()


@pytest.fixture(scope="module")
def ruiz_ticks():
    """The first QPs of real ticks at 512 lanes on the card, both forms,
    float32 and float64, as the tracker hands them to `setup_qp`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return {(condense, dtype): _tick_qp(condense, 512, dtype, "cuda")[0]
            for condense in (True, False)
            for dtype in (torch.float32, torch.float64)}


@pytest.mark.cuda
@pytest.mark.parametrize("condense", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ruiz_kernel_matches_twin_on_real_ticks_on_card(ruiz_ticks, condense,
                                                        dtype):
    """K7 against its twin on the same CUDA tensors, the QPs of a real tick
    at 512 lanes: after one iteration D, E, Ab, lb and ub bit for bit (they
    come before any g), Pb, qb and c within `_ruiz_rtol`; after ten every
    output within it.  One launch a call, of the instantiation the shape
    and dtype name."""
    from uneven_planner_tpu_torch.kernels import ruiz
    from uneven_planner_tpu_torch.solver import admm_qp
    qp = ruiz_ticks[(condense, dtype)]
    n, m = qp[1].shape[1], qp[3].shape[1]
    which = "ruiz_equilibrate_" + ruiz.instantiation(n, m, dtype)
    tol = _ruiz_rtol(n, dtype)
    for iters in (1, RUIZ_ITERS):
        before = dict(ruiz.launches)
        got = ruiz.ruiz_equilibrate(*qp, iters=iters)
        torch.cuda.synchronize()
        for key in ruiz.launches:
            grew = 1 if key in ("ruiz_equilibrate", which) else 0
            assert ruiz.launches[key] == before[key] + grew, key
        want = admm_qp.ruiz_equilibrate_twin(*qp, iters=iters)
        for name, a, b in zip(RUIZ_OUT, got, want):
            assert a.shape == b.shape and a.is_contiguous(), name
            if iters == 1 and name in ("D", "E", "Ab", "lb", "ub"):
                assert torch.equal(a, b), name
            else:
                assert _ruiz_gap(a, b) <= tol, (name, _ruiz_gap(a, b), tol)
    if dtype == torch.float32:
        assert which == "ruiz_equilibrate_shared"


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,dtype", [
    (2, 12, torch.float32), (2, 12, torch.float64), (1, 9, torch.float32),
    (2, 12000, torch.float32), (2, 6000, torch.float64)])
@pytest.mark.parametrize("iters", [0, 3, RUIZ_ITERS])
@pytest.mark.parametrize("broadcast", [False, True])
def test_ruiz_kernel_equals_twin_bit_for_bit_where_means_are_exact_on_card(
        n, m, dtype, iters, broadcast):
    """With n <= 2 a mean of n column maxima is the same sum in any order,
    so K7 equals its twin bit for bit on every output, through every
    iteration and both clips, in shared memory and in place in device
    memory ((2, 12000) float32 and (2, 6000) float64 do not fit), with
    inputs broadcast over the lanes or not."""
    from uneven_planner_tpu_torch.kernels import ruiz
    from uneven_planner_tpu_torch.solver import admm_qp
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    qp = _ruiz_case(9, n, m, seed=n + m + iters, device="cuda", dtype=dtype,
                    broadcast=broadcast)
    want_place = "global" if m >= 6000 else "shared"
    assert ruiz.instantiation(n, m, dtype) == want_place
    got = ruiz.ruiz_equilibrate(*qp, iters=iters)
    want = admm_qp.ruiz_equilibrate_twin(*qp, iters=iters)
    torch.cuda.synchronize()
    for name, a, b in zip(RUIZ_OUT, got, want):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(300, 40), (150, 225)])
def test_ruiz_kernel_matches_twin_in_place_on_card(n, m):
    """Shapes off the tracking path in float32 that do not fit in shared
    memory, so run in place in device memory: n = 300 (two chunks of 256
    columns a lane) and (150, 225), one row too many; one iteration bit for
    bit before g, ten within `_ruiz_rtol`."""
    from uneven_planner_tpu_torch.kernels import ruiz
    from uneven_planner_tpu_torch.solver import admm_qp
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dtype = torch.float32
    qp = _ruiz_case(7, n, m, seed=n, device="cuda", dtype=dtype)
    assert ruiz.instantiation(n, m, dtype) == "global"
    for iters in (1, RUIZ_ITERS):
        got = ruiz.ruiz_equilibrate(*qp, iters=iters)
        want = admm_qp.ruiz_equilibrate_twin(*qp, iters=iters)
        torch.cuda.synchronize()
        for name, a, b in zip(RUIZ_OUT, got, want):
            if iters == 1 and name in ("D", "E", "Ab", "lb", "ub"):
                assert torch.equal(a, b), name
            else:
                assert _ruiz_gap(a, b) <= _ruiz_rtol(n, dtype), name


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["P", "A", "q"])
@pytest.mark.parametrize("condense", [True, False])
def test_ruiz_kernel_keeps_a_nan_lane_to_itself_on_card(ruiz_ticks, where,
                                                        condense):
    """A NaN planted in one lane's P, A or q: every output of that lane is
    NaN, as the twin's, and every other lane equals a run without it bit
    for bit."""
    from uneven_planner_tpu_torch.kernels import ruiz
    from uneven_planner_tpu_torch.solver import admm_qp
    qp = [t.contiguous().clone() for t in ruiz_ticks[(condense,
                                                      torch.float32)]]
    clean = ruiz.ruiz_equilibrate(*qp)
    bad = 37
    t = {"P": qp[0], "A": qp[2], "q": qp[1]}[where]
    t[(bad,) + (3,) * (t.dim() - 1)] = float("nan")
    got = ruiz.ruiz_equilibrate(*qp)
    want = admm_qp.ruiz_equilibrate_twin(*qp)
    torch.cuda.synchronize()
    keep = torch.arange(qp[1].shape[0], device="cuda") != bad
    for name, a, b, c in zip(RUIZ_OUT, got, want, clean):
        assert a[bad].isnan().all() and b[bad].isnan().all(), name
        assert torch.equal(a[keep], c[keep]), name


@pytest.mark.cuda
def test_ruiz_kernel_takes_a_batch_of_no_lanes_on_card(ruiz_ticks):
    """No lanes: the twin's empty outputs, and no launch."""
    from uneven_planner_tpu_torch.kernels import ruiz
    from uneven_planner_tpu_torch.solver import admm_qp
    for condense in (True, False):
        qp = [t[:0] for t in ruiz_ticks[(condense, torch.float32)]]
        before = dict(ruiz.launches)
        got = admm_qp.ruiz_equilibrate(*qp)
        want = admm_qp.ruiz_equilibrate_twin(*qp)
        assert ruiz.launches == before
        for a, b in zip(got, want):
            assert a.shape == b.shape and a.dtype == b.dtype and a.is_cuda


@pytest.mark.cuda
def test_ruiz_kernel_rejects_what_it_does_not_take_on_card(ruiz_ticks):
    """Mixed dtypes, a lane that is not row-major and a tensor on another
    device raise before a launch; the library refuses a lane that does not
    fit where it is told to put it."""
    from uneven_planner_tpu_torch.kernels import ruiz
    qp = list(ruiz_ticks[(True, torch.float32)])
    before = dict(ruiz.launches)
    with pytest.raises(TypeError):
        ruiz.ruiz_equilibrate(*qp[:3], qp[3].double(), qp[4])
    with pytest.raises(ValueError):
        ruiz.ruiz_equilibrate(qp[0].contiguous().mT, *qp[1:])
    with pytest.raises(ValueError):
        ruiz.ruiz_equilibrate(qp[0], qp[1], qp[2], qp[3].cpu(), qp[4])
    assert ruiz.launches == before
    lib = ruiz.LIBRARY.load()
    invalid = 1   # cudaErrorInvalidValue
    for n, m, dbl, resident in ((150, 208, 1, 1), (150, 225, 0, 1),
                                (2, 14524, 0, 0), (2, 7260, 1, 0)):
        assert lib.ruiz_equilibrate(*[None] * 5, *[0] * 5, *[None] * 8, 1, n,
                                    m, RUIZ_ITERS, dbl, resident, 1e-4, 1e4,
                                    None) == invalid, (n, m, dbl, resident)


@pytest.mark.cuda
@pytest.mark.parametrize("condense", [True, False])
def test_solve_qp_on_card_equilibrates_with_one_k7_launch(ruiz_ticks,
                                                          condense):
    """`setup_qp` on the card launches K7 once, in shared memory for the
    float32 tracking QPs, and hands K6 the kernel's data."""
    from uneven_planner_tpu_torch.kernels import ruiz
    from uneven_planner_tpu_torch.solver import admm_qp
    qp = ruiz_ticks[(condense, torch.float32)]
    before = dict(ruiz.launches)
    setup = admm_qp.setup_qp(*qp)
    torch.cuda.synchronize()
    assert ruiz.launches["ruiz_equilibrate"] == before["ruiz_equilibrate"] + 1
    assert ruiz.launches["ruiz_equilibrate_shared"] \
        == before["ruiz_equilibrate_shared"] + 1
    want = ruiz.ruiz_equilibrate(*qp)
    assert torch.equal(setup.data.P, want[0])
    assert torch.equal(setup.data.A, want[2])
