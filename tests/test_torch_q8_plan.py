"""K2's launch plan (``repro_torch.quant.opope_q8._plan``) on the CPU.

The plan picks K2's route (``"sm90"``: TMA ring + int8 wgmma with the
weight as the register operand, exact int32 split-K; ``"tile"``: the
64x64 mma.sync tile body) from the operands alone, and on the sm90 route the tile
configuration and the K splits. The kernel runs only on the card
(``tests/test_torch_gpu.py``); what is checked here is the arithmetic the
wrapper hands it: every K2 shape on both served models' q8 paths takes the
sm90 route, unaligned or ragged operands take the tile route, the splits
cover K exactly in whole panels with none empty, the decode shapes fill the
card, and the plan is a pure function of its arguments.

The cases of a test run in a loop inside it rather than as parametrised
items: pytest-xdist's ``--dist loadfile`` queues files by their number of
items, largest first, and a file of fewer items than ``test_serving.py``
queues after it, leaving the order in which the suite's wall-clock
serving test meets its neighbours as it was.
"""

import importlib

import pytest
import torch

from repro_torch.configs import get_config

q8 = importlib.import_module("repro_torch.quant.opope_q8")
k1 = importlib.import_module("repro_torch.kernels.opope_gemm")

SMS = k1._SM_COUNT
ALIGNED = 1 << 20  # a 16-byte-aligned base address


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # Keep this file's CPU share small beside the suite's wall-clock tests.
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _q8_shapes(arch):
    """(K, N) of every K2 GEMM on the model's q8 path: chatglm3-6b's MLP
    under ``mlp_q8_policy()``, deepseek-moe-16b's shared experts under
    ``{"moe": "q8"}`` (its routed experts are K5's)."""
    cfg = get_config(arch)
    d_ff = cfg.moe.d_ff_shared if cfg.moe is not None else cfg.d_ff
    return [(cfg.d_model, d_ff), (d_ff, cfg.d_model)]


Q8_SHAPES = [(arch, k, n) for arch in ("chatglm3-6b", "deepseek-moe-16b")
             for k, n in _q8_shapes(arch)]
Q8_MS = (1, 4, 5, 8, 9, 64, 65, 128, 256, 512)
DECODE_MS = (1, 4, 8)


@pytest.mark.parametrize("arch,k,n", Q8_SHAPES, ids=lambda v: str(v))
def test_q8_path_shapes_take_the_sm90_route(arch, k, n):
    for m in Q8_MS:
        plan = q8._plan(m, n, k, ALIGNED, ALIGNED)
        assert plan.route == "sm90", m
        # The 8-row tile up to M = 8, the 128-row tile above.
        config, mt, stages = (0, 8, 8) if m <= 8 else (1, 128, 4)
        assert (plan.config, plan.bm, plan.stages) == (config, mt, stages), m
        assert (plan.bn, plan.bk) == (q8._SM90_BN, q8._SM90_BK) == (128, 128)
        assert plan.m_tiles == -(-m // plan.bm) and plan.n_tiles == -(-n // plan.bn), m


TILE_CASES = [
    (5, 40, 24, ALIGNED, ALIGNED),           # K and N off 16
    (130, 300, 200, ALIGNED, ALIGNED),       # K off 16 (N = 200 is 8 off)
    (64, 1000, 192, ALIGNED, ALIGNED),       # K = 1000: 8 off
    (4, 4096, 13688, ALIGNED, ALIGNED),      # N 8 off: B's row of 13688 bytes
    (4, 4104, 4096, ALIGNED, ALIGNED),       # K 8 off: A's row of 4104 bytes
    (4, 4096, 4096, ALIGNED + 8, ALIGNED),   # A's base 8 bytes off
    (4, 4096, 4096, ALIGNED, ALIGNED + 4),   # B's base 4 bytes off
    (4, 0, 64, ALIGNED, ALIGNED),            # no K: nothing for TMA to load
]


def test_operands_tma_cannot_describe_take_the_tile_route():
    for m, k, n, a_ptr, b_ptr in TILE_CASES:
        plan = q8._plan(m, n, k, a_ptr, b_ptr)
        case = (m, k, n, a_ptr % 16, b_ptr % 16)
        assert plan.route == "tile" and plan.splits == 1 and plan.k_bounds == (0, k), case
        assert (plan.bm, plan.bn, plan.bk) == k1._TILE, case
        # The same shape with aligned bases and 16-byte rows goes to sm90.
        if k % 16 == 0 and n % 16 == 0 and k > 0:
            assert q8._plan(m, n, k, ALIGNED, ALIGNED).route == "sm90", case


SPLIT_NK = ((13696, 4096), (4096, 13696), (2816, 2048), (2048, 2816), (1024, 4096), (16, 16),
            (144, 400), (272, 512), (128, 13696))


@pytest.mark.parametrize("m", (1, 4, 8, 9, 64, 65, 512))
def test_split_bounds_cover_k_in_whole_panels(m):
    for n, k in SPLIT_NK:
        _check_split_bounds(m, n, k)


def _check_split_bounds(m, n, k):
    plan = q8._plan(m, n, k, ALIGNED, ALIGNED)
    assert plan.route == "sm90"
    b = plan.k_bounds
    assert len(b) == plan.splits + 1 and b[0] == 0 and b[-1] == k
    sizes = [hi - lo for lo, hi in zip(b, b[1:])]
    assert all(s > 0 for s in sizes)  # no split is empty
    assert all(x % plan.bk == 0 for x in b[:-1])  # every split starts on a panel
    assert all(s % plan.bk == 0 for s in sizes[:-1])  # only the last holds the ragged tail
    # The kernel's own split arithmetic (csrc/opope_q8.cu) gives the same.
    panels = -(-k // plan.bk)
    per, rem = divmod(panels, plan.splits)
    for s in range(plan.splits):
        p_begin = s * per + min(s, rem)
        p_count = per + (1 if s < rem else 0)
        assert p_count >= 1
        assert b[s] == p_begin * plan.bk
        assert b[s + 1] == min(k, (p_begin + p_count) * plan.bk)
    if plan.splits > 1:
        assert min(sizes[:-1]) >= q8._MIN_SPLIT_PANELS * plan.bk
        assert plan.tiles <= k1._N_COUNTERS  # one split-K counter per tile
        assert plan.tiles * plan.splits <= SMS  # one wave
        # The last block's reduction reads at most one split's main-loop bytes.
        rows = min(m, plan.bm)
        assert plan.splits * rows * plan.bn * 4 <= k / plan.splits * (rows + plan.bn)


@pytest.mark.parametrize("m", DECODE_MS)
def test_decode_shapes_fill_the_card(m):
    """Blocks = tiles x splits: as many as fit one wave of the 132 SMs (one
    block an SM), unless K runs out of panels; at least three quarters of
    the card either way."""
    for arch, k, n in Q8_SHAPES:
        plan = q8._plan(m, n, k, ALIGNED, ALIGNED)
        blocks = plan.tiles * plan.splits
        max_splits = q8._max_splits(m, k, plan.bm)
        assert blocks <= max(SMS, plan.tiles), (arch, k, n)
        assert plan.splits == max_splits or plan.tiles * (plan.splits + 1) > SMS, (arch, k, n)
        assert blocks >= 0.75 * SMS, (arch, k, n)


def test_decode_splits_of_the_served_shapes():
    """The served shapes, and the numbers the kernel's design notes reckon
    with (M = 4)."""
    assert Q8_SHAPES == [("chatglm3-6b", 4096, 13696), ("chatglm3-6b", 13696, 4096),
                         ("deepseek-moe-16b", 2048, 2816), ("deepseek-moe-16b", 2816, 2048)]
    want = {(4096, 13696): (107, 1), (13696, 4096): (32, 4), (2048, 2816): (22, 6),
            (2816, 2048): (16, 8)}
    for (k, n), (tiles, splits) in want.items():
        plan = q8._plan(4, n, k, ALIGNED, ALIGNED)
        assert (plan.tiles, plan.splits) == (tiles, splits), (k, n, plan)


def test_max_splits():
    for m, k, mt, want in [(4, 4096, 8, 16), (4, 13696, 8, 29), (4, 2048, 8, 8),
                           (64, 4096, 128, 4), (512, 4096, 128, 4), (1, 128, 8, 1),
                           (4, 256, 8, 1)]:
        assert q8._max_splits(m, k, mt) == want, (m, k, mt)


def test_plan_is_a_pure_function_of_its_arguments():
    args = [(4, 13696, 4096, ALIGNED, ALIGNED),
            (512, 4096, 13696, ALIGNED, ALIGNED),
            (130, 200, 300, ALIGNED, ALIGNED),
            (5, 2816, 2048, ALIGNED, ALIGNED + 8)]
    first = [q8._plan(*a) for a in args]
    again = [q8._plan(*a) for a in reversed(args)][::-1]
    assert first == again
    assert [p.route for p in first] == ["sm90", "sm90", "tile", "tile"]
    assert len({hash(p) for p in first}) == len(first)
    # Only alignment of the bases matters, not their values.
    assert q8._plan(4, 13696, 4096, 16, 32) == first[0]


def test_wrapper_on_cpu_counts_no_route():
    before = (q8.opope_gemm_q8.launches, dict(q8.opope_gemm_q8.launches_by_route))
    gen = torch.Generator().manual_seed(0)
    a = torch.randint(-127, 128, (4, 64), generator=gen, dtype=torch.int8)
    b = torch.randint(-127, 128, (64, 32), generator=gen, dtype=torch.int8)
    got = q8.opope_gemm_q8(a, torch.ones(4, 1), b, torch.ones(1, 32))
    assert (q8.opope_gemm_q8.launches, q8.opope_gemm_q8.launches_by_route) == before
    assert torch.equal(got, (a.int() @ b.int()).float())


def test_launching_path_refuses_cpu_tensors():
    a = torch.zeros(4, 64, dtype=torch.int8)
    b = torch.zeros(64, 32, dtype=torch.int8)
    for route in (None, "sm90", "tile"):
        with pytest.raises(ValueError, match="cuda"):
            q8._launch(a, torch.ones(4, 1), b, torch.ones(1, 32), route=route)
