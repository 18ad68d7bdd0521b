"""K5's launch plan (``repro_torch.quant.opope_q8._plan_grouped``) on the CPU.

The plan picks K5's route (``"sm90"``: K2's TMA ring + int8 wgmma body over
rank-3 per-group tensor maps; ``"tile"``: the 64x64 mma.sync tile body) from
the operands alone, and on the sm90 route the tile configuration. The kernel
runs only on the card (``tests/test_torch_gpu.py``); what is checked here is
what the wrapper hands it: deepseek-moe-16b's expert GEMMs take the sm90
route at every capacity its paths give them, with the 8-row tile at
``m <= 8`` and the 128-row tile above, K is never split, unaligned or
ragged operands take the tile route, more groups than the launch grid holds
raise, the plan is a pure function of its arguments, and the CPU wrapper
runs the plain version without counting a route.

The cases of a test run in a loop inside it rather than as parametrised
items, as in ``tests/test_torch_q8_plan.py``: pytest-xdist's
``--dist loadfile`` queues files by their number of items, largest first,
and a file of fewer items than ``test_serving.py`` queues after it, leaving
the order in which the suite's wall-clock serving test meets its neighbours
as it was.
"""

import importlib

import pytest
import torch

from repro_torch.configs import get_config

q8 = importlib.import_module("repro_torch.quant.opope_q8")

ALIGNED = 1 << 20  # a 16-byte-aligned base address


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # Keep this file's CPU share small beside the suite's wall-clock tests.
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _expert_gemms():
    """(G, K, N) of deepseek-moe-16b's three expert GEMMs under
    ``{"moe": "q8"}``: w_up, w_gate, w_down."""
    cfg = get_config("deepseek-moe-16b")
    g, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert
    return [(g, d, f), (g, d, f), (g, f, d)]


# The expert capacity on the q8 path: a 4-slot decode step (1) and prefills
# of 4 x 64 (30) and 4 x 128 (60) prompt tokens.
PATH_MS = (1, 30, 60)


def _tile_of(m):
    """(config, MT, stages) of the sm90 route at m rows: K2's tile, two
    blocks an SM."""
    return (0, 8, 4) if m <= 8 else (1, 128, 3)


def test_expert_gemms_are_the_models():
    assert _expert_gemms() == [(64, 2048, 1408), (64, 2048, 1408), (64, 1408, 2048)]


def test_expert_shapes_take_the_sm90_route():
    for g, k, n in _expert_gemms():
        for m in PATH_MS:
            plan = q8._plan_grouped(g, m, n, k, ALIGNED, ALIGNED)
            case = (g, m, k, n)
            assert plan.route == "sm90", case
            # 8 rows of A_q up to M = 8, 128 above; 128 weight columns, 128 K
            # bytes a stage.
            assert (plan.config, plan.bm, plan.stages) == _tile_of(m), case
            assert plan.bm == (8 if m == 1 else 128), case
            assert (plan.bn, plan.bk) == (128, 128), case
            assert plan.m_tiles == 1 and plan.n_tiles == -(-n // 128), case
            # G x N tiles fill the card on their own: K is never split.
            assert plan.splits == 1 and plan.k_bounds == (0, k), case
            assert g * plan.tiles in (704, 1024), case


def test_tile_rows_follow_m_and_k_is_never_split():
    """M of 1 to 130 over K tails of 144 and 1040 and N off the 128-column
    tile: one launch, one split, the tiles covering M and N."""
    for m in (1, 5, 8, 9, 64, 65, 130):
        for k, n in ((144, 272), (1040, 208), (400, 144), (16, 16)):
            plan = q8._plan_grouped(3, m, n, k, ALIGNED, ALIGNED)
            case = (m, k, n)
            assert plan.route == "sm90", case
            assert (plan.config, plan.bm, plan.stages) == _tile_of(m), case
            assert plan.m_tiles == -(-m // plan.bm) and plan.n_tiles == -(-n // 128), case
            assert plan.splits == 1 and plan.k_bounds == (0, k), case


def test_the_configs_are_the_kernels():
    """K5's tiles are K2's (config 0 the 8-row tile, 1 the 128-row tile),
    each as two blocks an SM and so with fewer stages than K2's one: 4 for
    the 8-row tile (64 KB of weight in flight a block, 128 KB an SM, as
    K2's 8) and 3 for the 128-row tile."""
    assert q8._GROUPED_STAGES == {8: 4, 128: 3}
    for config, mt, stages in q8._SM90_CONFIGS:
        assert stages > q8._GROUPED_STAGES[mt]
        plan = q8._plan_grouped(64, mt, 1408, 2048, ALIGNED, ALIGNED)
        assert (plan.config, plan.bm, plan.stages) == (config, mt, q8._GROUPED_STAGES[mt])
        assert q8._plan(mt, 1408, 2048, ALIGNED, ALIGNED).config == config


TILE_CASES = [
    (3, 5, 40, 24, ALIGNED, ALIGNED),            # K and N off 16
    (3, 130, 300, 200, ALIGNED, ALIGNED),        # K off 16 (N = 200 is 8 off)
    (3, 64, 1000, 192, ALIGNED, ALIGNED),        # K = 1000: 8 off
    (64, 1, 2048, 1416, ALIGNED, ALIGNED),       # N 8 off
    (64, 1, 2056, 1408, ALIGNED, ALIGNED),       # K 8 off
    (64, 1, 2048, 1408, ALIGNED + 8, ALIGNED),   # A_q's base 8 bytes off
    (64, 1, 2048, 1408, ALIGNED, ALIGNED + 4),   # B_q's base 4 bytes off
    (3, 4, 0, 64, ALIGNED, ALIGNED),             # no K: nothing for TMA to load
]


def test_operands_tma_cannot_describe_take_the_tile_route():
    for g, m, k, n, a_ptr, b_ptr in TILE_CASES:
        plan = q8._plan_grouped(g, m, n, k, a_ptr, b_ptr)
        case = (g, m, k, n, a_ptr % 16, b_ptr % 16)
        assert plan.route == "tile" and plan.config == -1, case
        assert plan.splits == 1 and plan.k_bounds == (0, k), case
        assert (plan.bm, plan.bn, plan.bk) == (64, 64, 32), case
        # The same shape with aligned bases and 16-byte rows goes to sm90.
        if k % 16 == 0 and n % 16 == 0 and k > 0:
            assert q8._plan_grouped(g, m, n, k, ALIGNED, ALIGNED).route == "sm90", case


def test_more_groups_than_the_grid_holds_raise():
    assert q8._MAX_GROUPS == 65535
    assert q8._plan_grouped(65535, 1, 16, 16, ALIGNED, ALIGNED).route == "sm90"
    for a_ptr in (ALIGNED, ALIGNED + 8):  # either route
        with pytest.raises(ValueError, match="groups"):
            q8._plan_grouped(65536, 1, 16, 16, a_ptr, ALIGNED)


def test_plan_is_a_pure_function_of_its_arguments():
    args = [(64, 1, 1408, 2048, ALIGNED, ALIGNED),
            (64, 60, 2048, 1408, ALIGNED, ALIGNED),
            (3, 130, 200, 300, ALIGNED, ALIGNED),
            (64, 5, 1408, 2048, ALIGNED, ALIGNED + 8)]
    first = [q8._plan_grouped(*a) for a in args]
    again = [q8._plan_grouped(*a) for a in reversed(args)][::-1]
    assert first == again
    assert [p.route for p in first] == ["sm90", "sm90", "tile", "tile"]
    assert len({hash(p) for p in first}) == len(first)
    # Only the alignment of the bases matters, not their values, and not G.
    assert q8._plan_grouped(3, 1, 1408, 2048, 16, 32) == first[0]
    # K2's plan of the same shape splits K; K5's never does.
    assert q8._plan(1, 1408, 2048, ALIGNED, ALIGNED).splits > 1
    assert first[0].splits == 1


def test_wrapper_on_cpu_counts_no_route():
    kern = q8.opope_gemm_q8_grouped
    before = (kern.launches, dict(kern.launches_by_route))
    gen = torch.Generator().manual_seed(0)
    a = torch.randint(-127, 128, (3, 4, 64), generator=gen, dtype=torch.int8)
    b = torch.randint(-127, 128, (3, 64, 32), generator=gen, dtype=torch.int8)
    got = kern(a, torch.ones(3, 4, 1), b, torch.ones(3, 1, 32))
    assert (kern.launches, kern.launches_by_route) == before
    assert kern.launches_by_route.keys() == {"sm90", "tile"}
    assert torch.equal(got, torch.bmm(a.int(), b.int()).float())


def test_launching_path_refuses_cpu_tensors():
    a = torch.zeros(3, 4, 64, dtype=torch.int8)
    b = torch.zeros(3, 64, 32, dtype=torch.int8)
    for route in (None, "sm90", "tile"):
        with pytest.raises(ValueError, match="cuda"):
            q8._launch_grouped(a, torch.ones(3, 4, 1), b, torch.ones(3, 1, 32), route=route)
