"""K1's launch plan (``repro_torch.kernels.opope_gemm._plan``) on the CPU.

The plan picks the route (``"sm90"``: TMA + wgmma, split-K; ``"tile"``: the
64x64 tile body) from the operands alone, and on the sm90 route the tile
configuration and the K splits. The kernel runs only on the card
(``tests/test_torch_gpu.py``); what is checked here is the arithmetic the
wrapper hands it: every main-path shape of both served models takes the
sm90 route, fp32 and operands TMA cannot describe take the tile route, the
splits cover K exactly in whole panels with none empty, the decode shapes
fill the card, and the plan is a pure function of its arguments.
"""

import importlib

import pytest
import torch

from repro_torch.configs import get_config

k1 = importlib.import_module("repro_torch.kernels.opope_gemm")

SMS = k1._SM_COUNT
ALIGNED = 1 << 20  # a 16-byte-aligned base address


def _model_shapes(arch):
    """(K, N) of every K1 GEMM on the model's serving path."""
    cfg = get_config(arch)
    d, dq, dkv = cfg.d_model, cfg.n_heads * cfg.head_dim_, cfg.n_kv * cfg.head_dim_
    shapes = {(d, dq), (d, dkv), (dq, d)}
    if cfg.moe is not None:
        shapes |= {(d, cfg.moe.n_experts), (d, cfg.moe.d_ff_shared), (cfg.moe.d_ff_shared, d)}
    else:
        shapes |= {(d, cfg.d_ff), (cfg.d_ff, d)}
    return sorted(shapes)


MAIN_SHAPES = [(arch, k, n) for arch in ("chatglm3-6b", "deepseek-moe-16b")
               for k, n in _model_shapes(arch)]
MAIN_MS = (1, 4, 64, 65, 256, 512)
DECODE_MS = (1, 4, 64)


def test_main_path_shapes_are_the_models():
    assert ("chatglm3-6b", 4096, 13696) in MAIN_SHAPES
    assert ("chatglm3-6b", 4096, 256) in MAIN_SHAPES
    assert ("deepseek-moe-16b", 2048, 64) in MAIN_SHAPES
    assert ("deepseek-moe-16b", 2816, 2048) in MAIN_SHAPES
    assert len(MAIN_SHAPES) == 8  # deepseek's q, k, v and o are all 2048 x 2048


@pytest.mark.parametrize("m", MAIN_MS)
@pytest.mark.parametrize("arch,k,n", MAIN_SHAPES, ids=lambda v: str(v))
def test_main_path_shapes_take_the_sm90_route(arch, k, n, m):
    plan = k1._plan(m, n, k, torch.bfloat16, ALIGNED, ALIGNED)
    assert plan.route == "sm90"
    assert plan.config == (0 if m <= 64 else 1)
    assert (plan.bm, plan.bn, plan.bk) == ((64, 128, 64) if m <= 64 else (128, 128, 64))
    assert plan.m_tiles == -(-m // plan.bm) and plan.n_tiles == -(-n // plan.bn)


@pytest.mark.parametrize("m,k,n", [(4, 4096, 4096), (512, 4096, 13696), (5, 40, 24), (1, 8, 8)])
def test_fp32_takes_the_tile_route(m, k, n):
    plan = k1._plan(m, n, k, torch.float32, ALIGNED, ALIGNED)
    assert plan.route == "tile" and plan.splits == 1
    assert (plan.bm, plan.bn, plan.bk) == k1._TILE
    assert plan.k_bounds == (0, k)


@pytest.mark.parametrize("m,k,n,a_ptr,b_ptr", [
    (130, 300, 200, ALIGNED, ALIGNED),      # A's row of 600 bytes
    (4, 4096, 100, ALIGNED, ALIGNED),       # B's row of 200 bytes
    (4, 4096, 4096, ALIGNED + 8, ALIGNED),  # A's base 8 bytes off
    (4, 4096, 4096, ALIGNED, ALIGNED + 2),  # B's base 2 bytes off
    (4, 0, 64, ALIGNED, ALIGNED),           # no K: nothing for TMA to load
], ids=["a_stride", "b_stride", "a_base", "b_base", "k0"])
def test_operands_tma_cannot_describe_take_the_tile_route(m, k, n, a_ptr, b_ptr):
    assert k1._plan(m, n, k, torch.bfloat16, a_ptr, b_ptr).route == "tile"
    # The same shape with aligned bases and 8-element rows goes to sm90.
    if k % 8 == 0 and n % 8 == 0 and k > 0:
        assert k1._plan(m, n, k, torch.bfloat16, ALIGNED, ALIGNED).route == "sm90"


SPLIT_CASES = [(m, n, k) for m in (1, 4, 64, 65, 512)
               for n, k in ((256, 4096), (4096, 13696), (64, 2048), (24, 40), (200, 520),
                            (136, 264), (2048, 2816), (13696, 4096))]


@pytest.mark.parametrize("m,n,k", SPLIT_CASES, ids=lambda v: str(v))
def test_split_bounds_cover_k_in_whole_panels(m, n, k):
    plan = k1._plan(m, n, k, torch.bfloat16, ALIGNED, ALIGNED)
    b = plan.k_bounds
    assert len(b) == plan.splits + 1 and b[0] == 0 and b[-1] == k
    sizes = [hi - lo for lo, hi in zip(b, b[1:])]
    assert all(s > 0 for s in sizes)  # no split is empty
    assert all(x % plan.bk == 0 for x in b[:-1])  # every split starts on a panel
    assert all(s % plan.bk == 0 for s in sizes[:-1])  # only the last holds the ragged tail
    # The kernel's own split arithmetic (csrc/opope_gemm.cu) gives the same.
    panels = -(-k // plan.bk)
    per, rem = divmod(panels, plan.splits)
    for s in range(plan.splits):
        p_begin = s * per + min(s, rem)
        p_count = per + (1 if s < rem else 0)
        assert b[s] == p_begin * plan.bk
        assert b[s + 1] == min(k, (p_begin + p_count) * plan.bk)
    if plan.splits > 1:
        assert min(sizes[:-1]) >= k1._MIN_SPLIT_PANELS * plan.bk
        assert plan.tiles <= k1._N_COUNTERS  # one split-K counter per tile
        # The last block's reduction reads at most one split's main-loop bytes.
        rows = min(m, plan.bm)
        assert plan.splits * rows * plan.bn * 4 <= k / plan.splits * (rows + plan.bn) * 2


@pytest.mark.parametrize("m", DECODE_MS)
@pytest.mark.parametrize("arch,k,n", MAIN_SHAPES, ids=lambda v: str(v))
def test_decode_shapes_fill_the_card(arch, k, n, m):
    """Blocks = tiles x splits: as many as fit one wave of the 132 SMs (the
    decode config holds one block an SM), unless K runs out of panels."""
    plan = k1._plan(m, n, k, torch.bfloat16, ALIGNED, ALIGNED)
    blocks = plan.tiles * plan.splits
    max_splits = k1._max_splits(m, k, plan.bm, plan.bn)
    assert blocks <= max(SMS, plan.tiles)
    assert plan.splits == max_splits or plan.tiles * (plan.splits + 1) > SMS
    if plan.splits < max_splits:
        assert blocks >= 0.75 * SMS or plan.tiles > SMS // 2


def test_decode_splits_of_the_served_shapes():
    """The numbers the kernel's design notes reckon with."""
    want = {(4096, 4096): (32, 4), (4096, 256): (2, 16), (4096, 13696): (107, 1),
            (13696, 4096): (32, 4), (2048, 2048): (16, 8), (2048, 64): (1, 8),
            (2048, 2816): (22, 6), (2816, 2048): (16, 8)}
    for (k, n), (tiles, splits) in want.items():
        plan = k1._plan(4, n, k, torch.bfloat16, ALIGNED, ALIGNED)
        assert (plan.tiles, plan.splits) == (tiles, splits), (k, n, plan)


@pytest.mark.parametrize("m,k,want", [(4, 4096, 16), (4, 2048, 8), (64, 4096, 6),
                                      (512, 4096, 5), (512, 13696, 10), (1, 64, 1)])
def test_max_splits(m, k, want):
    bm = 64 if m <= 64 else 128
    assert k1._max_splits(m, k, bm, 128) == want


def test_plan_is_a_pure_function_of_its_arguments():
    args = [(4, 4096, 4096, torch.bfloat16, ALIGNED, ALIGNED),
            (512, 256, 4096, torch.bfloat16, ALIGNED, ALIGNED),
            (130, 200, 300, torch.bfloat16, ALIGNED, ALIGNED),
            (5, 24, 40, torch.float32, ALIGNED, ALIGNED)]
    first = [k1._plan(*a) for a in args]
    again = [k1._plan(*a) for a in reversed(args)][::-1]
    assert first == again
    assert len({hash(p) for p in first}) == len(first)
    # Only alignment of the bases matters, not their values.
    assert k1._plan(4, 4096, 4096, torch.bfloat16, 16, 32) == first[0]


def test_wrapper_on_cpu_counts_no_route():
    before = dict(k1.opope_gemm.launches_by_route)
    a = torch.randn(4, 64, dtype=torch.bfloat16)
    b = torch.randn(64, 128, dtype=torch.bfloat16)
    got = k1.opope_gemm(a, b)
    assert k1.opope_gemm.launches_by_route == before
    torch.testing.assert_close(got.float(), (a.float() @ b.float()).bfloat16().float())


def test_launching_path_refuses_cpu_tensors():
    a = torch.randn(4, 64)
    b = torch.randn(64, 128)
    with pytest.raises(ValueError, match="cuda"):
        k1._run(a, b, None, None, (), ())
