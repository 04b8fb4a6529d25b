"""The launch plans of the kernels on csrc/gemm_sm90.cuh's wgmma body, on
the CPU: ops/gemm_sm90.py mirrors the header's choice of tile form and
the blocks' walk over the output, so each launch of the ViT FFN (#13),
the eval block (#2 / #3), the training block (#9a / #9b) and the W8A8
block's s8 products (#8) can be checked to store every output row and
column exactly once (per split of its reduction) in K steps that cover K;
and the model layers' routes (JAX's width gates) admit no FFN width that
the wrappers refuse.
"""

import pytest

from tests.torch_helpers import one_torch_thread  # noqa: F401
from vitxtgqa_tpu_torch.ops import block_train as BT
from vitxtgqa_tpu_torch.ops import ffn as FFN
from vitxtgqa_tpu_torch.ops import fused_block as FB
from vitxtgqa_tpu_torch.ops import gemm_sm90 as G

ROWS = (2048, 2100, 3072, 3200, 4616, 9216, 12608, 55296)
WIDTHS = (768, 1024, 1152, 3072, 3200, 4096)


def assert_covers_once(ln: G.Launch):
    """Every block's columns lie below its problem's N, and per problem and
    split the blocks tile [0, M) x [0, N) exactly once: their row ranges
    partition the rows, their column ranges the columns, and each (rows,
    columns) pair is one block's."""
    seen = {}
    for pi, split, rows, cols in G.blocks(ln):
        p = ln.problems[pi]
        assert 0 <= rows.start < rows.stop <= p.M and 0 <= cols.start < cols.stop <= p.N
        key = (pi, split, rows.start, rows.stop, cols.start, cols.stop)
        assert key not in seen, f"two blocks store {key}"
        seen[key] = True
    for pi, p in enumerate(ln.problems):
        for split in range(-(-p.K // p.k_chunk)):
            mine = [k[2:] for k in seen if k[:2] == (pi, split)]
            row_cuts = sorted({(r0, r1) for r0, r1, _, _ in mine})
            col_cuts = sorted({(c0, c1) for _, _, c0, c1 in mine})
            assert [r0 for r0, _ in row_cuts] == [0] + [r1 for _, r1 in row_cuts[:-1]]
            assert row_cuts[-1][1] == p.M
            assert [c0 for c0, _ in col_cuts] == [0] + [c1 for _, c1 in col_cuts[:-1]]
            assert col_cuts[-1][1] == p.N
            assert len(mine) == len(row_cuts) * len(col_cuts)


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("rows", ROWS)
def test_a_product_covers_every_output_once(rows, n):
    """x W^T over [rows, n] in the form launch_gemm picks: narrow (128
    columns) where n is no multiple of 256 (1,152, 3,200) or the wide tiles
    would not fill one wave of the card."""
    ln = G.launch(G.problem(rows, n, 768))
    if n % G.WIDE_N:
        assert ln.tile_n == G.NARROW_N
    assert_covers_once(ln)


def test_the_coverage_check_rejects_a_launch_without_its_last_128_columns():
    """A launch over N = 1,152 in 256-column tiles (the body before its
    narrow form) counts N // 256 column tiles and leaves the last 128
    columns unwritten: the check fails on it."""
    ln = G.Launch((G.problem(2100, 1152, 768),), G.WIDE_N)
    with pytest.raises(AssertionError):
        assert_covers_once(ln)


def test_the_form_of_a_launch():
    """The wide form at the main paths' large products, the narrow one
    where a width is no multiple of 256 or the narrow tiles fit one wave
    (132 SMs): the 960-row text BERT block's 768-wide products, batch 2's
    eval block."""
    assert G.launch(G.problem(12608, 4096, 1024)).tile_n == G.WIDE_N
    assert G.launch(G.problem(9216, 768, 3072)).tile_n == G.WIDE_N   # 216 wide tiles
    assert G.launch(G.problem(3072, 768, 3072)).tile_n == G.WIDE_N   # 72: 144 narrow
    assert G.launch(G.problem(2304, 768, 3072)).tile_n == G.NARROW_N  # 54: 108 narrow
    assert G.launch(G.problem(960, 768, 768)).tile_n == G.NARROW_N    # 24: 48 narrow
    assert G.launch(G.problem(960, 3072, 768)).tile_n == G.WIDE_N     # 96: 192 narrow
    assert G.launch(G.problem(55296, 1152, 768)).tile_n == G.NARROW_N
    with pytest.raises(ValueError):
        G.launch(G.problem(100, 1000, 768))  # no multiple of 128
    with pytest.raises(ValueError):
        G.launch(G.problem(100, 768, 1000))  # a K-major K off the 64-deep step
    assert G.launch(G.problem(768, 768, 1000, 512), ragged_k=True).tile_n == G.NARROW_N


@pytest.mark.parametrize("m", range(128, 4097, 128))
def test_the_routes_admit_only_widths_the_wrappers_take(m):
    """At hidden 768, every FFN width that a model layer routes to a
    kernel (JAX's gates: BT.kernel_ok, FB.kernel_ok, FFN.ffn_kernel_ok)
    passes that kernel's width check, and each launch of its plan covers
    its output once.  Before the narrow tile, the training block refused
    m = 1,152 and 3,200 that its route admitted."""
    d = 768
    assert BT.kernel_ok(d, m) and FB.kernel_ok(d, m, 2048) and FFN.ffn_kernel_ok(d, m, 2048)
    BT.check_widths("block_train", d, m)
    FB.check_widths("fused_block", d, m)
    FFN.check_widths(d, m, d)
    for rows in (960, 2100, 9216, 55296):
        for ln in BT.gemm_launches(rows, d, m):
            assert_covers_once(ln)
    for rows in (2100, 9216):
        for ln in FB.launch_plan(rows, d, m) + FFN.launch_plan(rows, d, m, d):
            assert_covers_once(ln)


@pytest.mark.parametrize("d, m", [(704, 3072), (768, 3000)])
def test_the_wrappers_refuse_what_the_kernels_do_not_take(d, m):
    """A hidden width no multiple of 128 (the row passes; JAX's gate refuses
    it too), or an FFN width no multiple of 128, raises before a launch."""
    with pytest.raises(NotImplementedError):
        BT.check_widths("block_train", d, m)
    with pytest.raises(NotImplementedError):
        FB.check_widths("fused_block", d, m)


def test_the_block_plans_of_the_main_paths():
    """The forms of the main paths' launches: the training step's 55,296
    rows and the eval block's 9,216 wide throughout; the 960-row text BERT
    block narrow on its 768-wide products; at m = 3,200 the launches over
    m narrow (the 768-wide ones at 55,296 rows wide); the ViT-L/16 FFN
    wide."""
    N, W = G.NARROW_N, G.WIDE_N
    assert {ln.tile_n for ln in BT.gemm_launches(55296, 768, 3072)} == {W}
    assert [ln.tile_n for ln in BT.gemm_launches(960, 768, 3072)] == [N, W, N, W, N, N, W]
    assert [ln.tile_n for ln in BT.gemm_launches(55296, 768, 3200)] == [W, N, W, N, W, W, N]
    assert {ln.tile_n for ln in FB.launch_plan(9216, 768, 3072)} == {W}
    assert {ln.tile_n for ln in FFN.launch_plan(12608, 1024, 4096, 1024)} == {W}


@pytest.mark.parametrize("rows", (1152, 2304, 4608, 9216))
def test_the_split_forms_cover_a_ranks_outputs(rows):
    """The split forms' launches on a rank's shares at model 2 (ops/
    fused_block.tp_launch_plan, ops/block_train.tp_gemm_launches: 384
    attention and 1,536 FFN columns) and at model 4 (192 and 768) each
    cover their output once, in K steps that cover K; at model 4 the
    launches over a 192-column N (#9b's dctx, and the weight gradients'
    launch with dWo) take the thin 64-column tiles and the rest the
    forms they take at model 2; a share of 96 columns (model 8) fits no
    tile and the wrappers refuse it."""
    d, m = 768, 3072
    for n in (2, 4):
        FB.check_tp_widths("fused_block_tp", d, d // n, m // n)
        FB.check_tp_widths("block_train_bwd_tp", d, d // n, m // n)
        plans = FB.tp_launch_plan(rows, d, d // n, m // n) + BT.tp_gemm_launches(
            rows, d, d // n, m // n)
        for ln in plans:
            assert_covers_once(ln)
            assert_k_steps_cover(ln)
        thin = [ln.tile_n == G.THIN_N for ln in plans]
        assert thin == [False] * 8 + [n == 4, n == 4], n
    with pytest.raises(NotImplementedError):
        FB.check_tp_widths("block_train_bwd_tp", d, d // 8, m // 8)
    with pytest.raises(ValueError):
        BT.tp_gemm_launches(rows, d, d // 8, m // 8)


@pytest.mark.parametrize("rows", ROWS)
def test_a_thin_product_covers_every_output_once(rows):
    """A product whose N is a multiple of 64 but not of 128 (a rank's
    192-column attention share at model 4) takes the thin form and covers
    its output once, also beside a 768-wide product in splits of a ragged
    K (the weight gradients' launch, both operands MN-major)."""
    ln = G.launch(G.problem(rows, 192, 768))
    assert ln.tile_n == G.THIN_N
    assert_covers_once(ln)
    ln = G.launch(G.problem(768, 192, rows, 512), G.problem(768, 768, rows, 512),
                  ragged_k=True)
    assert ln.tile_n == G.THIN_N
    assert_covers_once(ln)


def assert_k_steps_cover(ln: G.Launch):
    """Per problem and split, the K steps (k_step elements each, from the
    split's start) cover the split's rows of K exactly: no step reads past
    K, none is left out."""
    for pi, p in enumerate(ln.problems):
        for split in range(-(-p.K // p.k_chunk)):
            steps = list(G.k_steps(ln, pi, split))
            kb = split * p.k_chunk
            assert [s.start for s in steps] == list(range(kb, kb + len(steps) * ln.k_step,
                                                          ln.k_step))
            assert steps[-1].stop == min(p.K, kb + p.k_chunk)


S8_ROWS = (2048, 2100, 2304, 3072, 9216)


@pytest.mark.parametrize("k", (768, 3072))
@pytest.mark.parametrize("n", (768, 3072))
@pytest.mark.parametrize("rows", S8_ROWS)
def test_an_s8_product_covers_every_output_once(rows, n, k):
    """The W8A8 block's s8 products (launch_gemm_s8: 128-column tiles, K
    steps of 128 int8) at its row counts (batch 8, compact, batch 2, the
    ragged 2,100, the 2,048 gate) and widths: every output element is
    one block's, and the K steps cover K exactly."""
    ln = G.launch_s8(G.problem(rows, n, k))
    assert (ln.tile_n, ln.k_step) == (G.NARROW_N, G.S8_K_STEP)
    assert_covers_once(ln)
    assert_k_steps_cover(ln)


@pytest.mark.parametrize("rows", S8_ROWS)
def test_the_w8a8_launch_plan(rows):
    """ops/fused_block.w8a8_launch_plan: c8 Wo8^T over [rows, 768] (K
    768), x8 W18^T over [rows, 3072] (K 768), h8 W28^T over [rows, 768] (K
    3,072), each covering its output once in K steps of 128."""
    plan = FB.w8a8_launch_plan(rows, 768, 3072)
    assert [(ln.problems[0].N, ln.problems[0].K) for ln in plan] == [(768, 768), (3072, 768),
                                                                      (768, 3072)]
    for ln in plan:
        assert_covers_once(ln)
        assert_k_steps_cover(ln)


def test_the_k_step_checks_reject_what_the_kernels_refuse():
    """A K of 64 more than a multiple of 128 tiles in bf16 (steps of 64)
    but not in s8 (steps of 128), and the check of the steps rejects a
    launch that walks such a K in steps of 128 (its last step would read
    past K)."""
    assert_k_steps_cover(G.launch(G.problem(2100, 768, 832)))
    with pytest.raises(ValueError):
        G.launch_s8(G.problem(2100, 768, 832))
    with pytest.raises(AssertionError):
        assert_k_steps_cover(G.Launch((G.problem(2100, 768, 832),), G.NARROW_N, G.S8_K_STEP))
