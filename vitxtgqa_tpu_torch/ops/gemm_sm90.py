"""The host-side mirror of csrc/gemm_sm90.cuh's launches: which tile form a
launch takes and which output rows and columns each of its blocks
stores, in pure Python, so that the CPU tests can check that a plan
covers every output element exactly once and that a wrapper admits only
the widths its kernel takes.

A launch is one to three problems C[M, N] = A B over K, each cut into
splits of ``k_chunk`` rows of K and walked in K steps of one 128-byte row:
64 bf16 elements (``K_STEP``) or 128 int8 (``S8_K_STEP``).  In bf16 its
blocks own 128 output rows by 256 columns (the wide form) or by 128 (the
narrow form, for a launch where some N is no multiple of 256, or whose
narrow tiles fit one wave of the H100's 132 SMs) or by 64 (the thin form,
for a launch where some N is no multiple of 128: a tensor-parallel rank's
192-column share at model 4); the s8 products of the W8A8 block take one
form of 128 columns (``launch_s8``).  The constants and the rule are the
header's (``kBM``, ``Wide``, ``Narrow``, ``Thin``, ``S8``, ``kSMs``,
``Elem``, ``thin_launch``, ``narrow_launch``, ``launch_gemm_s8``,
``tile_args`` and the item walk of ``gemm_kernel``).
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Sequence, Tuple

TILE_M, K_STEP, S8_K_STEP = 128, 64, 128
WIDE_N, NARROW_N, THIN_N = 256, 128, 64
SMS = 132  # kSMs: one wave of one-block-an-SM tiles on the H100


class Problem(NamedTuple):
    M: int
    N: int
    K: int
    k_chunk: int  # rows of K in one split (a multiple of K_STEP)


class Launch(NamedTuple):
    problems: Tuple[Problem, ...]
    tile_n: int   # the form's output columns a block: WIDE_N, NARROW_N or THIN_N
    k_step: int = K_STEP  # elements of K a step: K_STEP (bf16) or S8_K_STEP


def problem(M: int, N: int, K: int, k_chunk: int = 0) -> Problem:
    """One product over all of K (``k_chunk`` 0) or in splits of k_chunk."""
    return Problem(M, N, K, k_chunk or K)


def _splits(p: Problem) -> int:
    return -(-p.K // p.k_chunk)


def tile_n(problems: Sequence[Problem]) -> int:
    """thin_launch, then narrow_launch: the thin form where some N is no
    multiple of the narrow tile; else the narrow form where some N is no
    multiple of the wide tile, or where the narrow tiles, over every
    problem and split, fit one wave."""
    if any(p.N % NARROW_N for p in problems):
        return THIN_N
    wide = 0
    for p in problems:
        if p.N % WIDE_N:
            return NARROW_N
        wide += -(-p.M // TILE_M) * (p.N // WIDE_N) * _splits(p)
    return NARROW_N if 2 * wide <= SMS else WIDE_N


def launch(*problems: Problem, ragged_k: bool = False) -> Launch:
    """The bf16 launch of these problems, in the form launch_gemm picks;
    raises where tile_args refuses them (the kernel would return an error).
    K is a multiple of K_STEP unless ``ragged_k`` (both operands MN-major:
    the weight gradients' reduction over the rows)."""
    return _checked(problems, tile_n(problems), K_STEP, ragged_k)


def launch_s8(*problems: Problem) -> Launch:
    """The s8 launch of these problems (launch_gemm_s8: form S8, 128
    columns, K steps of 128 int8, both operands K-major)."""
    return _checked(problems, NARROW_N, S8_K_STEP, False)


def _checked(problems, bn: int, k_step: int, ragged_k: bool) -> Launch:
    for p in problems:
        if (min(p.M, p.N, p.K) <= 0 or p.N % bn or p.k_chunk <= 0 or p.k_chunk % k_step
                or (not ragged_k and p.K % k_step)):
            raise ValueError(f"gemm_sm90: no {bn}-column tiling of {p} in K steps of {k_step}")
    return Launch(tuple(problems), bn, k_step)


def blocks(ln: Launch) -> Iterator[Tuple[int, int, range, range]]:
    """(problem, split, output rows, output columns) that each block of the
    launch stores, in blockIdx order: gemm_kernel's walk (splits, then row
    tiles, then column tiles fastest); a block stores its rows below M
    (tile_rows) and all its tile_n columns."""
    for pi, p in enumerate(ln.problems):
        m_tiles, n_tiles = -(-p.M // TILE_M), p.N // ln.tile_n
        for item in range(m_tiles * n_tiles * _splits(p)):
            split, t = divmod(item, m_tiles * n_tiles)
            m_tile, n_tile = divmod(t, n_tiles)
            m0, n0 = m_tile * TILE_M, n_tile * ln.tile_n
            yield pi, split, range(m0, min(m0 + TILE_M, p.M)), range(n0, n0 + ln.tile_n)


def k_steps(ln: Launch, pi: int, split: int) -> Iterator[range]:
    """The K elements that each step of a block of problem ``pi``, split
    ``split`` reads (gemm_kernel's loop: ceil(split length / k_step) steps
    from the split's start; a K-major load past K would read out of
    bounds, so the steps must end at K)."""
    p = ln.problems[pi]
    kb = split * p.k_chunk
    ke = min(p.K, kb + p.k_chunk)
    for i in range(-(-(ke - kb) // ln.k_step)):
        yield range(kb + i * ln.k_step, kb + (i + 1) * ln.k_step)
