"""The launch plan of the port's CUDA Anderson combine
(``repro_torch.kernels.anderson_mix.mix_plan``), checked on the CPU.

The plan is a pure function of the window's row length and the alignment
of its rows, so which loads run and how the columns are split are tested
here without a card: every column combined exactly once (also by a grid
smaller than the plan's, as the sweep launches and the grid-stride loop
allows), 16-byte loads only where every row starts on a 16-byte boundary,
the grid one thread per column pair.  The kernel itself is held against
the plain version on the card (``tests/test_torch_cuda.py``).
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import anderson_mix as mix  # noqa: E402

NS = (1, 7, 1001, 10 ** 6, 2 ** 20, 2 ** 22)
#: grid caps: none, and a few CTAs on an H100 SXM's 132 SMs or on one SM
MAX_GRIDS = (mix.MAX_GRID, 132 * 8, 132 * 2, 1)


def plans(N, off):
    """The plan, and the same plan with its grid capped."""
    p = mix.mix_plan(N, off)
    for cap in MAX_GRIDS:
        yield cap, p._replace(grid=min(p.grid, cap))


def coverage(p, N):
    """How many times the plan's launch combines each column."""
    diff = np.zeros(N + 1, np.int64)
    # thread t combines pairs t, t + threads, ...: each round of the
    # grid-stride loop covers one contiguous run of pairs
    threads, pairs = p.grid * mix.THREADS, N // 2
    for q0 in range(0, pairs, threads):
        diff[2 * q0] += 1
        diff[2 * min(pairs, q0 + threads)] -= 1
    if N % 2:
        diff[N - 1] += 1
        diff[N] -= 1
    return np.cumsum(diff)[:N]


@pytest.mark.parametrize("off", [0, 1])
@pytest.mark.parametrize("N", NS)
def test_every_column_once(N, off):
    for cap, p in plans(N, off):
        hits = coverage(p, N)
        assert hits.min() == 1 and hits.max() == 1, (cap, p)


@pytest.mark.parametrize("off", [0, 1])
@pytest.mark.parametrize("N", NS)
def test_vector_loads_only_on_aligned_rows(N, off):
    p = mix.mix_plan(N, off)
    for rows in range(2, 2 * mix.MAX_H + 1):
        # 16-byte loads exactly where every row the call reads starts on a
        # 16-byte boundary: row r starts 8 r N bytes past row 0
        row_starts = off + N * np.arange(rows)
        aligned = bool(np.all(row_starts % 2 == 0))
        assert (p.kernel == "vector") == aligned, (rows, p)


@pytest.mark.parametrize("off", [0, 1])
@pytest.mark.parametrize("N", NS)
def test_grid_one_thread_per_pair(N, off):
    p = mix.mix_plan(N, off)
    # a thread for every pair, so no thread loops, and no CTA without one
    assert 1 <= p.grid <= mix.MAX_GRID
    assert p.grid * mix.THREADS >= N // 2, p
    assert N < 2 or (p.grid - 1) * mix.THREADS < N // 2, p


@pytest.mark.parametrize("h,N", [(6, 2048 * 2048), (6, 10 ** 6),
                                 (9, 1024 * 1024)])
def test_main_path_windows_take_vector_loads(h, N):
    """The Jacobi, VI and SCF windows: any start of the window in its ring
    buffer keeps the rows aligned (N even); one thread per column
    pair."""
    for start in range(2 * 10):
        p = mix.mix_plan(N, start * N)
        assert p.kernel == "vector"
        assert p.grid == N // 2 // mix.THREADS + (N // 2 % mix.THREADS > 0)


def test_plan_constants_match_the_source():
    """The plan's sizes are the CUDA source's (``csrc/anderson_mix.cu``)."""
    src = (Path(mix.__file__).resolve().parent.parent / "csrc"
           / "anderson_mix.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kMaxH") == mix.MAX_H
    assert const("kThreads") == mix.THREADS
    assert "p.grid > 0x7fffffff" in src and mix.MAX_GRID == 0x7fffffff
    fields = re.search(r"struct MixPlan \{\s*int64_t ([^;]+);", src).group(1)
    assert [f.strip() for f in fields.split(",")] == [
        name for name, _ in mix._Plan._fields_]
