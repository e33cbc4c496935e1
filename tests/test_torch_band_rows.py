"""The band layout's row index map (csrc/win_map.cuh, through which the
windowed attention's kernels read and write a window's tokens in the (N,
Hp, Wp, C) map, forward and backward) against window_partition's window
order, on the CPU: its Python twin ``band_token_rows`` at each Swin-T
stage's map and at maps of several windows a side that are not square,
unshifted and, as the shifted blocks see it, after the roll by half a
window."""

import pytest
import torch

from idvs.morec_tpu_torch.ops.cuda.attention import (band_token_rows,
                                                     window_partition,
                                                     window_reverse)

SWIN_T_SIDES = (56, 28, 14, 7)


def _check(N, Hp, Wp, w, shifted):
    x = torch.randn(N, Hp, Wp, 5)
    if shifted:
        x = torch.roll(x, (-(w // 2), -(w // 2)), (1, 2))
    rows = band_token_rows(N, Hp, Wp, w)
    wins = window_partition(x, w)
    assert torch.equal(x.reshape(-1, 5)[rows], wins.reshape(-1, 5))
    # a permutation: every row of the map is read once, and writing the
    # windows' rows back in place is window_reverse
    assert torch.equal(torch.sort(rows).values, torch.arange(N * Hp * Wp))
    back = torch.empty(N * Hp * Wp, 5)
    back[rows] = wins.reshape(-1, 5)
    assert torch.equal(back.reshape(x.shape), window_reverse(wins, w, Hp, Wp))


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("side", SWIN_T_SIDES)
def test_rows_at_the_swin_t_stages(side, shifted):
    _check(2, side, side, 7, shifted)


@pytest.mark.parametrize("N,Hp,Wp,w", [(1, 8, 12, 4), (3, 21, 14, 7),
                                       (2, 6, 6, 3), (1, 4, 4, 4)])
def test_rows_of_other_maps(N, Hp, Wp, w):
    for shifted in (False, True):
        _check(N, Hp, Wp, w, shifted)
