"""Scenes are a function of the seed and the index alone."""

from __future__ import annotations

import numpy as np

from portbench import scenes


def test_same_seed_same_scene():
    a = scenes.ring(2 ** 31 + 11, 2, 72, 128)
    b = scenes.ring(2 ** 31 + 11, 2, 72, 128)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert a[0].dtype == np.uint8 and a[0].shape == (72, 128, 3)
    assert a[0].flags.c_contiguous


def test_any_whole_number_seeds():
    for seed in (-1, 0, 2 ** 31 + 11, 2 ** 64 + 3):
        assert scenes.ring(seed, 1, 24, 40)[0].shape == (24, 40, 3)


def test_seeds_and_indices_differ():
    a = scenes.ring(5, 2, 72, 128)
    b = scenes.ring(6, 2, 72, 128)
    assert not np.array_equal(a[0], a[1])
    assert not np.array_equal(a[0], b[0])
    assert np.array_equal(scenes.ring(5, 1, 72, 128, first=1)[0], a[1])


def test_structure_is_the_same_for_every_seed():
    for seed in (0, 1, 2 ** 33 + 5):
        quads, qcol, bars, bcol = scenes._shapes(seed, 0, 720, 1280)
        assert quads.shape == (scenes.QUADS, 4, 2)
        assert bars.shape == (scenes.BARS, 4, 2)
        # each quadrilateral stays inside its own grid cell
        rows, cols = scenes.GRID
        for i, q in enumerate(quads):
            r, c = divmod(i, cols)
            assert (q[:, 0] > c * 1280 / cols).all()
            assert (q[:, 0] < (c + 1) * 1280 / cols).all()
            assert (q[:, 1] > r * 720 / rows).all()
            assert (q[:, 1] < (r + 1) * 720 / rows).all()
