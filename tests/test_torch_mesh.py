"""The port's mesh choice against the JAX package's, and its mesh class.

``choose_2d_mesh``, ``choose_train_mesh`` and ``pad_to_multiple`` of
``mikudance_tpu_torch/core/mesh.py`` against the JAX functions on the first n
devices of the 8-device CPU platform (tests/conftest.py): the same axis
sizes and the same devices (ranks), the 6-of-8 subset and ``None`` included.
The mesh class is read without a process group: its rank grid, the lines of
each axis (one process group each where a group exists), coordinates and
the collectives of a one-rank axis. No process is started.
"""

import jax
import numpy as np
import pytest
import torch

from mikudance_tpu.core import mesh as jmesh
from mikudance_tpu_torch.core import mesh

BATCHES = (1, 2, 4, 6, 12)
FRAMES = (1, 4, 8, 16, 30)


@pytest.mark.parametrize("which", ["choose_2d_mesh", "choose_train_mesh"])
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_choice_matches_jax(which, batch, n):
    for frames in FRAMES:
        want = getattr(jmesh, which)(jax.devices()[:n], batch, frames)
        got = getattr(mesh, which)(range(n), batch, frames)
        if want is None:
            assert got is None, (n, batch, frames)
            continue
        assert got.axis_names == want.axis_names
        assert got.shape == dict(want.shape), (n, batch, frames)
        np.testing.assert_array_equal(got.ranks, np.vectorize(lambda d: d.id)(want.devices))


def test_headline_shapes_and_subset():
    """B's geometry on 4 ranks is (win 2, frame 2); 30-frame windows on 8
    ranks use 6 of them; one rank is no mesh."""
    assert mesh.choose_2d_mesh(range(4), 2, 16).shape == {"win": 2, "frame": 2}
    m = mesh.choose_2d_mesh(range(8), 6, 30)
    assert m.size == 6 and m.shape == {"win": 6, "frame": 1} and 7 not in m and 5 in m
    assert mesh.choose_2d_mesh(range(1), 2, 16) is None
    assert mesh.choose_train_mesh(range(8), 1, 20).shape == {"data": 1, "frame": 5}


@pytest.mark.parametrize("n", [0, 1, 5, 8, 9, 31])
@pytest.mark.parametrize("m", [1, 4, 8])
def test_pad_to_multiple_matches_jax(n, m):
    assert mesh.pad_to_multiple(n, m) == jmesh.pad_to_multiple(n, m)


def test_mesh_grid_lines_and_coordinates():
    """A (win 2, frame 4) grid over ranks 0-7, read without a process group:
    its lines are the process groups the ranks build, in this order."""
    m = mesh.Mesh(np.arange(8).reshape(2, 4), (mesh.WIN_AXIS, mesh.FRAME_AXIS))
    assert m.shape == {"win": 2, "frame": 4} and m.size == 8
    assert m.lines("win") == [(0, 4), (1, 5), (2, 6), (3, 7)]
    assert m.lines("frame") == [(0, 1, 2, 3), (4, 5, 6, 7)]
    assert m.lines(None) == [tuple(range(8))]
    assert m.coords(6) == {"win": 1, "frame": 2}
    assert m.rank == 0 and m.index() == 0 and m.index("frame") == 0
    assert m._groups == {}  # no process group, no groups
    assert m.axis_size("frame") == 4 and m.axis_size() == 8
    assert mesh.Axis(m, "win").size == 2
    with pytest.raises(ValueError, match="axes"):
        mesh.Mesh(np.arange(4), ("win", "frame"))
    with pytest.raises(ValueError, match="not in"):
        mesh.Mesh(np.arange(1, 3), ("data",)).coords()


def test_make_mesh_without_a_process_group_is_one_rank():
    m = mesh.make_mesh()
    assert m.size == 1 and m.shape == {"data": 1} and m.lines("data") == [(0,)]
    assert mesh.init_from_env("cpu") is None  # no torchrun: nothing is started


def test_one_rank_collectives_are_the_identity():
    m = mesh.make_mesh(axis_name=mesh.FRAME_AXIS)
    x = torch.arange(24.0).reshape(3, 2, 4)
    ax = mesh.Axis(m, mesh.FRAME_AXIS)
    for y in (ax.all_gather(x, 1), ax.all_to_all(x, 1, 0), ax.psum(x), m.broadcast(x, 0)):
        assert torch.equal(y, x)
    left, right = ax.halo(x)
    assert left.shape == right.shape == (1, 2, 4) and not left.any() and not right.any()
