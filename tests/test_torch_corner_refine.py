"""The port's wiz_rev corner refine (pdf_table_tpu_torch/models/lore/
corner_refine.py) against the JAX dense form and its numpy twin, on seeded
cells and corner detections built so that snapped pairs, exact distance
ties, duplicate corners, score ties after the 0.4 penalty and cells with
<= 2 refinement events all occur. Every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdf_table_tpu.models.lore import corner_refine as jcr
from pdf_table_tpu_torch.models.lore.corner_refine import (
    refine_sort, refine_vertices_by_corners)

torch.set_num_threads(1)

VIS, VIS_CORNER = 0.2, 0.3


def _tie_block():
    """Two axis-aligned cells on exact coordinates, away from the random
    ones. Cell A (score 0.5) takes the midpoint of its top edge twice
    (equidistant from two vertices; the same corner twice): 2 events, so
    its score drops to 0.5 * 0.4 == 0.2 in f32. Cell B (score 0.2) takes a
    corner on each of three vertices: 3 events, its score stays 0.2, and
    the two tie."""
    dets = np.array([[200, 200, 210, 200, 210, 208, 200, 208],
                     [240, 240, 248, 240, 248, 246, 240, 246]], np.float32)
    scores = np.array([0.5, 0.2], np.float32)

    def box(x, y):
        return [x - 1, y - 0.5, x + 1, y - 0.5, x + 1, y + 0.5, x - 1,
                y + 0.5]

    gboxes = np.array([box(205, 201), box(205, 201), box(241.5, 241),
                       box(246.5, 241), box(246.5, 245)], np.float32)
    gcenters = np.array([[205, 200], [205, 200], [240, 240], [248, 240],
                         [248, 246]], np.float32)
    return dets, scores, gboxes, gcenters


def make_case(seed, K=12, M=24):
    """Random cells + corners near their vertices (tests/
    test_corner_refine.py's generator), with the tie block mixed in; both
    score lists sorted descending, as the decode gives them."""
    rng = np.random.default_rng(seed)
    dets = np.zeros((K, 8), np.float32)
    for i in range(K):
        x, y = rng.uniform(5, 80, 2)
        w, h = rng.uniform(8, 20, 2)
        dets[i] = [x, y, x + w, y, x + w, y + h, x, y + h]
        dets[i, 0::2] += rng.normal(0, 0.3, 4)
        dets[i, 1::2] += rng.normal(0, 0.3, 4)
    scores = rng.uniform(0.05, 0.95, K).astype(np.float32)
    gboxes = np.zeros((M, 8), np.float32)
    gcenters = np.zeros((M, 2), np.float32)
    for j in range(M):
        i = rng.integers(0, K)
        v = rng.integers(0, 4)
        gboxes[j] = dets[i] + rng.normal(0, 0.5, 8)
        gcenters[j] = dets[i, 2 * v:2 * v + 2] + rng.normal(0, 1.0, 2)
    td, ts, tb, tc = _tie_block()
    dets = np.concatenate([dets, td]).astype(np.float32)
    scores = np.concatenate([scores, ts])
    gboxes = np.concatenate([gboxes, tb]).astype(np.float32)
    gcenters = np.concatenate([gcenters, tc]).astype(np.float32)
    order = np.argsort(-scores, kind="stable")
    dets, scores = dets[order], scores[order]
    gscores = rng.uniform(0.1, 0.9, len(gboxes)).astype(np.float32)
    gscores[-5:] = 0.95                  # the tie block's corners, valid
    order = np.argsort(-gscores, kind="stable")
    return (dets, scores, gboxes[order], gcenters[order], gscores[order])


def _batch(seeds):
    cases = [make_case(s) for s in seeds]
    return [np.stack(a) for a in zip(*cases)]


@pytest.fixture(scope="module")
def case():
    return _batch(range(4))


def test_refine_matches_jax_dense_and_numpy_twin(case):
    dets, scores, gboxes, gcenters, gscores = case
    got_d, got_s = refine_vertices_by_corners(
        *(torch.from_numpy(a) for a in case), VIS, VIS_CORNER)
    jd, js = jcr.refine_vertices_by_corners(*(jnp.asarray(a) for a in case),
                                            VIS, VIS_CORNER)
    nd, ns = jcr.refine_vertices_by_corners_np(*case, VIS, VIS_CORNER)
    for want_d, want_s in ((np.asarray(jd), np.asarray(js)), (nd, ns)):
        np.testing.assert_array_equal(got_d.numpy(), want_d)
        np.testing.assert_array_equal(got_s.numpy(), want_s)


def test_case_exercises_the_branches(case):
    """The inputs reach what the test means to hold: snapped vertices,
    penalized and kept cells, and the tie block's two snaps."""
    dets, scores = case[0], case[1]
    got_d, got_s = refine_vertices_by_corners(
        *(torch.from_numpy(a) for a in case), VIS, VIS_CORNER)
    moved = (got_d.numpy() != dets).reshape(*dets.shape[:2], 4, 2).any(-1)
    above = scores >= VIS
    assert moved.sum() >= 8
    penalized = got_s.numpy() != scores
    assert (penalized & above).any() and (~penalized & above).any()
    # cell A: the edge midpoint goes to vertex 0 (the first minimum)
    b, k = np.argwhere((dets == _tie_block()[0][0]).all(-1))[0]
    np.testing.assert_array_equal(got_d[b, k].numpy(),
                                  [205, 200, 210, 200, 210, 208, 200, 208])


def _dc_packed(case):
    dets, scores, gboxes, gcenters, gscores = case
    B, K, _ = dets.shape
    inds = np.broadcast_to(np.arange(K, dtype=np.float32) * 7 + 3, (B, K))
    cells = np.concatenate([dets, scores[..., None], inds[..., None],
                            np.zeros((B, K, 1), np.float32)], -1)
    corners = np.concatenate([gboxes, gcenters, gscores[..., None]], -1)
    return np.concatenate([cells, corners], 1).astype(np.float32), K


def test_refine_sort_matches_jax_and_host_sorts(case):
    """refine_sort against the JAX task's device middle (dense refine +
    stable jnp.argsort) and its host detour (numpy twin + stable
    np.argsort)."""
    dc, k = _dc_packed(case)
    got = [t.numpy() for t in refine_sort(torch.from_numpy(dc), k, VIS,
                                          VIS_CORNER)]
    cells, corners = dc[:, :k], dc[:, k:]
    args = (cells[..., :8], cells[..., 8], corners[..., :8],
            corners[..., 8:10], corners[..., 10], VIS, VIS_CORNER)
    inds = cells[..., 9].astype(np.int32)
    jd, js = jcr.refine_vertices_by_corners(*(jnp.asarray(a)
                                              for a in args[:5]), *args[5:])
    order = jnp.argsort(-js, axis=1)
    want_dev = [np.asarray(jnp.take_along_axis(jd, order[..., None], 1)),
                np.asarray(jnp.take_along_axis(jnp.asarray(inds), order, 1)),
                np.asarray(jnp.take_along_axis(js, order, 1))]
    nd, ns = jcr.refine_vertices_by_corners_np(*args)
    order = np.argsort(-ns, axis=1, kind="stable")
    want_host = [np.take_along_axis(nd, order[..., None], 1),
                 np.take_along_axis(inds, order, 1),
                 np.take_along_axis(ns, order, 1)]
    for want in (want_dev, want_host):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    # the tie: penalized cell A keeps its place before cell B
    cell_b = _tie_block()[0][1]
    s = got[2][0]
    assert (s[:-1] >= s[1:]).all()
    ka = int(np.argwhere((got[0][0] == [205, 200, 210, 200, 210, 208, 200,
                                        208]).all(-1))[0, 0])
    kb = int(np.argwhere((got[0][0] == cell_b).all(-1))[0, 0])
    assert s[ka] == s[kb] == np.float32(0.2) and kb == ka + 1


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_refine_sort_other_seeds(seed):
    case = _batch([seed, seed + 100])
    dc, k = _dc_packed(case)
    got_d, got_i, got_s = refine_sort(torch.from_numpy(dc), k, VIS,
                                      VIS_CORNER)
    nd, ns = jcr.refine_vertices_by_corners_np(*case, VIS, VIS_CORNER)
    order = np.argsort(-ns, axis=1, kind="stable")
    np.testing.assert_array_equal(got_d.numpy(),
                                  np.take_along_axis(nd, order[..., None], 1))
    np.testing.assert_array_equal(got_s.numpy(),
                                  np.take_along_axis(ns, order, 1))
    np.testing.assert_array_equal(
        got_i.numpy(), np.take_along_axis(dc[:, :k, 9].astype(np.int64),
                                          order, 1))
