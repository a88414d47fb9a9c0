"""The port's ``utils/rotations.py`` against the JAX package's
``cddp_tpu/utils/rotations.py`` (CPU, float64, 1e-12): every function on a
seeded batch of attitudes, the port's batched call against the JAX function
row by row, and ``rotation_matrix_to_quat`` on rotations that make each of
its four branches win, on ties between them (a 180-degree turn about (1,
-1, 0) / sqrt 2 ties R00 and R11) and on rotations near each branch's
switch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cddp_tpu.utils import rotations as jrot
from cddp_tpu_torch.utils import rotations

torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=1e-12)


def _quats(B=16, seed=0):
    q = np.random.default_rng(seed).normal(size=(B, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _rows(fn, batch):
    return np.stack([np.asarray(fn(jnp.asarray(v))) for v in batch])


def _port(fn, batch):
    return fn(torch.as_tensor(batch)).numpy()


def test_skew_matches_jax():
    v = np.random.default_rng(1).normal(size=(8, 3))
    np.testing.assert_allclose(_port(rotations.skew, v), _rows(jrot.skew, v), **TOL)
    # skew(v) w = v x w.
    w = np.random.default_rng(2).normal(size=(8, 3))
    got = (rotations.skew(torch.as_tensor(v)) @ torch.as_tensor(w)[..., None])[..., 0]
    np.testing.assert_allclose(got.numpy(), np.cross(v, w), **TOL)


def test_quat_to_rotation_matrix_matches_jax():
    q = _quats()
    R = _port(rotations.quat_to_rotation_matrix, q)
    np.testing.assert_allclose(R, _rows(jrot.quat_to_rotation_matrix, q), **TOL)
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1), np.broadcast_to(np.eye(3), R.shape),
                               atol=1e-12)


def _axis_angle(axis, angle):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    return np.concatenate([[np.cos(angle / 2)], np.sin(angle / 2) * axis])


# (quaternion, the branch of rotation_matrix_to_quat that wins: 0 w, 1 x,
# 2 y, 3 z).
BRANCHES = {
    "w": (_axis_angle([0.3, -0.5, 0.8], 0.7), 0),
    "x": (_axis_angle([1.0, 0.2, -0.1], 3.0), 1),
    "y": (_axis_angle([0.1, -1.0, 0.3], 2.9), 2),
    "z": (_axis_angle([-0.2, 0.1, 1.0], 3.1), 3),
    "x_180": (_axis_angle([1.0, 0.0, 0.0], np.pi), 1),
    "tie_xy": (_axis_angle([1.0, -1.0, 0.0], np.pi), 1),
    "tie_yz": (_axis_angle([0.0, 1.0, 1.0], np.pi), 2),
    "tie_wz": (_axis_angle([0.0, 0.0, 1.0], np.pi / 2), 0),
}


@pytest.mark.parametrize("case", sorted(BRANCHES))
def test_rotation_matrix_to_quat_branches(case):
    """Each branch wins where its score (trace, R00, R11, R22) is the
    largest, the first of tied scores, as the JAX ``argmax`` takes it; the
    result is the quaternion up to sign, of unit norm."""
    q, branch = BRANCHES[case]
    R = np.asarray(jrot.quat_to_rotation_matrix(jnp.asarray(q)))
    scores = [np.trace(R), R[0, 0], R[1, 1], R[2, 2]]
    assert int(np.argmax(scores)) == branch
    got = _port(rotations.rotation_matrix_to_quat, R[None])[0]
    np.testing.assert_allclose(got, np.asarray(jrot.rotation_matrix_to_quat(jnp.asarray(R))),
                               **TOL)
    sign = np.sign(np.dot(got, q))
    np.testing.assert_allclose(sign * got, q, atol=1e-12)


def test_rotation_matrix_to_quat_batch_matches_jax():
    """A batch mixing every branch (random attitudes, the cases above and
    rotations near each switch) in one call, row by row against JAX."""
    q = np.concatenate([_quats(32, seed=3), np.stack([v for v, _ in BRANCHES.values()]),
                        np.stack([_axis_angle(a, np.pi - 1e-9) for a in np.eye(3)])])
    R = _rows(jrot.quat_to_rotation_matrix, q)
    np.testing.assert_allclose(_port(rotations.rotation_matrix_to_quat, R),
                               _rows(jrot.rotation_matrix_to_quat, R), **TOL)


def test_euler_zyx_round_trip_matches_jax():
    a = np.random.default_rng(4).uniform(-1.4, 1.4, size=(12, 3))
    R = _port(rotations.euler_zyx_to_rotation_matrix, a)
    np.testing.assert_allclose(R, _rows(jrot.euler_zyx_to_rotation_matrix, a), **TOL)
    back = _port(rotations.rotation_matrix_to_euler_zyx, R)
    np.testing.assert_allclose(back, _rows(jrot.rotation_matrix_to_euler_zyx, R), **TOL)
    np.testing.assert_allclose(back, a, atol=1e-12)


def test_mrp_conversions_match_jax():
    """The shadow set is taken where qw < 0, so |sigma| <= 1."""
    q = _quats(16, seed=5)
    assert (q[:, 0] < 0).any() and (q[:, 0] > 0).any()
    s = _port(rotations.quat_to_mrp, q)
    np.testing.assert_allclose(s, _rows(jrot.quat_to_mrp, q), **TOL)
    assert np.all(np.linalg.norm(s, axis=1) <= 1.0 + 1e-12)
    np.testing.assert_allclose(_port(rotations.mrp_to_quat, s), _rows(jrot.mrp_to_quat, s),
                               **TOL)
    np.testing.assert_allclose(_port(rotations.mrp_to_rotation_matrix, s),
                               _rows(jrot.mrp_to_rotation_matrix, s), **TOL)
    np.testing.assert_allclose(_port(rotations.mrp_to_rotation_matrix, s),
                               _port(rotations.quat_to_rotation_matrix, q), atol=1e-12)
