"""glam-parity linear algebra in PyTorch.

Port of `topo_renderer_tpu/ops/mathx.py`: the reference's camera math is
built on the Rust `glam` crate (`topo-renderer/src/data/camera.rs`), with
column-vector matrices (``M @ v``), right-handed, depth range [0, 1].
Everything is float32; vectors are ``[3]`` tensors.
"""

from __future__ import annotations

import math

import torch

_EPS_ARC = 1.0 - 2.0 * float(torch.finfo(torch.float32).eps)


def norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the (short) trailing axis, summed left to right.

    Scalar-precision trap: ``jnp.linalg.norm`` reduces the squares in
    float32 in index order; a library norm may accumulate in another order
    or in double, which moves the eye radius (and with it every window
    origin) by an ulp."""
    acc = v[..., 0] * v[..., 0]
    for i in range(1, v.shape[-1]):
        acc = acc + v[..., i] * v[..., i]
    return torch.sqrt(acc)


def normalize(v, eps=0.0):
    n = norm(v)[..., None]
    return v / torch.clamp(n, min=eps) if eps else v / n


def cross(a, b):
    return torch.stack(
        [
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
        ]
    )


def dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def quat_from_axis_angle(axis, angle):
    """glam `Quat::from_axis_angle` — axis must be normalized. Returns xyzw."""
    half = 0.5 * torch.as_tensor(angle, dtype=torch.float32, device=axis.device)
    s = torch.sin(half)
    return torch.cat([axis * s, torch.cos(half)[None]])


def any_orthonormal_vector(v):
    """glam `Vec3::any_orthonormal_vector` (Pixar's orthonormal basis paper)."""
    sign = torch.where(v[2] >= 0.0, 1.0, -1.0).to(torch.float32)
    a = -1.0 / (sign + v[2])
    b = v[0] * v[1] * a
    return torch.stack([b, sign + v[1] * v[1] * a, -v[1]])


def quat_from_rotation_arc(from_v, to_v):
    """glam `Quat::from_rotation_arc` — both inputs must be unit vectors
    (`camera.rs:104-111`)."""
    d = dot(from_v, to_v)
    c = cross(from_v, to_v)
    general = normalize(torch.cat([c, (1.0 + d)[None]]), eps=1e-30)
    antiparallel = quat_from_axis_angle(any_orthonormal_vector(from_v), math.pi)
    identity = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float32, device=from_v.device)
    return torch.where(
        d > _EPS_ARC, identity, torch.where(d < -_EPS_ARC, antiparallel, general)
    )


def quat_rotate(q, v):
    """Rotate vector by quaternion (xyzw)."""
    u = q[:3]
    w = q[3]
    return v + 2.0 * cross(u, cross(u, v) + w * v)


def _rot(c, s, rows):
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    vals = {"c": c, "s": s, "-s": -s, "1": one, "0": zero}
    return torch.stack([torch.stack([vals[x] for x in row]) for row in rows])


def rot_x(a):
    return _rot(torch.cos(a), torch.sin(a), (("1", "0", "0"), ("0", "c", "-s"), ("0", "s", "c")))


def rot_y(a):
    return _rot(torch.cos(a), torch.sin(a), (("c", "0", "s"), ("0", "1", "0"), ("-s", "0", "c")))


def rot_z(a):
    return _rot(torch.cos(a), torch.sin(a), (("c", "-s", "0"), ("s", "c", "0"), ("0", "0", "1")))


def mat3_from_euler_xyz_ex(a, b, c):
    """glam ``Mat3::from_euler(EulerRot::XYZEx, a, b, c)`` =
    ``Rz(c) @ Ry(b) @ Rx(a)`` (`camera.rs:45-53`, `data.rs:122-127`)."""
    return rot_z(c) @ rot_y(b) @ rot_x(a)


def mat4_from_mat3(m):
    out = torch.zeros((4, 4), dtype=m.dtype, device=m.device)
    out[:3, :3] = m
    out[3, 3] = 1.0
    return out
