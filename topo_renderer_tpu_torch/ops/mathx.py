"""glam-parity linear algebra in PyTorch.

Port of `topo_renderer_tpu/ops/mathx.py`: the reference's camera math is
built on the Rust `glam` crate (`topo-renderer/src/data/camera.rs`), with
column-vector matrices (``M @ v``), right-handed, depth range [0, 1].
Everything is float32; vectors are ``[3]`` tensors.

The camera's axes and matrices are held to the JAX camera bit for bit
where its arithmetic allows: label pixels are truncated from them, and a
last bit moves a label. ``jnp.linalg.norm`` and ``jnp.cross`` run as small
XLA-CPU programs of their own, which fuse multiply-adds; torch has no fused
multiply-add op, so `normalize` and `cross` take each fused step in float64
(the product is exact there) and round it to float32. That double rounding
differs from one fused rounding in about one case in 2^29.
"""

from __future__ import annotations

import math

import torch

_EPS_ARC = 1.0 - 2.0 * float(torch.finfo(torch.float32).eps)


def norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the (short) trailing axis, summed left to right.

    Scalar-precision trap: ``jnp.linalg.norm`` evaluated primitive by
    primitive (the frames' reference) reduces the rounded squares in float32
    in index order; a library norm may accumulate in another order or in
    double, which moves the eye radius (and with it every window origin) by
    an ulp."""
    acc = v[..., 0] * v[..., 0]
    for i in range(1, v.shape[-1]):
        acc = acc + v[..., i] * v[..., i]
    return torch.sqrt(acc)


def _fused_norm(v, axis=-1):
    """``jnp.linalg.norm(v, axis=axis, keepdims=True)`` as its own XLA-CPU
    program computes it: a chain of fused multiply-adds of the squares in
    index order along ``axis``, then a correctly rounded square root. Torch's
    float32 ``sqrt`` is not correctly rounded (on the CPU about one input in
    160 is an ulp off), so the root is taken in float64 and rounded once to
    float32, which gives the correctly rounded float32 root."""
    v = v.movedim(axis, -1)
    acc = v[..., 0] * v[..., 0]
    v64 = v.double()
    for i in range(1, v.shape[-1]):
        acc = (acc.double() + v64[..., i] * v64[..., i]).float()
    return torch.sqrt(acc.double()).float().unsqueeze(-1).movedim(-1, axis)


def normalize(v, axis=-1, eps=0.0):
    n = _fused_norm(v, axis)
    return v / torch.clamp(n, min=eps) if eps else v / n


def cross(a, b):
    """``jnp.cross`` as XLA-CPU computes it: each component one fused
    multiply-add, a_i b_j - (a_k b_l)."""
    a64, b64 = a.double(), b.double()

    def comp(i, j, k, l):
        return (a64[i] * b64[j] - (a[k] * b[l]).double()).float()

    return torch.stack([comp(1, 2, 2, 1), comp(2, 0, 0, 2), comp(0, 1, 1, 0)])


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


def look_to_rh(eye, direction, up):
    """glam `Mat4::look_to_rh`: the view matrix from the camera's forward
    direction (`camera.rs:118-120`)."""
    f = normalize(direction)
    s = normalize(cross(f, up))
    u = cross(s, f)
    zero = torch.zeros((), dtype=torch.float32, device=eye.device)
    one = torch.ones((), dtype=torch.float32, device=eye.device)
    return torch.stack(
        [
            torch.cat([s, -dot(eye, s)[None]]),
            torch.cat([u, -dot(eye, u)[None]]),
            torch.cat([-f, dot(eye, f)[None]]),
            torch.stack([zero, zero, zero, one]),
        ]
    )


def perspective_rh(fov_y, aspect, near, far):
    """glam `Mat4::perspective_rh`: right-handed, depth 0 at the near plane
    and 1 at the far plane (`camera.rs:122-128`)."""
    h = torch.cos(0.5 * fov_y) / torch.sin(0.5 * fov_y)
    w = h / aspect
    r = far / (near - far)
    zero = torch.zeros_like(h)
    one = torch.ones_like(h)
    return torch.stack(
        [
            torch.stack([w, zero, zero, zero]),
            torch.stack([zero, h, zero, zero]),
            torch.stack([zero, zero, r, r * near]),
            torch.stack([zero, zero, -one, zero]),
        ]
    )


def mat4_from_mat3(m):
    out = torch.zeros((4, 4), dtype=m.dtype, device=m.device)
    out[:3, :3] = m
    out[3, 3] = 1.0
    return out


def rows_times_mat_t(x, m):
    """``x @ m.T`` for ``x [..., K]`` (K = 3 or 4) and ``m [J, K]``, each
    sum in XLA-CPU's order for such short products: pairwise for K = 4,
    left to right for K = 3, every product rounded. A library matmul fuses
    multiply-adds and sums in another order; label pixels are truncated
    from these products, so a last bit moves a label."""
    cols = []
    for j in range(m.shape[0]):
        t = [x[..., k] * m[j, k] for k in range(x.shape[-1])]
        cols.append((t[0] + t[1]) + (t[2] + t[3]) if len(t) == 4 else (t[0] + t[1]) + t[2])
    return torch.stack(cols, dim=-1)


def mat4_mul(a, b):
    """``a @ b`` for 4x4 matrices as XLA-CPU's matrix product computes it:
    each entry a chain of fused multiply-adds over k = 0, 1, 2, 3. Torch
    has no fused multiply-add op, so each step runs in float64 (the product
    is exact there) and rounds to float32; that double rounding differs
    from one fused rounding in about one case in 2^29."""
    acc = a[:, 0:1] * b[0:1, :]
    a64, b64 = a.double(), b.double()
    for k in range(1, 4):
        acc = (acc.double() + a64[:, k : k + 1] * b64[k : k + 1, :]).float()
    return acc


def project_point3(m, p):
    """glam `Mat4::project_point3`: homogeneous transform and divide by w,
    for points ``[..., 3]`` (`render_engine.rs:352`)."""
    ph = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)
    out = rows_times_mat_t(ph, m)
    return out[..., :3] / out[..., 3:4]


def transform_vector3(m, v):
    """Apply a mat4 to a direction (w = 0), no perspective divide."""
    return rows_times_mat_t(v, m[:3, :3])
