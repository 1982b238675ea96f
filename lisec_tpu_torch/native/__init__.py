"""Host-side helpers: the velodyne reader, the padding of a cloud to its
budget, the range crop and the geometry of the detection augmentation
(port of ``lisec_tpu/native/__init__.py``: ``read_velodyne``,
``pad_points``, ``crop_range``, ``transform_cloud``, ``flip_y``,
``points_in_rbbox_first`` and ``perturb_boxes``).

The JAX package runs these in its C++ library
(``lisec_tpu/native/src/lisec_native.cc``) when it loads, else in a
numpy fallback, and the two do not round alike: the fallback's matmul
sums in another order, and numpy's f32 ``cos``/``sin`` differ from the C
library's in the last bit for about one angle in six. Here the helpers
are numpy f32 elementwise code in the library's order of operations,
and every angle's cosine and sine come from the C math library's own
``sincosf`` (what the compiled library calls), one call per box. So they
give the library's answer bit for bit, with no second route.

The reader, the padding and the crop are plain numpy with the library's
contracts (its whole-record reads, its cap, its in-place compaction).
The geometry helpers work in place and, like the library's, refuse an
array of the wrong dtype or one that is not C-contiguous.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np

_HALF = np.float32(0.5)


@functools.lru_cache(maxsize=None)
def _sincosf():
    """The C math library's ``sincosf``, bound at first use."""
    f = ctypes.CDLL("libm.so.6").sincosf
    f.restype = None
    f.argtypes = [ctypes.c_float, ctypes.POINTER(ctypes.c_float),
                  ctypes.POINTER(ctypes.c_float)]
    return f


def _cos_sin(angle) -> Tuple[np.float32, np.float32]:
    """The C library's f32 cosine and sine of ``angle`` (rounded to f32)."""
    s, c = ctypes.c_float(), ctypes.c_float()
    _sincosf()(float(np.float32(angle)), ctypes.byref(s), ctypes.byref(c))
    return np.float32(c.value), np.float32(s.value)


def _check_inplace(a: np.ndarray, dtype, name: str) -> None:
    """The library writes through raw pointers, so it refuses a wrong
    dtype or a non-contiguous (sliced) array; these copies keep that
    contract."""
    if a.dtype != dtype:
        raise TypeError(f"{name}: expected {np.dtype(dtype).name} array, "
                        f"got {a.dtype.name}")
    if not a.flags.c_contiguous:
        raise ValueError(f"{name}: array must be C-contiguous "
                         "(pass a copy, not a slice/view)")


def read_velodyne(path: str, max_points: int = 300_000) -> np.ndarray:
    """(N, 4) float32 x, y, z, intensity of a KITTI velodyne ``.bin``:
    whole 16-byte points only, at most ``max_points`` of them, a
    trailing partial record dropped. Raises ``IOError`` when the file
    cannot be opened."""
    try:
        with open(path, "rb") as f:
            raw = np.fromfile(f, np.float32, count=4 * max_points)
    except OSError as e:
        raise IOError(f"cannot read {path!r}") from e
    return raw[:raw.size - raw.size % 4].reshape(-1, 4)


def pad_points(cloud: np.ndarray, max_points: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(cloud (N, C)) -> the first ``max_points`` rows as float32, zero
    padded to (max_points, C), and the (max_points,) bool mask of the
    rows that hold points."""
    cloud = np.ascontiguousarray(cloud, np.float32)
    keep = min(len(cloud), max_points)
    out = np.zeros((max_points, cloud.shape[1]), np.float32)
    out[:keep] = cloud[:keep]
    mask = np.zeros(max_points, bool)
    mask[:keep] = True
    return out, mask


def crop_range(points: np.ndarray, lo, hi) -> np.ndarray:
    """The rows of ``points`` whose xyz lie in ``[lo, hi)`` (f32
    compares; a NaN coordinate is outside), in order. As in the library,
    the rows are compacted to the front of a float32 C-contiguous copy
    of ``points`` and that copy's head is returned: where ``points``
    already is float32 and C-contiguous the copy is ``points`` itself,
    so the caller's buffer changes (its rows past the result keep their
    old values)."""
    pts = np.ascontiguousarray(points, np.float32)
    lo = np.ascontiguousarray(lo, np.float32)[:3]
    hi = np.ascontiguousarray(hi, np.float32)[:3]
    xyz = pts[:, :3]
    inside = np.all((xyz >= lo) & (xyz < hi), axis=1)
    n = int(inside.sum())
    pts[:n] = pts[inside]
    return pts[:n]


def transform_cloud(points: np.ndarray, rotation: np.ndarray,
                    scale: float, translation: np.ndarray) -> None:
    """In-place xyz <- R @ xyz * scale + t. points: (N, C) float32."""
    _check_inplace(points, np.float32, "transform_cloud")
    r = np.ascontiguousarray(rotation, np.float32).reshape(9)
    t = np.ascontiguousarray(translation, np.float32)
    s = np.float32(scale)
    x, y, z = (points[:, k].copy() for k in range(3))
    for k in range(3):
        points[:, k] = (r[3 * k] * x + r[3 * k + 1] * y
                        + r[3 * k + 2] * z) * s + t[k]


def flip_y(points: np.ndarray) -> None:
    """In-place flip over the x-z plane (y -> -y)."""
    _check_inplace(points, np.float32, "flip_y")
    points[:, 1] = -points[:, 1]


def points_in_rbbox_first(points: np.ndarray,
                          boxes: np.ndarray) -> np.ndarray:
    """(N,) int32: 1-based index of the first containing box, 0 = none.
    Boxes are (B, 7) ``(x, y, z, l, w, h, yaw)``; a point on a face is
    inside."""
    _check_inplace(points, np.float32, "points_in_rbbox_first")
    out = np.zeros(len(points), np.int32)
    bx = np.ascontiguousarray(boxes, np.float32).reshape(-1, 7)
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    for j, b in enumerate(bx):
        c, s = _cos_sin(b[6])
        dx, dy, dz = x - b[0], y - b[1], z - b[2]
        lx = dx * c + dy * s
        ly = -dx * s + dy * c
        # The library rejects on ``>``, so a NaN coordinate passes.
        outside = ((np.abs(dz) > b[5] * _HALF) | (np.abs(lx) > b[3] * _HALF)
                   | (np.abs(ly) > b[4] * _HALF))
        out[~outside & (out == 0)] = j + 1
    return out


def perturb_boxes(points: np.ndarray, member: np.ndarray,
                  centers: np.ndarray, dyaw: np.ndarray,
                  dtrans: np.ndarray) -> None:
    """In place: each point whose ``member`` (1-based, from
    ``points_in_rbbox_first``) names box j turns by ``dyaw[j]`` about
    that box's centre and moves by ``dtrans[j]``."""
    _check_inplace(points, np.float32, "perturb_boxes")
    _check_inplace(member, np.int32, "perturb_boxes(member)")
    ctr = np.ascontiguousarray(centers, np.float32).reshape(-1, 3)
    dt = np.ascontiguousarray(dtrans, np.float32).reshape(-1, 3)
    cos_sin = np.array([_cos_sin(a) for a in np.asarray(dyaw, np.float32)],
                       np.float32).reshape(-1, 2)
    # Every member point at once, each with its own box's terms: the
    # same f32 operations, in the library's order, as a loop over points.
    i = np.flatnonzero((member > 0) & (member <= len(ctr)))
    j = member[i] - 1
    c, s, ctr, dt = cos_sin[j, 0], cos_sin[j, 1], ctr[j], dt[j]
    dx = points[i, 0] - ctr[:, 0]
    dy = points[i, 1] - ctr[:, 1]
    points[i, 0] = ctr[:, 0] + dx * c - dy * s + dt[:, 0]
    points[i, 1] = ctr[:, 1] + dx * s + dy * c + dt[:, 1]
    points[i, 2] = points[i, 2] + dt[:, 2]
