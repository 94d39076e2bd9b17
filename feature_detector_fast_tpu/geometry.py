"""Bresenham circle geometry for the FAST detector.

The FAST detector compares each candidate center pixel against the 16 pixels
of a radius-3 Bresenham circle around it.  The point order starts at twelve
o'clock (0, -3) and proceeds clockwise; this ordering is load-bearing for the
"n consecutive" arc test and must match the reference
(`/root/reference/src/fast_simd.rs:79-98` and `src/opencv_compat.rs:42-61`).

The detectors never gather these taps: each circle point becomes a
statically shifted view of the image (cf. the reference's dual
`_mm256_i32gather_epi32`, fast_simd.rs:133-197, which is exactly what we
avoid).
"""

from __future__ import annotations

from typing import List, Tuple

#: (dx, dy) offsets of the 16 circle points, clockwise from twelve o'clock.
CIRCLE: Tuple[Tuple[int, int], ...] = (
    (0, -3),
    (1, -3),
    (2, -2),
    (3, -1),
    (3, 0),
    (3, 1),
    (2, 2),
    (1, 3),
    (0, 3),
    (-1, 3),
    (-2, 2),
    (-3, 1),
    (-3, 0),
    (-3, -1),
    (-2, -2),
    (-1, -3),
)

#: Circle radius — detection only runs where the full circle is in-bounds,
#: i.e. x in [3, W-4] and y in [3, H-4] (reference: fast_simd.rs:342,368).
RADIUS: int = 3

#: Cardinal direction indices on the circle (reference: fast_simd.rs:69-72).
NORTH: int = 0
EAST: int = 4
SOUTH: int = 8
WEST: int = 12

CIRCLE_LEN: int = len(CIRCLE)


def circle() -> Tuple[Tuple[int, int], ...]:
    """The 16-point radius-3 Bresenham circle (reference: opencv_compat.rs:42-61)."""
    return CIRCLE


def point(index: int) -> Tuple[int, int]:
    """Circle point by (wrapping) index (reference: opencv_compat.rs:64-66)."""
    return CIRCLE[index % CIRCLE_LEN]


def calculate_offsets(width: int) -> List[int]:
    """Flat row-major memory offsets of the circle points for an image of
    ``width`` (reference: fast_simd.rs:104-110).  Kept for API parity and the
    native oracle; the detectors use shifted slices instead of offsets."""
    return [dy * int(width) + dx for (dx, dy) in CIRCLE]
