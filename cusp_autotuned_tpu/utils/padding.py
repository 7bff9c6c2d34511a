"""Alignment padding helpers.

The reference aligns ELL/DIA pitch to 32 (cusp/ell_matrix.h:165-169); the
containers here pad their major data axes to a multiple of LANE = 128 by
default, which keeps shapes static and aligned for every kernel.
"""

import numpy as np

LANE = 128


def round_up(x: int, m: int) -> int:
    return ((int(x) + m - 1) // m) * m


def pad_to(arr, n: int, fill=0):
    """Pad 1-D numpy array to length n with `fill`."""
    arr = np.asarray(arr)
    if arr.shape[0] == n:
        return arr
    if arr.shape[0] > n:
        raise ValueError(f"cannot pad length {arr.shape[0]} down to {n}")
    out = np.full((n,) + arr.shape[1:], fill, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def pad_axis_to(arr, axis: int, n: int, fill=0):
    """Pad numpy array along `axis` to size n with `fill`."""
    arr = np.asarray(arr)
    cur = arr.shape[axis]
    if cur == n:
        return arr
    if cur > n:
        raise ValueError(f"cannot pad axis {axis} of size {cur} down to {n}")
    shape = list(arr.shape)
    shape[axis] = n
    out = np.full(shape, fill, dtype=arr.dtype)
    sl = [slice(None)] * arr.ndim
    sl[axis] = slice(0, cur)
    out[tuple(sl)] = arr
    return out
