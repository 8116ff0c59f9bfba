"""Bytes of one segment-sum launch: the messages [.., E, F] read once, the
receiver offsets [R + 1] (int32) read once, the sums [.., R, F] written
once, whatever the kernel reads again."""

from __future__ import annotations

__all__ = ["launch_bytes"]


def launch_bytes(msgs_shape, itemsize: int, num_receivers: int) -> int:
    batch = msgs_shape[0] if len(msgs_shape) == 3 else 1
    e, f = msgs_shape[-2], msgs_shape[-1]
    return batch * e * f * itemsize + (num_receivers + 1) * 4 \
        + batch * num_receivers * f * itemsize
