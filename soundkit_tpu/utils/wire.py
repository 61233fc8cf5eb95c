"""Host->device and device->host wire-transfer helpers.

Packed wire buffers and batched outputs move between host and device
in chunks of at most ``WIRE_CHUNK_BYTES`` (h2d) and ``D2H_CHUNK_BYTES``
(d2h) and are re-assembled on the other side: one device-side
concatenate for h2d, one host concatenate for d2h.  The chunk sizes
were chosen for a host link with a large-transfer bandwidth cliff;
whether chunking still pays over a local PCIe link is an open
measurement (ROADMAP design debt 3), so both are settable by
environment variable.

Role-equivalent of the reference's rtrb byte plumbing between pipeline
stages (soundkit-decoder/src/lib.rs:851-869) — the host->device feed
is our thread boundary.
"""
from __future__ import annotations

import os

import numpy as np

WIRE_CHUNK_BYTES = int(os.environ.get("SKT_WIRE_CHUNK_BYTES", 3_500_000))
D2H_CHUNK_BYTES = int(os.environ.get("SKT_D2H_CHUNK_BYTES", 1_000_000))


def to_device_chunked(buf: np.ndarray, chunk_bytes: int | None = None):
    """Transfer a 1-D uint8 wire buffer in chunks.

    Returns a single device array equal to ``jnp.asarray(buf)``.  Each
    chunk dispatches as its own async transfer; the device-side
    concatenate is local to device memory.
    """
    import jax.numpy as jnp

    chunk = chunk_bytes or WIRE_CHUNK_BYTES
    n = buf.shape[0]
    if n <= chunk:
        return jnp.asarray(buf)
    k = -(-n // chunk)  # ceil
    # equal-sized chunks keep every transfer the same shape
    step = -(-n // k)
    parts = [jnp.asarray(buf[i : i + step]) for i in range(0, n, step)]
    return jnp.concatenate(parts)


def from_device_chunked(arr, chunk_bytes: int | None = None) -> np.ndarray:
    """Fetch a device array in chunks along axis 0.

    Batched outputs ([B, ...] lanes) are sliced into lane-chunks of at
    most ``D2H_CHUNK_BYTES`` and fetched as separate transfers.
    """
    chunk = chunk_bytes or D2H_CHUNK_BYTES
    total = int(np.prod(arr.shape)) * arr.dtype.itemsize
    if total <= chunk or arr.shape[0] <= 1:
        return np.asarray(arr)
    per_row = max(total // arr.shape[0], 1)
    step = max(chunk // per_row, 1)
    parts = [
        np.asarray(arr[i : i + step]) for i in range(0, arr.shape[0], step)
    ]
    return np.concatenate(parts, axis=0)
