"""Device-completion probes for the session's progress tracker.

JAX dispatch is asynchronous: a chunk's result array exists on the host
long before the device has computed it. The session (render.py's
_CompletionTracker) needs to learn when each chunk really finished without
blocking the thread that keeps dispatching, and without holding or moving
every chunk's full image. A completion probe is a 0-d scalar reduction of
the chunk: fetching it on a watcher thread returns exactly when the device
has produced the chunk, and the transfer is 4 bytes.
"""

from __future__ import annotations

import functools


@functools.cache
def _reducer():
    import jax
    import jax.numpy as jnp

    # One tiny executable reused for every probe; float32 accumulate so
    # uint32 images cannot overflow into an error.
    return jax.jit(lambda x: jnp.sum(x.astype(jnp.float32)))


def completion_probe(x):
    """A 0-d device scalar whose host fetch blocks until `x` is computed.

    The probe itself is dispatched asynchronously: call this right after
    dispatching `x`, hand the probe to another thread, and fetch it there
    (float(probe)) to learn when the device REALLY finished -- without
    transferring the full result.
    """
    return _reducer()(x)
