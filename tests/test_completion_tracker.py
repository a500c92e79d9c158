"""Unit tests for the session's completion tracker (render._CompletionTracker)
and its completion probe -- the machinery behind honest progress
(chunks the device has completed, not merely dispatched).
"""

import threading
import time

import jax.numpy as jnp

from cornelis.render import _CompletionTracker
from cornelis.utils.barrier import completion_probe


class TestBarrier:
    def test_completion_probe_is_scalar(self):
        p = completion_probe(jnp.ones((4, 4, 3)))
        assert p.shape == ()
        assert float(p) == 48.0


class TestCompletionTracker:
    def test_counts_reach_submitted(self):
        tr = _CompletionTracker()
        for k in range(5):
            tr.track(jnp.full((2, 2, 3), float(k)), num_samples=4)
        assert tr.wait(timeout=30.0)
        chunks, samples = tr.counts()
        assert chunks == 5 and samples == 20
        assert tr.all_done()
        tr.close()

    def test_close_stops_watcher(self):
        tr = _CompletionTracker()
        tr.track(jnp.ones((2, 2, 3)), num_samples=1)
        assert tr.wait(timeout=30.0)
        tr.close()
        tr._thread.join(timeout=10.0)
        assert not tr._thread.is_alive()

    def test_tracker_is_thread_safe_under_concurrent_tracking(self):
        tr = _CompletionTracker()

        def submit(n):
            for _ in range(n):
                tr.track(jnp.ones((2, 2, 3)), num_samples=1)

        threads = [threading.Thread(target=submit, args=(10,)) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert tr.wait(timeout=60.0)
        assert tr.counts() == (40, 40)
        tr.close()
