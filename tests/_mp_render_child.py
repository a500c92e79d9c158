"""Child process for tests/test_multiprocess.py: one rank of an N-process
CPU render.

Usage: python _mp_render_child.py <rank> <port> <out.npy> <repo> <mode> \
           <num_procs> <devs_per_proc>

Each rank initializes jax.distributed, joins a global
(num_procs * devs_per_proc / samples, samples) mesh over the virtual CPU
devices, renders the same small Cornell frame through the REAL
RenderSession (exercising render.py's globally-sharded film drain, i.e.
the process_allgather path), and rank 0 writes the linear image to
<out.npy>. The parent compares it against a single-process render -- the
multi-host analog of the reference actually rendering on its TBB pool
(src/Render.cpp:335-354), not just initializing it. mode "pallas" runs
the mesh MEGAKERNEL (render_chunk_mesh_pallas in interpret mode) so the
(tiles, samples) collective topology is proven across process boundaries
on the Pallas path too.
"""

import sys

sys.path.insert(0, sys.argv[4] if len(sys.argv) > 4 else ".")

import jax

jax.config.update("jax_platforms", "cpu")

process_id = int(sys.argv[1])
port = sys.argv[2]
out_path = sys.argv[3]
mode = sys.argv[5] if len(sys.argv) > 5 else "plain"
num_procs = int(sys.argv[6]) if len(sys.argv) > 6 else 2
devs_per_proc = int(sys.argv[7]) if len(sys.argv) > 7 else 2
n_tiles = int(sys.argv[8]) if len(sys.argv) > 8 else 4
n_samp = int(sys.argv[9]) if len(sys.argv) > 9 else 1

jax.distributed.initialize(
    coordinator_address=f"localhost:{port}",
    num_processes=num_procs,
    process_id=process_id,
)
assert jax.process_count() == num_procs, jax.process_count()
assert jax.device_count() == num_procs * devs_per_proc, jax.device_count()

import numpy as np

from cornelis.options import RenderOptions
from cornelis.render import RenderSession, RenderStatus
from cornelis.scene.library import cornell_box

assert n_tiles * n_samp == num_procs * devs_per_proc
kw = dict(
    width=64,
    height=64,
    samples_aa=4,
    spp_chunk=2,
    max_depth=8,
    mesh_shape=(n_tiles, n_samp),
    backend="xla",
    output=None,
)
if mode in ("pallas", "plain4"):
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices("cornelis-mp-test-start")
if mode == "pallas":
    # Smaller frame + one chunk: interpret-mode megakernel execution on an
    # oversubscribed CPU must keep rank skew under gloo's 30 s context-
    # init deadline. The sync above aligns the ranks first.
    from cornelis.parallel import make_mesh, render_chunk_mesh_pallas
    from cornelis.rng import make_key
    from cornelis.scene.compile import compile_scene

    img = render_chunk_mesh_pallas(
        compile_scene(cornell_box()), make_key(), np.uint32(0),
        mesh=make_mesh((n_tiles, n_samp)), width=32, height=32, spp_chunk=2,
        spp_total=2, max_depth=6, interpret=True,
    )
    img = np.asarray(multihost_utils.process_allgather(img, tiled=True)) / 2
    if process_id == 0:
        np.save(out_path, img)
    print(f"[rank {process_id}] ok mean={float(img.mean()):.6f}", flush=True)
    sys.exit(0)
if mode == "budget":
    # Exercises the rank-agreed time-budget break and the rank-0-only
    # checkpoint write (divergent local clocks must not deadlock the
    # collectives -- render.py `agree`).
    kw.update(time_budget_s=0.001, checkpoint=out_path + f".ck.npz")
result = RenderSession(cornell_box(), RenderOptions(**kw)).render()
assert result.status == RenderStatus.DONE, result.status
if mode == "budget":
    assert result.film.sample_count >= 2  # at least the first chunk landed

if process_id == 0:
    np.save(out_path, result.image)
print(f"[rank {process_id}] ok mean={float(result.image.mean()):.6f}", flush=True)
