"""Multi-device scaling-efficiency benchmark (BASELINE.json config[4]).

Measures batched front-end throughput at 1, 2, 4, ... N devices by
sharding a frame batch over the `data` mesh axis, and reports scaling
efficiency (throughput_N / (N * throughput_1)).  The target in
BASELINE.md is >= 80% at N >= 2.

On a host with several GPUs this measures NVLink-attached cards; the
structure can be exercised on the spoofed CPU mesh:

    JAX_PLATFORMS=cpu python tools/scaling_bench.py   # structural check
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, ".")

if "--cpu" in sys.argv:
    # must run before any jax backend use
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()


def main() -> int:
    import jax

    if "--cpu" in sys.argv:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from feature_detector_fast_tpu.config import NonmaxMode
    from feature_detector_fast_tpu.parallel import frontend, mesh as meshlib

    n_total = len(jax.devices())
    frame = np.random.default_rng(0).integers(0, 256, (256, 512), np.uint8)

    results = {}
    n = 1
    while n <= n_total:
        mesh = meshlib.make_mesh(n_data=n, devices=jax.devices()[:n])
        batch = np.broadcast_to(frame, (4 * n,) + frame.shape).copy()
        imgs = jax.device_put(
            jnp.asarray(batch), NamedSharding(mesh, P(meshlib.DATA_AXIS)))
        jax.block_until_ready(imgs)

        run = lambda: frontend.detect_batch_sharded(
            imgs, 16, 9, NonmaxMode.MAX_THRESHOLD, mesh=mesh)
        jax.block_until_ready(run())
        rounds = 10
        t0 = time.perf_counter()
        outs = [run() for _ in range(rounds)]
        jax.block_until_ready(outs)
        dt = time.perf_counter() - t0
        fps = rounds * batch.shape[0] / dt
        results[n] = fps
        eff = fps / (n * results[1])
        rec = {
            "devices": n,
            "frames_per_s": round(fps, 1),
            "scaling_efficiency": round(eff, 3),
        }
        if jax.devices()[0].platform == "cpu":
            # spoofed host devices share the same physical cores: this
            # validates sharding structure, not real scaling
            rec["note"] = "cpu-mesh structural check only"
        print(json.dumps(rec))
        n *= 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
