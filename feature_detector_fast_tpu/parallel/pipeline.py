"""Pipeline-parallel front-end over a ``pipe`` mesh axis.

SURVEY.md §2.9 maps the reference's (nonexistent) pipeline parallelism to
"detect -> describe -> match ... stages as a pipelined per-frame dataflow
across devices".  This module implements that dataflow GPipe-style as pure
SPMD: every device runs the same program under `shard_map`, selects its
stage body with `lax.switch` on its ``pipe`` axis index, and activations
rotate one stage forward per tick with `lax.ppermute` (neighbour-to-
neighbour traffic).

Stages (one device each):

  0. dense FAST detection (SumAbsolute scores) + deterministic top-K
  1. BRIEF-256 description at the keypoint slots
  2. mutual-NN/ratio matching of frame i against frame i-1 (the previous
     frame's descriptors are device-local state on the last stage — they
     never cross a device boundary)

With S stages and a stream of B frames the schedule is the classic
fill/steady/drain: B + S - 1 ticks total, all stages busy from tick S-1
on, so steady-state throughput is one frame per tick (bounded by the
slowest stage) instead of one frame per S-stage latency.  The activation
record has fixed shapes (image, keypoint slots, descriptor slots, frame
id), so the whole schedule is a single `lax.scan` — no data-dependent
control flow, one compiled program.

The image plane only rides the 0 -> 1 hop (the matcher never reads it);
keypoints/descriptors ride every hop.  Results are identical to the
sequential per-frame front-end (`models.brief.detect_and_describe` +
`models.match.match`) — asserted by tests/test_pipeline.py.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..config import NonmaxMode
from ..models import brief as brieflib
from ..models import match as matchlib
from ..models.brief import Keypoints
from ..ops import fast

PIPE_AXIS = "pipe"
N_STAGES = 3


def make_pipe_mesh(devices=None) -> Mesh:
    """1-D mesh of N_STAGES devices along the ``pipe`` axis."""
    import numpy as np

    devs = list(devices if devices is not None else jax.devices())
    if len(devs) < N_STAGES:
        raise ValueError(f"pipeline needs {N_STAGES} devices, have {len(devs)}")
    return Mesh(np.array(devs[:N_STAGES]), (PIPE_AXIS,))


class _Act(NamedTuple):
    """Fixed-shape activation record flowing through the pipe."""

    image: jax.Array     # (H, W) uint8 — consumed by stages 0 and 1
    kp_xy: jax.Array     # (K, 2) int32
    kp_score: jax.Array  # (K,) int32
    kp_valid: jax.Array  # (K,) int32 (bool as i32: ppermute/psum-friendly)
    desc: jax.Array      # (K, WORDS) uint32
    dvalid: jax.Array    # (K,) int32
    fid: jax.Array       # () int32 frame id, -1 = bubble


class FrontendStream(NamedTuple):
    """Per-frame front-end outputs for a B-frame stream (batch-leading)."""

    kp_xy: jax.Array      # (B, K, 2) int32
    kp_score: jax.Array   # (B, K) int32
    kp_valid: jax.Array   # (B, K) bool
    desc: jax.Array       # (B, K, WORDS) uint32
    dvalid: jax.Array     # (B, K) bool
    match_idx: jax.Array  # (B, K) int32: slot in frame i-1 matched by slot
    #                       of frame i (-1 = unmatched; frame 0 all -1)
    match_dist: jax.Array  # (B, K) int32 (BITS + 1 where unmatched)


def _zero_act(h: int, w: int, k: int) -> _Act:
    return _Act(
        image=jnp.zeros((h, w), jnp.uint8),
        kp_xy=jnp.zeros((k, 2), jnp.int32),
        kp_score=jnp.zeros((k,), jnp.int32),
        kp_valid=jnp.zeros((k,), jnp.int32),
        desc=jnp.zeros((k, brieflib.WORDS), jnp.uint32),
        dvalid=jnp.zeros((k,), jnp.int32),
        fid=jnp.int32(-1),
    )


@functools.partial(
    jax.jit, static_argnums=(1, 2, 3), static_argnames=("mesh", "oriented")
)
def frontend_pipelined(
    frames: jax.Array,
    threshold: int,
    count: int,
    k: int,
    *,
    mesh: Mesh,
    oriented: bool = False,
) -> FrontendStream:
    """Run the 3-stage front-end pipeline over a (B, H, W) u8 frame stream.

    Returns per-frame keypoints, descriptors, and matches of each frame
    against its predecessor, bit-identical to the sequential front-end.
    """
    b, h, w = frames.shape
    ticks = b + N_STAGES - 1

    def stage_detect(act: _Act) -> _Act:
        mask, score = fast.detect_dense(
            act.image, threshold, count, NonmaxMode.SUM_ABSOLUTE
        )
        kps = brieflib.select_topk(mask, score, k)
        return act._replace(
            kp_xy=kps.xy, kp_score=kps.score,
            kp_valid=kps.valid.astype(jnp.int32),
        )

    def stage_describe(act: _Act) -> _Act:
        kps = Keypoints(act.kp_xy, act.kp_score, act.kp_valid.astype(bool))
        fn = brieflib.describe_oriented if oriented else brieflib.describe
        desc, dvalid = fn.__wrapped__(act.image, kps)
        return act._replace(desc=desc, dvalid=dvalid.astype(jnp.int32))

    def body(all_frames):
        s = jax.lax.axis_index(PIPE_AXIS)
        fwd = [(i, i + 1) for i in range(N_STAGES - 1)]
        # Everything in the scan carry / switch outputs is device-varying
        # (each stage holds different data), so mark the initial constants
        # as varying over the pipe axis up front.
        pvary = lambda tree: jax.tree.map(
            lambda x: jax.lax.pcast(x, PIPE_AXIS, to="varying"), tree
        )

        out0 = FrontendStream(
            kp_xy=jnp.zeros((b, k, 2), jnp.int32),
            kp_score=jnp.zeros((b, k), jnp.int32),
            kp_valid=jnp.zeros((b, k), jnp.int32),
            desc=jnp.zeros((b, k, brieflib.WORDS), jnp.uint32),
            dvalid=jnp.zeros((b, k), jnp.int32),
            match_idx=jnp.zeros((b, k), jnp.int32),  # stores idx + 1
            match_dist=jnp.zeros((b, k), jnp.int32),
        )
        state0 = (
            jnp.zeros((k, brieflib.WORDS), jnp.uint32),  # prev desc
            jnp.zeros((k,), jnp.int32),                  # prev dvalid
        )

        def tick(carry, t):
            act, prev, out = carry

            # Stage 0 injects frame t (bubble once the stream is drained).
            live = t < b
            inj = act._replace(
                image=all_frames[jnp.clip(t, 0, b - 1)],
                fid=jnp.where(live, t, -1),
            )
            act = jax.tree.map(
                lambda i_, a: jnp.where(s == 0, i_, a), inj, act
            )

            # This device's stage.  Stage 2 (match) also advances its
            # device-local previous-frame descriptor state; stages 0/1
            # carry it through untouched.
            def run0(a, st):
                return stage_detect(a), st

            def run1(a, st):
                return stage_describe(a), st

            def run2(a, st):
                prev_desc, prev_dvalid = st
                # Frame 0 has no predecessor: prev_dvalid is all-False so
                # every slot is unmatched by construction.
                m = matchlib.match.__wrapped__(
                    a.desc, a.dvalid.astype(bool),
                    prev_desc, prev_dvalid.astype(bool),
                )
                return a, (a.desc, a.dvalid), m

            empty_m = pvary(matchlib.Matches(
                jnp.full((k,), -1, jnp.int32),
                jnp.full((k,), brieflib.BITS + 1, jnp.int32),
            ))
            act, prev, m = jax.lax.switch(
                s,
                [
                    lambda a, st: run0(a, st) + (empty_m,),
                    lambda a, st: run1(a, st) + (empty_m,),
                    run2,
                ],
                act, prev,
            )

            # Last stage emits: write this frame's record into the output
            # buffers (masked add — each fid slot is written exactly once,
            # non-emitting devices add zeros).
            emit = (s == N_STAGES - 1) & (act.fid >= 0)
            slot = jnp.clip(act.fid, 0, b - 1)
            g = emit.astype(jnp.int32)

            def put(buf, val):
                upd = (val.astype(buf.dtype)
                       * g.astype(buf.dtype))
                return buf.at[slot].add(upd)

            out = FrontendStream(
                kp_xy=put(out.kp_xy, act.kp_xy),
                kp_score=put(out.kp_score, act.kp_score),
                kp_valid=put(out.kp_valid, act.kp_valid),
                desc=put(out.desc, act.desc),
                dvalid=put(out.dvalid, act.dvalid),
                match_idx=put(out.match_idx, m.idx_b + 1),
                match_dist=put(out.match_dist, m.dist),
            )

            # Rotate activations one stage forward.  The image plane only
            # needs the 0 -> 1 hop; everything else rides the full chain.
            rot = jax.tree.map(
                lambda x: jax.lax.ppermute(x, PIPE_AXIS, fwd), act
            )
            rot = rot._replace(
                image=jax.lax.ppermute(act.image, PIPE_AXIS, [(0, 1)])
            )
            return (rot, prev, out), None

        (_, _, out), _ = jax.lax.scan(
            tick, pvary((_zero_act(h, w, k), state0, out0)),
            jnp.arange(ticks, dtype=jnp.int32),
        )
        # Only the last stage wrote non-zeros; psum replicates the result.
        return jax.tree.map(lambda x: jax.lax.psum(x, PIPE_AXIS), out)

    out = jax.shard_map(body, mesh=mesh, in_specs=P(), out_specs=P())(frames)
    return out._replace(
        kp_valid=out.kp_valid.astype(bool),
        dvalid=out.dvalid.astype(bool),
        match_idx=out.match_idx - 1,
    )
