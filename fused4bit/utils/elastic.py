"""Elastic step-loop: checkpoint/resume + failure retry (SURVEY §2.5/§5).

The reference has no failure story at all (single GPU, no checpointing
beyond ``state_dict``); production fleets preempt. The answer here is
not a custom RPC layer but a *resumable loop* around the existing
pytree checkpointing (`utils.checkpoint`, Orbax):

* every ``save_every`` steps the full state pytree is written to a
  step-numbered directory (last ``keep`` kept, older pruned);
* on (re)start the loop scans for the newest complete checkpoint and
  resumes from it — a preempted or crashed process relaunches with the
  same command line and continues;
* transient step failures (device unavailable, lost connections — anything
  raising from the step function) roll back to the last checkpoint and
  retry up to ``max_retries`` times before re-raising. Deterministic step
  functions thus produce the same trajectory with or without failures.

Multi-host: every process must call :func:`elastic_loop` (Orbax saves
distributed arrays collectively). The checkpoint directory must be shared
storage (GCS / NFS) in that case — and in-process retry is DISABLED
(``max_retries`` is forced to 0 when ``jax.process_count() > 1``): one
process rolling back while peers continue would pair collectives at
mismatched step counts. The multi-host failure story is
fail-fast-and-relaunch — every process dies, the job restarts, and all
processes resume together from the newest complete checkpoint (the loop's
resume path). Pruning runs on process 0 only.
"""
from __future__ import annotations

import os
import re
import shutil
from typing import Any, Callable, Optional, Tuple

from . import checkpoint as ckpt

__all__ = ["elastic_loop", "latest_step", "prune_checkpoints"]

_STEP_RE = re.compile(r"^step_(\d+)$")


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest complete checkpoint step under ``ckpt_dir`` (None if none).

    A checkpoint is complete when Orbax has renamed the temp dir to its
    final ``step_N`` name — partial writes from a crash mid-save are
    invisible here, so resume always lands on a consistent state.
    """
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(m.group(1))
        for name in os.listdir(ckpt_dir)
        if (m := _STEP_RE.match(name))
        and os.path.isdir(os.path.join(ckpt_dir, name))
    ]
    return max(steps) if steps else None


def prune_checkpoints(ckpt_dir: str, keep: int) -> None:
    """Delete all but the newest ``keep`` step directories."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(
        int(m.group(1))
        for name in os.listdir(ckpt_dir)
        if (m := _STEP_RE.match(name))
    )
    doomed = steps[:-keep] if keep > 0 else steps
    for s in doomed:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)


def elastic_loop(
    step_fn: Callable[[Any, int], Any],
    init_state: Any,
    *,
    ckpt_dir: str,
    num_steps: int,
    save_every: int = 100,
    keep: int = 2,
    max_retries: int = 3,
    shardings: Any = None,
    on_step: Optional[Callable[[int, Any], None]] = None,
) -> Tuple[Any, int]:
    """Run ``state = step_fn(state, i)`` for ``i in [0, num_steps)``,
    checkpointing + resuming + retrying around failures.

    Returns ``(final_state, resumed_from)`` where ``resumed_from`` is the
    step the loop started at (0 for a fresh run). ``init_state`` doubles as
    the restore template; pass ``shardings`` to materialize restored arrays
    onto a mesh (`utils.checkpoint.load`).
    """
    import jax

    multihost = jax.process_count() > 1
    if multihost:
        # see module docstring: per-process rollback desynchronizes
        # collectives; multi-host recovery is relaunch-and-resume.
        max_retries = 0
    os.makedirs(ckpt_dir, exist_ok=True)
    start = latest_step(ckpt_dir)
    state = init_state
    if start is not None:
        state = ckpt.load(
            os.path.join(ckpt_dir, f"step_{start}"), init_state, shardings
        )
        resumed_from = start
    else:
        start = 0
        resumed_from = 0

    retries = 0
    i = start
    while i < num_steps:
        try:
            state = step_fn(state, i)
        except Exception:
            retries += 1
            if retries > max_retries:
                raise
            # roll back to the last durable state and retry the segment
            last = latest_step(ckpt_dir)
            if last is None:
                state, i = init_state, 0
            else:
                state = ckpt.load(
                    os.path.join(ckpt_dir, f"step_{last}"),
                    init_state, shardings,
                )
                i = last
            continue
        i += 1
        if on_step is not None:
            on_step(i, state)
        if i % save_every == 0 or i == num_steps:
            ckpt.save(os.path.join(ckpt_dir, f"step_{i}"), state)
            if not multihost or jax.process_index() == 0:
                prune_checkpoints(ckpt_dir, keep)
            retries = 0
    return state, resumed_from
