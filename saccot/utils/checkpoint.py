"""Checkpoint/resume with NumPy archives (SURVEY.md section 5).

Two checkpointable states:

1. Sweep progress: which pair shards are done + their per-pair results, so
   a lost host resumes a long dataset sweep from the last shard boundary
   (restart-from-checkpoint is the elasticity mechanism; live mesh resize
   is deliberately out of scope).
2. SLAM state: poses, landmarks, and the GN iterate, so BA resumes
   mid-solve.

Every write is `np.savez` into a temporary file beside the target and one
atomic `os.replace`, so a crash mid-write never leaves a torn checkpoint.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np


def save(path: str, state: Dict[str, Any]) -> None:
    """Save a flat dict of arrays to `path` (exact name; overwrites)."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = os.path.join(os.path.dirname(path),
                       f".tmp_{os.path.basename(path)}_{os.getpid()}")
    with open(tmp, "wb") as f:
        np.savez(f, **{k: np.asarray(v) for k, v in state.items()})
    os.replace(tmp, path)


def restore(path: str) -> Optional[Dict[str, np.ndarray]]:
    """Restore a state saved by `save`, or None if absent."""
    path = os.path.abspath(path)
    if not os.path.isfile(path):
        return None
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


class SweepCheckpointer:
    """Shard-granular progress tracking for long pairwise sweeps.

    Storage is one atomic `.npz` per shard (write-to-temp + rename) in a
    plain directory — append-only, so a crash mid-record loses at most the
    in-flight shard, and in a multi-process group a single writer (host 0)
    needs no cross-process coordination.
    """

    def __init__(self, path: Optional[str]):
        self.path = path
        self.done: Dict[int, Dict[str, np.ndarray]] = {}
        if path and os.path.isfile(path):
            # A regular file here is a pre-directory-format checkpoint (or a
            # path collision). Silently ignoring it would discard prior
            # progress and then record() would crash inside os.makedirs —
            # fail loudly instead so the caller picks a fresh path or
            # removes the stale file deliberately.
            raise ValueError(
                f"sweep checkpoint path {path!r} exists as a regular file; "
                "this checkpointer stores one .npz per shard in a directory. "
                "Remove the file or choose a different --ckpt path."
            )
        if path and os.path.isdir(path):
            for name in sorted(os.listdir(path)):
                # Temp files from a crash mid-record start with "." and are
                # ignored (and must be: a stray tmp would otherwise fail the
                # int() parse and brick every resume — the exact scenario
                # this checkpointer exists for).
                if not (name.startswith("shard_") and name.endswith(".npz")):
                    continue
                stem = name[len("shard_"):-len(".npz")]
                if not stem.isdigit():
                    continue
                with np.load(os.path.join(path, name)) as z:
                    self.done[int(stem)] = {k: z[k] for k in z.files}

    def is_done(self, shard_idx: int) -> bool:
        return shard_idx in self.done

    def record(self, shard_idx: int, results: Dict[str, np.ndarray]) -> None:
        self.done[shard_idx] = {k: np.asarray(v) for k, v in results.items()}
        if self.path:
            os.makedirs(self.path, exist_ok=True)
            final = os.path.join(self.path, f"shard_{shard_idx:06d}.npz")
            # Dot-prefixed temp name: never matches the shard_*.npz loader
            # pattern, so a crash between savez and replace cannot corrupt
            # a later resume. (np.savez appends .npz only when absent, so
            # the name is used verbatim.)
            tmp = os.path.join(self.path, f".tmp_shard_{shard_idx:06d}.npz")
            np.savez(tmp, **self.done[shard_idx])
            os.replace(tmp, final)

    def merged(self) -> Dict[str, np.ndarray]:
        """Concatenate per-shard results in shard order."""
        out: Dict[str, list] = {}
        for idx in sorted(self.done):
            for k, v in self.done[idx].items():
                out.setdefault(k, []).append(v)
        return {k: np.concatenate(v, axis=0) for k, v in out.items()}


def save_slam_state(path: str, poses, landmarks=None, gn_iter: int = 0,
                    lam=None) -> None:
    """Checkpoint SLAM state for mid-solve resume: poses, landmarks, the GN
    iterate count, and the LM damping `lam` — restoring lam is what makes a
    resumed solve follow the identical accept/reject schedule as an
    uninterrupted one (see slam/frontend.run_sequence)."""
    state = {"poses": np.asarray(poses), "gn_iter": np.asarray(gn_iter)}
    if landmarks is not None:
        state["landmarks"] = np.asarray(landmarks)
    if lam is not None:
        state["lam"] = np.asarray(lam)
    save(path, state)


def restore_slam_state(path: str):
    """Restore a SLAM checkpoint, or None."""
    return restore(path)
