"""Checkpoint / resume for long staircase solves.

The reference has no checkpointing; the JAX package snapshots the
staircase between rank levels (`cora_tpu/solve/checkpoint.py`), and this
module writes and reads the same file, so a checkpoint written by either
package resumes in the other:

  * the current iterate Y (and its rank),
  * the ranks visited so far,
  * the certification eigenvector block (the warm start of the next
    LOBPCG),
  * a fingerprint of the factor graph (a checkpoint of another problem is
    refused).

Format: one .npz, written to a temporary file beside the target and
renamed over it, so a reader never sees a partial file and nothing else is
left in the directory.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import tempfile

import numpy as np


def problem_fingerprint(problem) -> str:
    """Cheap content hash of the factor graph (sizes + measurement sums)."""
    h = hashlib.sha256()
    h.update(
        f"{problem.dim}|{problem.num_poses}|{problem.num_landmarks}|"
        f"{problem.num_range_measurements}|{problem.num_pose_pose_measurements}"
        .encode()
    )
    if problem.range_measurements:
        rs = np.asarray([m.r for m in problem.range_measurements])
        h.update(rs.tobytes())
    if problem.rel_pose_measurements:
        ts = np.asarray([m.t for m in problem.rel_pose_measurements])
        h.update(ts.tobytes())
    return h.hexdigest()[:16]


@dataclasses.dataclass
class StaircaseCheckpoint:
    Y: np.ndarray
    rank: int
    ranks_visited: list
    eigvec_bootstrap: np.ndarray | None
    fingerprint: str
    stage: str = "staircase"  # staircase | refine

    def save(self, path: str) -> None:
        payload = {
            "Y": self.Y,
            "rank": np.asarray(self.rank),
            "ranks_visited": np.asarray(self.ranks_visited, dtype=np.int64),
            "fingerprint": np.frombuffer(self.fingerprint.encode(),
                                         dtype=np.uint8),
            "stage": np.frombuffer(self.stage.encode(), dtype=np.uint8),
        }
        if self.eigvec_bootstrap is not None:
            payload["eigvec_bootstrap"] = self.eigvec_bootstrap
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(os.path.abspath(path)),
            prefix=f".{os.path.basename(path)}.", suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as fh:
                np.savez(fh, **payload)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    @classmethod
    def load(cls, path: str) -> "StaircaseCheckpoint":
        with np.load(path, allow_pickle=False) as z:
            return cls(
                Y=z["Y"],
                rank=int(z["rank"]),
                ranks_visited=[int(r) for r in z["ranks_visited"]],
                eigvec_bootstrap=(z["eigvec_bootstrap"]
                                  if "eigvec_bootstrap" in z else None),
                fingerprint=bytes(z["fingerprint"]).decode(),
                stage=bytes(z["stage"]).decode(),
            )


def maybe_resume(problem, path: str | None):
    """The checkpoint at `path` if it exists; raises ValueError if it
    belongs to another problem."""
    if not path or not os.path.exists(path):
        return None
    ckpt = StaircaseCheckpoint.load(path)
    if ckpt.fingerprint != problem_fingerprint(problem):
        raise ValueError(
            f"checkpoint {path} belongs to a different problem "
            f"({ckpt.fingerprint} != {problem_fingerprint(problem)})")
    return ckpt
