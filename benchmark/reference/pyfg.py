"""The reference's own PyFG reader (numpy only).

Reads the records the benchmark's generators write (2-D and 3-D pose and
landmark vertices, relative-pose edges, range edges) into flat arrays in
CORA's variable order: poses and landmarks in the order their vertices
appear, range measurements in file order. Any other record is refused.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np


@dataclasses.dataclass
class Graph:
    d: int
    poses: list  # names, in vertex order
    landmarks: list
    gt_R: np.ndarray  # (n, d, d)
    gt_t: np.ndarray  # (n, d)
    gt_lm: np.ndarray  # (l, d)
    e_i: np.ndarray  # relative-pose edges: from-pose index (E,)
    e_j: np.ndarray  # to-pose index (E,)
    e_R: np.ndarray  # (E, d, d)
    e_t: np.ndarray  # (E, d)
    kappa: np.ndarray  # rotation precision (E,)
    tau: np.ndarray  # translation precision (E,)
    r_a: np.ndarray  # ranges: translation index of the first variable (m,)
    r_b: np.ndarray  # translation index of the second (m,)
    r_dist: np.ndarray  # (m,)
    r_prec: np.ndarray  # (m,)

    @property
    def n(self):
        return len(self.poses)

    @property
    def l(self):  # noqa: E743 (CORA's name for the landmark count)
        return len(self.landmarks)

    @property
    def m(self):
        return len(self.r_dist)

    @property
    def size(self):
        """N = n(d + 1) + m + l rows of the stacked state."""
        return self.n * (self.d + 1) + self.m + self.l

    def totals(self) -> dict:
        return {"poses": self.n, "landmarks": self.l, "ranges": self.m,
                "N": self.size}

    def robot_of_pose(self) -> np.ndarray:
        """Each pose's robot letter, as an index into the sorted letters."""
        chars = [re.match(r"\D", s).group(0) for s in self.poses]
        letters = sorted(set(chars))
        return np.array([letters.index(c) for c in chars])


def rot2(th: float) -> np.ndarray:
    c, s = np.cos(th), np.sin(th)
    return np.array([[c, -s], [s, c]])


def rot_quat(x, y, z, w) -> np.ndarray:
    """Rotation of a unit quaternion (normalised first)."""
    q = np.array([x, y, z, w], float)
    x, y, z, w = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def upper_to_sym(vals, k: int) -> np.ndarray:
    M = np.zeros((k, k))
    M[np.triu_indices(k)] = vals
    return M + np.triu(M, 1).T


def parse(text: str) -> Graph:
    pose_idx, lm_idx = {}, {}
    gt_R, gt_t, gt_lm = [], [], []
    edges, ranges = [], []
    d = None
    for line in text.splitlines():
        tok = line.split()
        if not tok:
            continue
        tag, v = tok[0], tok
        if tag == "VERTEX_SE2":
            d = 2
            pose_idx[v[2]] = len(pose_idx)
            gt_t.append([float(v[3]), float(v[4])])
            gt_R.append(rot2(float(v[5])))
        elif tag == "VERTEX_SE3:QUAT":
            d = 3
            pose_idx[v[2]] = len(pose_idx)
            gt_t.append([float(x) for x in v[3:6]])
            gt_R.append(rot_quat(*(float(x) for x in v[6:10])))
        elif tag in ("VERTEX_XY", "VERTEX_XYZ"):
            lm_idx[v[1]] = len(lm_idx)
            gt_lm.append([float(x) for x in v[2:]])
        elif tag == "EDGE_SE2":
            t = np.array([float(v[4]), float(v[5])])
            cov = upper_to_sym([float(x) for x in v[7:13]], 3)
            edges.append((v[2], v[3], rot2(float(v[6])), t,
                          1.0 / cov[2, 2], 2.0 / np.trace(cov[:2, :2])))
        elif tag == "EDGE_SE3:QUAT":
            t = np.array([float(x) for x in v[4:7]])
            cov = upper_to_sym([float(x) for x in v[11:32]], 6)
            edges.append((v[2], v[3], rot_quat(*(float(x) for x in v[7:11])),
                          t, 1.5 / np.trace(cov[3:, 3:]),
                          3.0 / np.trace(cov[:3, :3])))
        elif tag == "EDGE_RANGE":
            ranges.append((v[2], v[3], float(v[4]), 1.0 / float(v[5])))
        else:
            raise ValueError(f"record {tag!r} is not read by the reference")
    if d is None:
        raise ValueError("no pose vertex")
    n = len(pose_idx)

    def trans(name):
        return pose_idx[name] if name in pose_idx else n + lm_idx[name]

    E = len(edges)
    return Graph(
        d=d, poses=list(pose_idx), landmarks=list(lm_idx),
        gt_R=np.array(gt_R).reshape(n, d, d), gt_t=np.array(gt_t),
        gt_lm=np.array(gt_lm).reshape(len(lm_idx), d),
        e_i=np.array([pose_idx[e[0]] for e in edges], np.int64),
        e_j=np.array([pose_idx[e[1]] for e in edges], np.int64),
        e_R=np.array([e[2] for e in edges]).reshape(E, d, d),
        e_t=np.array([e[3] for e in edges]).reshape(E, d),
        kappa=np.array([e[4] for e in edges]),
        tau=np.array([e[5] for e in edges]),
        r_a=np.array([trans(r[0]) for r in ranges], np.int64),
        r_b=np.array([trans(r[1]) for r in ranges], np.int64),
        r_dist=np.array([r[2] for r in ranges]),
        r_prec=np.array([r[3] for r in ranges]),
    )
