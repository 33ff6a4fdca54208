"""Multi-object tracking over per-frame cluster centroids (the port's copy
of the JAX package's `track.py`, numpy; scipy optional).

Rebuilds the reference's AB3DMOT-style tracking baseline
(its toolbox/tracker.py:6-344): one constant-velocity Kalman
filter per tracklet, Mahalanobis-distance data association (greedy or
Hungarian), and hit/age-based track birth and death.  The reference keeps a
Python ``KalmanTracker`` object per track and fills the cost matrix with an
O(N*M) double loop; this rebuild keeps ALL live tracks in struct-of-arrays
form and runs every Kalman predict/update and the full cost matrix as
batched numpy einsums — the same math, one vector op per frame.

This is a host-side, eval-time component (the reference never wires it into
the training path; its tracker is standalone toolbox code).  Observations
are per-frame cluster centroids, e.g. segment means of ``inst_labels`` from
``MotionNet``'s test mode or the port's ``serve.Predictor`` output.

The reference repo ships no tracker config; the defaults here are the
AB3DMOT conventions its code comments point at (high variance on the
unobserved velocity block, identity R).
"""

from __future__ import annotations

import numpy as np

try:  # association fallback: greedy needs nothing, hungarian wants scipy
    from scipy.optimize import linear_sum_assignment
except ImportError:  # pragma: no cover
    linear_sum_assignment = None

DEFAULT_CONFIG = {
    "state_dim": 6,                # [x y z vx vy vz]; 4 -> [x y vx vy]
    "obs_dim": 3,                  # observed centroid dims
    "vx": 0.0,                     # initial velocity guess (tracker.py:34)
    "pos_uncertainty": 10.0,       # P[:obs,:obs] scale (tracker.py:50)
    "velocity_uncertainty": 1000.0,  # P[obs:,obs:] scale (tracker.py:49)
    "process_uncertainty": 0.01,   # Q[obs:,obs:] scale (tracker.py:53)
    "max_age": 3,                  # kill after N missed frames (tracker.py:148)
    "min_hits": 2,                 # confirmation threshold (tracker.py:149)
    "match_algorithm": "greedy",   # or "hungarian" (tracker.py:150)
    "mahalanobis_threshold": 11.0,  # gate on match cost (tracker.py:151)
}


def _cv_model(state_dim: int, obs_dim: int):
    """Constant-velocity F and position-observing H (tracker.py:37-47,59-66).

    Supports the reference's two layouts: (6,3) and (4,2) — and, by the same
    construction, any state_dim == 2*obs_dim.
    """
    if state_dim != 2 * obs_dim:
        raise NotImplementedError(
            f"state_dim must be 2*obs_dim, got {state_dim}, {obs_dim}")
    F = np.eye(state_dim, dtype=np.float64)
    F[:obs_dim, obs_dim:] += np.eye(obs_dim)
    H = np.zeros((obs_dim, state_dim), dtype=np.float64)
    H[:, :obs_dim] = np.eye(obs_dim)
    return F, H


class ClusterTracker:
    """Vectorized AB3DMOT-style tracking manager.

    Mirrors ``MultiClusterTrackingManager`` (tracker.py:137-344): call
    :meth:`update` once per frame with the frame's cluster centroids; it
    returns the tracks retired this frame.  Call :meth:`flush` at the end of
    a scene to retire everything still alive.
    """

    def __init__(self, config: dict | None = None):
        cfg = dict(DEFAULT_CONFIG)
        cfg.update(config or {})
        self.cfg = cfg
        self.state_dim = int(cfg["state_dim"])
        self.obs_dim = int(cfg["obs_dim"])
        self.F, self.H = _cv_model(self.state_dim, self.obs_dim)
        self.Q = np.eye(self.state_dim)
        self.Q[self.obs_dim:, self.obs_dim:] *= cfg["process_uncertainty"]
        self.R = np.eye(self.obs_dim)
        self._P0 = np.eye(self.state_dim)
        self._P0[:self.obs_dim, :self.obs_dim] *= cfg["pos_uncertainty"]
        self._P0[self.obs_dim:, self.obs_dim:] *= cfg["velocity_uncertainty"]
        self._next_id = 0
        self.clear()

    def clear(self):
        """Drop all live tracks (tracker.py:153-154). Track ids keep counting."""
        s, m = self.state_dim, 0
        self.x = np.zeros((m, s))            # [M, S] states
        self.P = np.zeros((m, s, s))         # [M, S, S] covariances
        self.ids = np.zeros(m, np.int64)
        self.hits = np.zeros(m, np.int64)
        self.hits_streak = np.zeros(m, np.int64)
        self.streak_since_init = np.zeros(m, np.int64)
        self.age = np.zeros(m, np.int64)
        self.track_lost = np.zeros(m, bool)
        self.missed = np.zeros(m, np.int64)  # frames_since_last_update
        self.history: list[list[dict]] = []  # per-track observation infos

    # ---------------------------------------------------------------- KF ---

    def _predict(self):
        """Batched KF predict over all live tracks (tracker.py:100-115)."""
        self.x = self.x @ self.F.T
        self.P = np.einsum("ij,mjk,lk->mil", self.F, self.P, self.F) + self.Q
        self.age += 1
        lost = self.missed != 0
        self.hits_streak[lost] = 0
        self.track_lost |= lost
        self.missed += 1

    def _innovation_cov(self):
        """S = H P H^T + R for every track (tracker.py:92-97)."""
        return np.einsum("ij,mjk,lk->mil", self.H, self.P, self.H) + self.R

    def _update(self, rows: np.ndarray, z: np.ndarray, S: np.ndarray):
        """Batched KF update of tracks ``rows`` with measurements ``z``."""
        P, x = self.P[rows], self.x[rows]
        K = np.einsum("mij,kj,mkl->mil", P, self.H, np.linalg.inv(S[rows]))
        innov = z - x @ self.H.T
        self.x[rows] = x + np.einsum("mij,mj->mi", K, innov)
        KH = np.einsum("mij,jk->mik", K, self.H)
        self.P[rows] = np.einsum("mij,mjk->mik",
                                 np.eye(self.state_dim) - KH, P)
        self.hits[rows] += 1
        self.hits_streak[rows] += 1
        fresh = rows[~self.track_lost[rows]]
        self.streak_since_init[fresh] += 1
        self.missed[rows] = 0

    # ------------------------------------------------------- association ---

    def _cost(self, obs: np.ndarray, S: np.ndarray):
        """Mahalanobis distance matrix, batched (tracker.py:173-196).

        obs [N, obs_dim] x predictions [M, obs_dim] -> [N, M].
        """
        preds = self.x[:, :self.obs_dim]
        diff = obs[:, None, :] - preds[None, :, :]          # [N, M, D]
        inv_S = np.linalg.inv(S)                            # [M, D, D]
        d2 = np.einsum("nmd,mde,nme->nm", diff, inv_S, diff)
        return np.sqrt(np.maximum(d2, 0.0))

    def _associate(self, cost: np.ndarray):
        """Greedy or Hungarian matching + threshold gate (tracker.py:198-258)."""
        n_obs, n_trk = cost.shape
        if n_obs * n_trk == 0:
            return (np.zeros((0, 2), np.int64),
                    np.arange(n_obs), np.arange(n_trk))

        algo = self.cfg["match_algorithm"]
        if algo == "greedy":
            order = np.argsort(cost, axis=None)
            obs_taken = np.full(n_obs, -1, np.int64)
            trk_taken = np.full(n_trk, -1, np.int64)
            for flat in order:
                i, j = divmod(int(flat), n_trk)
                if obs_taken[i] < 0 and trk_taken[j] < 0:
                    obs_taken[i] = j
                    trk_taken[j] = i
            matched_obs = np.nonzero(obs_taken >= 0)[0]
            matches = np.stack([matched_obs, obs_taken[matched_obs]], 1)
        elif algo == "hungarian":
            if linear_sum_assignment is None:  # pragma: no cover
                raise RuntimeError("hungarian matching requires scipy")
            row, col = linear_sum_assignment(cost)
            matches = np.stack([row, col], 1)
        else:
            raise NotImplementedError(algo)

        good = cost[matches[:, 0], matches[:, 1]] < self.cfg[
            "mahalanobis_threshold"]
        matches = matches[good]
        unmatched_obs = np.setdiff1d(np.arange(n_obs), matches[:, 0])
        unmatched_trk = np.setdiff1d(np.arange(n_trk), matches[:, 1])
        return matches, unmatched_obs, unmatched_trk

    # ------------------------------------------------------- birth/death ---

    def _birth(self, obs: np.ndarray, infos: list[dict]):
        """Start one track per unmatched observation (tracker.py:31-87)."""
        n = obs.shape[0]
        if n == 0:
            return
        x = np.zeros((n, self.state_dim))
        x[:, :self.obs_dim] = obs
        x[:, self.obs_dim] = self.cfg["vx"]
        self.x = np.concatenate([self.x, x])
        self.P = np.concatenate([self.P, np.broadcast_to(
            self._P0, (n, self.state_dim, self.state_dim)).copy()])
        self.ids = np.concatenate(
            [self.ids, self._next_id + np.arange(n)])
        self._next_id += n
        ones, zeros = np.ones(n, np.int64), np.zeros(n, np.int64)
        self.hits = np.concatenate([self.hits, ones])
        self.hits_streak = np.concatenate([self.hits_streak, ones])
        self.streak_since_init = np.concatenate([self.streak_since_init, ones])
        self.age = np.concatenate([self.age, zeros])
        self.track_lost = np.concatenate([self.track_lost, np.zeros(n, bool)])
        self.missed = np.concatenate([self.missed, zeros])
        self.history.extend([info] for info in infos)

    def _format(self, row: int) -> dict:
        """Retired-track record (tracker.py:158-173)."""
        hist = self.history[row]
        return {
            "tracker_id": int(self.ids[row]),
            "track_history": hist,
            "track_score": float(np.mean([h.get("score", 0.0) for h in hist])),
            "track_length": len(hist),
            "instance_ids": [h.get("instance_id") for h in hist],
            "confirmed": int(self.hits[row]) >= int(self.cfg["min_hits"]),
            "state": self.x[row].copy(),
        }

    def _reap(self, rows: np.ndarray) -> list[dict]:
        dead = [self._format(int(r)) for r in rows]
        keep = np.setdiff1d(np.arange(len(self.ids)), rows)
        self.x, self.P = self.x[keep], self.P[keep]
        self.ids, self.hits = self.ids[keep], self.hits[keep]
        self.hits_streak = self.hits_streak[keep]
        self.streak_since_init = self.streak_since_init[keep]
        self.age, self.missed = self.age[keep], self.missed[keep]
        self.track_lost = self.track_lost[keep]
        self.history = [self.history[int(k)] for k in keep]
        return dead

    # -------------------------------------------------------------- API ---

    @property
    def n_tracks(self) -> int:
        return len(self.ids)

    def update(self, obs: np.ndarray, infos: list[dict] | None = None):
        """Advance one frame (tracker.py:306-344).

        Input:
            obs:    [N, obs_dim] cluster centroids (N may be 0)
            infos:  optional N dicts (score / instance_id / frame_id ...)
        Returns:
            (dead, assigned_ids): tracks retired this frame, and the track id
            assigned to each observation (the vectorized rebuild exposes the
            per-observation ids the reference kept implicit).
        """
        obs = np.atleast_2d(np.asarray(obs, np.float64))
        if obs.size == 0:
            obs = obs.reshape(0, self.obs_dim)
        if infos is None:
            infos = [{} for _ in range(obs.shape[0])]

        self._predict()
        bad = np.nonzero(~np.isfinite(self.x).all(1))[0]
        if bad.size:  # numerically-dead trackers (tracker.py:318-329)
            self._reap(bad)

        S = self._innovation_cov()
        cost = self._cost(obs, S)
        matches, unmatched_obs, unmatched_trk = self._associate(cost)

        assigned = np.full(obs.shape[0], -1, np.int64)
        if matches.size:
            self._update(matches[:, 1], obs[matches[:, 0]], S)
            for i, j in matches:
                self.history[j].append(infos[i])
            assigned[matches[:, 0]] = self.ids[matches[:, 1]]

        first_new = self._next_id
        self._birth(obs[unmatched_obs], [infos[i] for i in unmatched_obs])
        assigned[unmatched_obs] = first_new + np.arange(len(unmatched_obs))

        dead_rows = np.nonzero(self.missed >= self.cfg["max_age"])[0]
        dead = self._reap(dead_rows) if dead_rows.size else []
        return dead, assigned

    def flush(self) -> list[dict]:
        """Retire every live track (end of scene)."""
        return self._reap(np.arange(self.n_tracks))


def centroids_from_labels(points: np.ndarray, time_idx: np.ndarray,
                          inst_labels: np.ndarray, n_frames: int):
    """Bridge from the pipeline's per-point instance labels to tracker
    observations: per-frame centroids of every instance (label >= 1;
    0 = background), e.g. directly from ``serve.Predictor`` output::

        out = predictor.predict(points, time_idx)
        obs, infos = centroids_from_labels(
            out["points"], out["time_idx"], out["inst_labels"], T)
        tracks, ids = track_scene(obs, infos)

    The reference's tracker consumes per-frame cluster centers the same
    way (toolbox/tracker.py:306-344); this helper is the explicit glue
    its pipeline leaves implicit. Returns (centroids_per_frame,
    infos_per_frame): for each frame t a [N_t, 3] array and N_t info
    dicts carrying ``frame_id`` / ``instance_id`` / ``n_points``.
    """
    points = np.asarray(points)
    time_idx = np.asarray(time_idx)
    inst_labels = np.asarray(inst_labels)
    obs, infos = [], []
    for t in range(n_frames):
        cents, inf = [], []
        sel = time_idx == t
        for k in np.unique(inst_labels[sel]):
            if k <= 0:
                continue
            m = sel & (inst_labels == k)
            cents.append(points[m].mean(0))
            inf.append({"frame_id": t, "instance_id": int(k),
                        "n_points": int(m.sum())})
        obs.append(np.asarray(cents, np.float64).reshape(-1, points.shape[1]))
        infos.append(inf)
    return obs, infos


def track_scene(centroids_per_frame, infos_per_frame=None,
                config: dict | None = None):
    """Run the tracker over a whole scene of per-frame centroid arrays.

    Returns (tracks, assigned_ids_per_frame): all retired-track records in
    retirement order, and the per-frame array of track ids assigned to each
    observation — directly usable as temporally-consistent instance ids.
    """
    tracker = ClusterTracker(config)
    tracks, assigned = [], []
    for t, obs in enumerate(centroids_per_frame):
        infos = (infos_per_frame[t] if infos_per_frame is not None
                 else [{"frame_id": t} for _ in range(len(obs))])
        dead, ids = tracker.update(obs, infos)
        tracks.extend(dead)
        assigned.append(ids)
    tracks.extend(tracker.flush())
    return tracks, assigned
