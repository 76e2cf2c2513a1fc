"""Social graph: friend lookup as padded adjacency (counterpart of
``hhrs_tpu/retrieval/graph.py``). External friend ids feed
``recommended_by``; serve-user indices feed the candidate masks."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class FriendGraph:
    adjacency_ext: dict  # ext user id -> np.ndarray of ext friend ids (both columns)
    adjacency_idx: dict  # ext user id -> np.ndarray of serve-user indices
    max_degree: int

    @classmethod
    def from_pairs(cls, friendships: dict, serve_user_index: dict) -> "FriendGraph":
        adj_ext: dict = {}
        for x, y in zip(friendships["user_id_1"].tolist(), friendships["user_id_2"].tolist()):
            adj_ext.setdefault(int(x), set()).add(int(y))
            adj_ext.setdefault(int(y), set()).add(int(x))
        adjacency_ext, adjacency_idx = {}, {}
        max_deg = 1
        for u, friends in adj_ext.items():
            fr = np.fromiter(friends, dtype=np.int64)
            adjacency_ext[u] = fr
            idx = np.asarray(
                [serve_user_index[f] for f in fr.tolist() if f in serve_user_index], dtype=np.int32
            )
            adjacency_idx[u] = idx
            max_deg = max(max_deg, len(idx))
        return cls(adjacency_ext=adjacency_ext, adjacency_idx=adjacency_idx, max_degree=max_deg)

    def friends_of(self, user_id: int) -> np.ndarray:
        return self.adjacency_ext.get(int(user_id), np.empty(0, np.int64))

    def friend_indices(self, user_id: int) -> np.ndarray:
        return self.adjacency_idx.get(int(user_id), np.empty(0, np.int32))

    def padded_friend_indices(self, user_id: int, pad: int, dump: int) -> np.ndarray:
        """Fixed-width friend index list, unused slots = ``dump``. Raises
        rather than truncate (dropping friends would lose their ratings)."""
        idx = self.friend_indices(user_id)
        if len(idx) > pad:
            raise ValueError(
                f"user {user_id} has {len(idx)} friends > source width {pad}; "
                f"size max_sources from graph.max_degree ({self.max_degree})"
            )
        out = np.full(pad, dump, dtype=np.int32)
        out[: len(idx)] = idx
        return out
