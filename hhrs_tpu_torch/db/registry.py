"""sqlite3 schema, seeding and the model registry (counterpart of
``hhrs_tpu/db/registry.py``: the same five-table schema, seed rows and
``ml_models`` rows, so a database written by either package is read by the
other). ``seed_database`` reads the CSVs with the port's column tables in
place of pandas.
"""

from __future__ import annotations

import json
import logging
import os
import sqlite3
import time

from hhrs_tpu_torch.data import schema as dschema
from hhrs_tpu_torch.data.table import first_occurrence, isna, read_csv

log = logging.getLogger(__name__)

DDL = """
CREATE TABLE IF NOT EXISTS users (
    user_id INTEGER PRIMARY KEY
);
CREATE TABLE IF NOT EXISTS hotels (
    hotel_id INTEGER PRIMARY KEY,
    city TEXT,
    hotel_type TEXT,
    price_rub REAL,
    stars REAL,
    user_reviews_count REAL
);
CREATE TABLE IF NOT EXISTS reviews (
    review_id INTEGER PRIMARY KEY AUTOINCREMENT,
    user_id INTEGER NOT NULL REFERENCES users(user_id),
    hotel_id INTEGER NOT NULL REFERENCES hotels(hotel_id),
    rating_overall REAL,
    rating_location REAL,
    rating_cleanliness REAL,
    rating_food REAL,
    rating_service REAL,
    was_booked INTEGER
);
CREATE TABLE IF NOT EXISTS friendships (
    user_id_1 INTEGER NOT NULL REFERENCES users(user_id),
    user_id_2 INTEGER NOT NULL REFERENCES users(user_id),
    PRIMARY KEY (user_id_1, user_id_2)
);
"""

ML_MODELS_DDL = """
CREATE TABLE IF NOT EXISTS ml_models (
    model_id INTEGER PRIMARY KEY AUTOINCREMENT,
    version TEXT NOT NULL UNIQUE,
    created_at REAL NOT NULL,
    metrics_json TEXT,
    hyperparams_json TEXT,
    artifact_path TEXT NOT NULL,
    is_active INTEGER NOT NULL DEFAULT 0
);
"""

DDL = DDL + ML_MODELS_DDL

TABLES = ("users", "hotels", "reviews", "friendships", "ml_models")


def connect(db_path: str) -> sqlite3.Connection:
    conn = sqlite3.connect(db_path)
    conn.execute("PRAGMA foreign_keys = ON")
    return conn


def create_schema(conn: sqlite3.Connection, drop: bool = True,
                  commit: bool = True) -> None:
    cur = conn.cursor()
    if drop:
        # Children before parents, with FK enforcement off during the DDL.
        cur.execute("PRAGMA foreign_keys = OFF")
        for t in reversed(TABLES):
            cur.execute(f"DROP TABLE IF EXISTS {t}")
    # statement by statement, not executescript: executescript commits any
    # pending transaction first, so commit=False lets a caller wrap drop,
    # create and its inserts in one transaction (sqlite DDL is transactional).
    for stmt in DDL.split(";"):
        if stmt.strip():
            cur.execute(stmt)
    cur.execute("PRAGMA foreign_keys = ON")
    if commit:
        conn.commit()


def seed_database(db_path: str, data_dir: str) -> dict:
    """Idempotent drop, create and seed from the two CSVs, rolled back on an
    error → the row count of each table. users = the review and friendship
    ids, hotels = the first review row of each hotel id, friendships =
    sorted unique pairs without self-pairs (the reference's seeding)."""
    reviews = read_csv(os.path.join(data_dir, "hackathon_augmented_data.csv"))
    friends = read_csv(os.path.join(data_dir, "friendships.csv"))
    users = reviews[dschema.RAW_USER_COL].astype(int).tolist()
    hotels = reviews[dschema.RAW_ITEM_COL].astype(int).tolist()

    def _text(v):  # a NaN cell is SQL NULL
        return None if isna(v) else str(v)

    def _col(name, cast):
        return [cast(v) for v in reviews[name].tolist()]

    # Convert every row before the destructive drop: a malformed CSV fails
    # here, while the previously seeded tables are intact.
    user_rows = [(u,) for u in sorted(set(users) | set(friends["user_id_1"].astype(int).tolist())
                                      | set(friends["user_id_2"].astype(int).tolist()))]
    city, htype = _col("city", _text), _col("hotel_type", _text)
    price, stars, count = _col("price_rub", float), _col("stars", float), _col("user_reviews_count", float)
    hotel_rows = [(hotels[r], city[r], htype[r], price[r], stars[r], count[r])
                  for r in first_occurrence(reviews[dschema.RAW_ITEM_COL]).tolist()]
    ratings = [_col(c, float) for c in ("rating_overall", "rating_location", "rating_cleanliness",
                                         "rating_food", "rating_service")]
    review_rows = list(zip(users, hotels, *ratings, _col(dschema.TARGET_COL, int)))
    pairs = sorted({
        (min(int(a), int(b)), max(int(a), int(b)))
        for a, b in zip(friends["user_id_1"].tolist(), friends["user_id_2"].tolist())
        if int(a) != int(b)
    })

    conn = connect(db_path)
    try:
        conn.execute("BEGIN")
        create_schema(conn, drop=True, commit=False)
        cur = conn.cursor()
        cur.executemany("INSERT INTO users (user_id) VALUES (?)", user_rows)
        cur.executemany("INSERT INTO hotels VALUES (?,?,?,?,?,?)", hotel_rows)
        cur.executemany(
            "INSERT INTO reviews (user_id, hotel_id, rating_overall, rating_location,"
            " rating_cleanliness, rating_food, rating_service, was_booked)"
            " VALUES (?,?,?,?,?,?,?,?)",
            review_rows,
        )
        cur.executemany("INSERT INTO friendships VALUES (?,?)", pairs)
        conn.commit()
        counts = {t: cur.execute(f"SELECT COUNT(*) FROM {t}").fetchone()[0] for t in TABLES}
        log.info("seeded %s: %s", db_path, counts)
        return counts
    except Exception:
        conn.rollback()
        raise
    finally:
        conn.close()


def _auto_version(cur) -> str:
    """Collision-free auto version: 'v<max_id+1>', bumped past any version
    string an explicit registration already took (an explicit 'v2' mixed
    with auto-numbering must not hit the UNIQUE constraint)."""
    nxt = cur.execute(
        "SELECT COALESCE(MAX(model_id), 0) + 1 FROM ml_models"
    ).fetchone()[0]
    taken = {r[0] for r in cur.execute("SELECT version FROM ml_models")}
    version = f"v{nxt}"
    while version in taken:
        nxt += 1
        version = f"v{nxt}"
    return version


def _insert_model(cur, version, artifact_path, metrics, hyperparams,
                  active: bool) -> int:
    """The ONE insert path register() and promote_if_better() share (two
    inline copies drifted before)."""
    if version is None:
        version = _auto_version(cur)
    if active:
        cur.execute("UPDATE ml_models SET is_active = 0")
    cur.execute(
        "INSERT INTO ml_models (version, created_at, metrics_json,"
        " hyperparams_json, artifact_path, is_active) VALUES (?,?,?,?,?,?)",
        (
            version, time.time(), json.dumps(metrics or {}),
            json.dumps(hyperparams or {}), os.path.abspath(artifact_path),
            1 if active else 0,
        ),
    )
    return cur.lastrowid


class ModelRegistry:
    """The ml_models registry: register, promote, activate, and read the
    active model."""

    def __init__(self, db_path: str, create: bool = False):
        """``create=False`` (the serving/resolve default) refuses to invent
        an empty database for a missing path — a typo'd registry:<db> spec
        must say 'no such file', not 'no active model' (and must not leave
        junk db files behind). Registration paths pass create=True."""
        if not create and not os.path.exists(db_path):
            raise FileNotFoundError(f"registry database not found: {db_path}")
        self.db_path = db_path
        conn = connect(db_path)
        have = {
            r[0]
            for r in conn.execute(
                "SELECT name FROM sqlite_master WHERE type='table'"
            ).fetchall()
        }
        if "ml_models" not in have:
            conn.executescript(ML_MODELS_DDL)
            conn.commit()
        conn.close()

    def register(
        self,
        version: str | None,
        artifact_path: str,
        metrics: dict | None = None,
        hyperparams: dict | None = None,
        activate: bool = True,
    ) -> int:
        """``version=None`` auto-numbers (v<max_id+1>, bumped past taken
        version strings); explicit duplicates violate the UNIQUE constraint
        the reference schema declares (database_setup.py:58)."""
        conn = connect(self.db_path)
        try:
            # one transaction: the auto-version read and the insert must be
            # atomic or two concurrent registers race to the same version
            conn.execute("BEGIN IMMEDIATE")
            cur = conn.cursor()
            rowid = _insert_model(cur, version, artifact_path, metrics,
                                  hyperparams, activate)
            conn.commit()
            return rowid
        except Exception:
            conn.rollback()
            raise
        finally:
            conn.close()

    def promote_if_better(
        self,
        version: str | None,
        artifact_path: str,
        metrics: dict,
        hyperparams: dict | None = None,
        metric: str = "val_logloss",
        direction: str = "auto",
        incumbent_value: float | None = None,
    ) -> tuple[int, bool, str]:
        """Register a candidate and activate it ONLY if it beats the active
        model on ``metric`` — the gate a retraining pipeline puts between
        train and serve (the hot-reload poller then picks the winner up,
        serve/reload.py). Losing candidates are still registered
        (is_active=0) so the full history stays queryable, matching the
        registry design the reference documents but never wires
        (reference database_setup.py:54-64, Documentation.md:256-271).

        ``direction``: 'min' | 'max' | 'auto' (auto infers from the metric
        name: auc/recall/precision maximize, losses/errors minimize).
        Comparison and insert run in ONE immediate transaction so two
        concurrent promotes serialize. Returns (model_id, promoted, reason).

        COMPARABILITY: by default the candidate's stored metric (its own
        validation split) is compared against the incumbent's stored metric
        (a DIFFERENT dataset/split) — fine when the data distribution is
        stable, misleading when it shifts. For an apples-to-apples gate,
        re-score both models on one fixed dataset and pass the incumbent's
        re-scored number as ``incumbent_value`` (db/cli promote
        --eval-data does exactly this via train/evaluate.py).

        The candidate's artifact dir must not be the ACTIVE model's dir:
        a rejected candidate exported over the incumbent's directory has
        already clobbered the weights the registry points at (the next
        serve reload would silently serve the loser) — raises ValueError;
        export every candidate to its own directory.
        """
        if direction == "auto":
            lname = metric.lower()
            maximize = any(t in lname for t in ("auc", "recall", "precision", "ndcg"))
        elif direction in ("min", "max"):
            maximize = direction == "max"
        else:
            raise ValueError(f"direction must be min|max|auto, got {direction!r}")
        if metric not in metrics:
            raise KeyError(f"candidate metrics have no {metric!r}: {sorted(metrics)}")
        cand = float(metrics[metric])

        conn = connect(self.db_path)
        try:
            conn.execute("BEGIN IMMEDIATE")
            cur = conn.cursor()
            row = cur.execute(
                "SELECT model_id, metrics_json, artifact_path FROM ml_models"
                " WHERE is_active = 1 ORDER BY created_at DESC LIMIT 1"
            ).fetchone()
            if row is not None and os.path.abspath(artifact_path) == row[2]:
                raise ValueError(
                    f"candidate artifact dir {artifact_path!r} IS the active "
                    f"model {row[0]}'s dir — its weights are already "
                    "overwritten; export each candidate to its own directory"
                )
            if row is None:
                promote, reason = True, "no active model"
            else:
                active_metrics = json.loads(row[1] or "{}")
                if incumbent_value is not None:
                    incumbent = float(incumbent_value)
                    promote = cand > incumbent if maximize else cand < incumbent
                    cmp = ">" if maximize else "<"
                    reason = (
                        f"re-scored gate: candidate {metric}={cand:.6g} "
                        f"{'' if promote else 'not '}{cmp} incumbent "
                        f"{incumbent:.6g}"
                        + ("" if promote else f" (model {row[0]} stays active)")
                    )
                elif metric not in active_metrics:
                    promote = True
                    reason = f"active model {row[0]} has no {metric!r}"
                else:
                    incumbent = float(active_metrics[metric])
                    promote = cand > incumbent if maximize else cand < incumbent
                    cmp = ">" if maximize else "<"
                    reason = (
                        f"candidate {metric}={cand:.6g} {cmp} incumbent "
                        f"{incumbent:.6g}" if promote else
                        f"candidate {metric}={cand:.6g} not {cmp} incumbent "
                        f"{incumbent:.6g} (model {row[0]} stays active)"
                    )
            rowid = _insert_model(cur, version, artifact_path, metrics,
                                   hyperparams, promote)
            conn.commit()
            return rowid, promote, reason
        except Exception:
            conn.rollback()
            raise
        finally:
            conn.close()

    def active(self) -> dict | None:
        conn = connect(self.db_path)
        try:
            row = conn.execute(
                "SELECT model_id, version, created_at, metrics_json, hyperparams_json,"
                " artifact_path FROM ml_models WHERE is_active = 1"
                " ORDER BY created_at DESC LIMIT 1"
            ).fetchone()
        finally:
            conn.close()
        if row is None:
            return None
        return {
            "model_id": row[0],
            "version": row[1],
            "created_at": row[2],
            "metrics": json.loads(row[3] or "{}"),
            "hyperparams": json.loads(row[4] or "{}"),
            "artifact_path": row[5],
        }

    def activate(self, model_id: int) -> None:
        conn = connect(self.db_path)
        try:
            cur = conn.cursor()
            cur.execute("UPDATE ml_models SET is_active = 0")
            n = cur.execute(
                "UPDATE ml_models SET is_active = 1 WHERE model_id = ?", (model_id,)
            ).rowcount
            if n == 0:
                raise KeyError(f"model_id {model_id} not found")
            conn.commit()
        finally:
            conn.close()

    def list(self) -> list[dict]:
        conn = connect(self.db_path)
        try:
            rows = conn.execute(
                "SELECT model_id, version, created_at, metrics_json, artifact_path,"
                " is_active FROM ml_models ORDER BY created_at"
            ).fetchall()
        finally:
            conn.close()
        return [
            {
                "model_id": r[0], "version": r[1], "created_at": r[2],
                "metrics": json.loads(r[3] or "{}"), "artifact_path": r[4],
                "is_active": bool(r[5]),
            }
            for r in rows
        ]


def resolve_artifacts_dir(spec: str) -> str:
    """Resolve 'registry:<db_path>' to the active model's artifact dir;
    anything else passes through as a plain directory path."""
    if spec.startswith("registry:"):
        reg = ModelRegistry(spec[len("registry:"):])
        active = reg.active()
        if active is None:
            raise FileNotFoundError("no active model in registry")
        return active["artifact_path"]
    return spec
