"""Plain reference of one served recommendation, and the comparison that
judges the program's answers against it. numpy and plain PyTorch, no code
of the program.

A request (user, city, ``friends``, λ) is answered so:

1. the sources are the user's friends (both columns of the friendships,
   those who have reviews); their review rows give the positives (rated
   >= 8) and the negatives (rated <= 4), items of every city;
2. each positive with a trained embedding adds its 10 nearest items by
   cosine over the trained item table, the first hit dropped; a neighbour
   trained but absent from the serve table counts below but is no
   candidate;
3. if fewer than 20 items (neighbours of step 2 included) are reached, the
   items of the city's 100 rows with the most ``user_reviews_count`` join;
4. the candidates are those in the request's city, less the negatives;
5. the answer is the MMR pick list of ``min(20, candidates)`` items: first
   the best-scored candidate, then each time the candidate with a trained
   embedding that maximizes ``λ·logit − (1−λ)·max cos`` to the picks so
   far (with a first pick that has no embedding the max starts at 0);
6. each hotel carries its first review row's city, price and stars, and
   the friends who rated it >= 8 in order of their first such review.

Where two neighbours of step 2 lie within ``KNN_TIE`` in cosine at the
tenth place, either may be the program's: both are allowed candidates, and
only the certain candidates set the best objective of a step.

The numbers compared, each over a sample of the window's answers:
``candidate_violations`` (a pick that no candidate set allows, more picks
than ``min(20, candidates)``, or fewer while a candidate was still
selectable), ``payload_mismatches`` (a hotel's
fields or its friends that differ), ``mmr_gap_max`` (the widest gap, in
logits, by which a pick's objective lies below the step's best) and
``unjudged`` (1 when the sample held no pick to judge).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import prep

KNN = 10
KNN_TIE = 1e-5
MIN_CANDIDATES = 20
POPULAR_POOL = 100
TOP_K = 20


class World:
    """The request-independent state of the reference, from the world's
    tables, the fitted vocabularies and the weights."""

    def __init__(self, reviews: dict, friendships: dict, fit: prep.Fit, item_table: torch.Tensor):
        self.items = prep.serve_items(reviews, fit)
        ext = self.items["ext"]
        self.M = len(ext)
        self.index = {int(e): i for i, e in enumerate(ext.tolist())}
        r_item = np.array([self.index[int(e)] for e in reviews["item_id"].tolist()], np.int64)
        r_user = np.asarray(reviews["user_id"], np.int64)
        rating = np.asarray(reviews["rating_overall"], np.float64)
        order = np.argsort(r_user, kind="stable")
        self.r_user_sorted = r_user[order]
        self.r_rows = order
        self.r_item, self.r_user, self.rating = r_item, r_user, rating
        self.users_with_reviews = set(np.unique(r_user).tolist())
        self.friends: dict = {}
        for a, b in zip(friendships["user_id_1"].tolist(), friendships["user_id_2"].tolist()):
            self.friends.setdefault(int(a), set()).add(int(b))
            self.friends.setdefault(int(b), set()).add(int(a))
        city = reviews["city"].astype(str)
        self.city_names = sorted(set(city.tolist()))
        self.city_items = {c: np.zeros(self.M, bool) for c in self.city_names}
        self.city_pop = {c: np.zeros(self.M, bool) for c in self.city_names}
        counts = np.asarray(reviews["user_reviews_count"], np.float64)
        for c in self.city_names:
            rows = np.nonzero(city == c)[0]
            self.city_items[c][r_item[rows]] = True
            top = rows[np.argsort(-counts[rows], kind="stable")[:POPULAR_POOL]]
            self.city_pop[c][r_item[top]] = True
        # positive raters of each item, first appearance order
        self.raters: dict = {}
        for it, u in zip(r_item[rating >= 8].tolist(), r_user[rating >= 8].tolist()):
            lst = self.raters.setdefault(it, [])
            if u not in lst:
                lst.append(u)
        self.trained = self.items["known"]  # serve item has a trained embedding
        self.t2s = np.full(len(fit.items), -1, np.int64)  # trained row -> serve item (-1: a ghost)
        known = np.nonzero(self.trained)[0]
        self.t2s[self.items["item"][known]] = known
        self.knn_must, self.knn_may = neighbours(item_table, KNN, KNN_TIE)
        emb = item_table.double()
        emb = emb / emb.norm(dim=1, keepdim=True).clamp_min(1e-12)
        self.emb_serve = emb[torch.as_tensor(self.items["item"], device=emb.device)]

    def candidates(self, user: int, city: str) -> tuple[np.ndarray, np.ndarray]:
        """→ (certain, possible) boolean masks over the serve items; the
        possible ones include the certain ones."""
        src = [f for f in self.friends.get(int(user), ()) if f in self.users_with_reviews]
        lo = np.searchsorted(self.r_user_sorted, src, side="left")
        hi = np.searchsorted(self.r_user_sorted, src, side="right")
        rows = np.concatenate([self.r_rows[a:b] for a, b in zip(lo, hi)]) if src else np.zeros(0, np.int64)
        pos = np.zeros(self.M, bool)
        neg = np.zeros(self.M, bool)
        pos[self.r_item[rows[self.rating[rows] >= 8]]] = True
        neg[self.r_item[rows[self.rating[rows] <= 4]]] = True
        trained_pos = self.items["item"][np.nonzero(pos & self.trained)[0]]
        reach = {}
        for name, table in (("must", self.knn_must), ("may", self.knn_may)):
            t = table[trained_pos].reshape(-1)
            t = np.unique(t[t >= 0])
            serve = self.t2s[t]
            mask = np.zeros(self.M, bool)
            mask[serve[serve >= 0]] = True
            reach[name] = (mask, int((serve < 0).sum()))
        masks = []
        for name in ("must", "may"):
            mask, ghosts = reach[name]
            cand = pos | mask
            if name == "may":
                cand |= reach["must"][0]
                ghosts = max(ghosts, reach["must"][1])
            if int(cand.sum()) + ghosts < MIN_CANDIDATES:
                cand = cand | self.city_pop.get(city, np.zeros(self.M, bool))
            in_city = self.city_items.get(city, np.zeros(self.M, bool))
            masks.append(cand & in_city & ~neg)
        must, may = masks
        return must & may, may | must

    def payload(self, user: int, serve: int) -> tuple:
        friends = self.friends.get(int(user), set())
        rec = [u for u in self.raters.get(serve, []) if u in friends]
        return (self.items["city"][serve], float(self.items["price"][serve]), float(self.items["stars"][serve]),
                rec)


def neighbours(table: torch.Tensor, k: int, tie: float, chunk: int = 4096) -> tuple[np.ndarray, np.ndarray]:
    """Each trained item's ``k`` nearest by cosine (float64), the first hit
    dropped → (certain ``[N, k]``, possible ``[N, k + extra]``), -1 padded:
    an item within ``tie`` of the k-th place's cosine is possible, not
    certain."""
    emb = table.double()
    emb = emb / emb.norm(dim=1, keepdim=True).clamp_min(1e-12)
    n = emb.shape[0]
    kk = min(k + 3, n)
    must = np.full((n, k), -1, np.int64)
    may_rows = []
    for s in range(0, n, chunk):
        sims = emb[s:s + chunk] @ emb.T
        vals, idx = torch.topk(sims, kk, dim=1)
        vals, idx = vals[:, 1:].cpu().numpy(), idx[:, 1:].cpu().numpy()
        for r in range(vals.shape[0]):
            v, i = vals[r], idx[r]
            if len(v) <= k:
                must[s + r, :len(v)] = i
                may_rows.append(i)
                continue
            edge = v[k - 1]
            close = np.abs(v - edge) < tie
            sure = ~close & (np.arange(len(v)) < k)
            if close[-1]:  # the tie reaches past the rows fetched: fetch all of them
                full = (emb[s + r] @ emb.T).cpu().numpy()
                full[int(np.argmax(full))] = -np.inf
                extra = np.nonzero(np.abs(full - edge) < tie)[0]
                i = np.concatenate([i[sure], extra])
                sure = np.arange(len(i)) < int(sure.sum())
            kept = i[sure]
            must[s + r, :len(kept)] = kept
            may_rows.append(i[sure | close] if not close[-1] else i)
    width = max(len(r) for r in may_rows)
    may = np.full((n, width), -1, np.int64)
    for r, row in enumerate(may_rows):
        may[r, :len(row)] = row
    return must, may


def logits_of(world: World, weights: dict, cfg: dict, fit: prep.Fit, users: np.ndarray, serve: np.ndarray,
              P, stats: dict, ref) -> torch.Tensor:
    """Eval logits of (user, serve item) pairs under precision ``P``."""
    dev = next(iter(weights.values())).device
    p = {k: v.to(P.dtype) for k, v in weights.items()}
    st = {k: v.to(P.dtype) for k, v in stats.items()}
    t = lambda a, dt=torch.int64: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)  # noqa: E731
    it = world.items
    x0 = ref.x0_of(p, t(fit.user_code(users)), t(it["item"][serve]), t(it["cat"][serve]), t(it["num"][serve],
                   torch.float32), P)
    return ref.tower(p, x0, cfg, P, stats=st)


def judge(world: World, fit: prep.Fit, weights: dict, cfg: dict, ref, requests: list, served: dict,
          control=None) -> dict:
    """``requests``: [(user, city, λ)]; ``served``: arrays of the program's
    answers to them (``ext [n, 20]`` with -1 past the last pick, ``price``,
    ``stars``, ``city`` code into ``world.city_names``, ``rec_len``,
    ``rec_sum``). ``control``: a lower :class:`Prec`, whose own picks are
    judged in place of the program's at every step. → the numbers."""
    stats = {k: v for k, v in weights.items() if k.endswith((".mean", ".var"))}
    P = ref.reference_prec(cfg)
    viol = mism = 0
    gap_max = 0.0
    steps = 0
    plan = []
    for n, (user, city, lam) in enumerate(requests):
        must, may = world.candidates(user, city)
        plan.append((n, np.nonzero(may)[0], must))
    rows_u, rows_s = [], []
    for n, cand, _ in plan:
        rows_u.append(np.full(len(cand), requests[n][0], np.int64))
        rows_s.append(cand)
    all_u = np.concatenate(rows_u) if rows_u else np.zeros(0, np.int64)
    all_s = np.concatenate(rows_s) if rows_s else np.zeros(0, np.int64)
    with torch.no_grad():
        ref_logits = logits_of(world, weights, cfg, fit, all_u, all_s, P, stats, ref).double().cpu().numpy()
        ctl_logits = (logits_of(world, weights, cfg, fit, all_u, all_s, control, stats, ref).double().cpu().numpy()
                      if control is not None else None)
    emb = world.emb_serve
    emb_ctl = control.mm(emb.float()) if control is not None else None
    at = 0
    for (n, cand, must), (user, city, lam) in zip(plan, requests):
        s_ref = ref_logits[at:at + len(cand)]
        s_ctl = ctl_logits[at:at + len(cand)] if ctl_logits is not None else None
        at += len(cand)
        lam = float(np.float32(lam))
        sure = must[cand]
        picks = [int(e) for e in served["ext"][n] if e >= 0]
        n_lo, n_hi = min(TOP_K, int(must.sum())), min(TOP_K, len(cand))
        pos = {int(s): j for j, s in enumerate(cand.tolist())}
        serve_picks = [world.index.get(e, -1) for e in picks]
        if control is None and len(picks) > n_hi:
            viol += 1
        if control is None and any(s not in pos for s in serve_picks):
            viol += 1
            continue
        if not len(cand):
            continue
        emb_c = emb[torch.as_tensor(cand, device=emb.device)]
        sims = (emb_c @ emb_c.T).cpu().numpy()
        sims_ctl = ((emb_ctl[torch.as_tensor(cand, device=emb.device)] @ control.mm(emb_c.float()).T)
                    .double().cpu().numpy() if control is not None else None)
        embedded = world.trained[cand]
        chosen = [pos[s] for s in serve_picks] if control is None else None
        selected = np.zeros(len(cand), bool)
        max_sim = max_ctl = None
        n_steps = len(picks) if control is None else n_lo
        for t in range(n_steps):
            if t == 0:
                obj, pool = s_ref, sure.copy()
                obj_c = s_ctl
                pool_c = sure.copy()
            else:
                pool = sure & ~selected & embedded
                pool_c = pool
                obj = lam * s_ref - (1 - lam) * max_sim
                obj_c = lam * s_ctl - (1 - lam) * max_ctl if control is not None else None
            if not pool.any():
                break
            best = obj[pool].max()
            if control is None:
                j = chosen[t]
            else:
                masked = np.where(pool_c, obj_c, -np.inf)
                j = int(np.argmax(masked))
            gap_max = max(gap_max, float(best - obj[j]))
            steps += 1
            selected[j] = True
            first_sim = sims[j] if embedded[j] else np.zeros(len(cand))
            max_sim = first_sim if t == 0 else (np.maximum(max_sim, sims[j]) if embedded[j] else max_sim)
            if control is not None:
                first_c = sims_ctl[j] if embedded[j] else np.zeros(len(cand))
                max_ctl = first_c if t == 0 else (np.maximum(max_ctl, sims_ctl[j]) if embedded[j] else max_ctl)
        if control is None:
            # stopped early: a certain candidate was still selectable (after
            # the first pick only one with a trained embedding is)
            left = sure & ~selected & (embedded if picks else True)
            if len(picks) < n_lo and left.any():
                viol += 1
            for k, s in enumerate(serve_picks):
                city_ref, price, stars, rec = world.payload(user, s)
                code = world.city_names.index(city_ref)
                digest = sum((i + 1) * u for i, u in enumerate(rec)) % (1 << 61)
                if (served["city"][n, k] != code or served["price"][n, k] != price
                        or served["stars"][n, k] != stars or served["rec_len"][n, k] != len(rec)
                        or served["rec_sum"][n, k] != digest):
                    mism += 1
    return {"candidate_violations": viol, "payload_mismatches": mism, "mmr_gap_max": gap_max,
            "unjudged": int(steps == 0), "requests": len(requests), "steps": steps}


def empty_served(n: int) -> dict:
    """Arrays for ``n`` answers, allocated before the window."""
    return {"ext": np.full((n, TOP_K), -1, np.int64), "price": np.full((n, TOP_K), np.nan),
            "stars": np.full((n, TOP_K), np.nan), "city": np.full((n, TOP_K), -1, np.int16),
            "rec_len": np.zeros((n, TOP_K), np.int32), "rec_sum": np.zeros((n, TOP_K), np.int64)}


def copy_answers(out: dict, at: int, answers: list, city_codes: dict) -> None:
    """The program's answers of one batch into rows ``at…`` of ``out``."""
    ext, price, stars, city, rlen, rsum = (out[k] for k in ("ext", "price", "stars", "city", "rec_len", "rec_sum"))
    for n, ans in enumerate(answers):
        for k, h in enumerate(ans["ranked_hotels"][:TOP_K]):
            ext[at + n, k] = h["hotel_id"]
            price[at + n, k] = h["price_rub"]
            stars[at + n, k] = h["stars"]
            city[at + n, k] = city_codes.get(h["city"], -1)
            rec = h["recommended_by"]
            rlen[at + n, k] = len(rec)
            rsum[at + n, k] = sum((i + 1) * u for i, u in enumerate(rec)) % (1 << 61)
