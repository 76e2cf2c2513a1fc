"""Bulk serving: one caller in a closed loop, as the nightly batch export
runs, sends chunks of users through
``RecommendationEngine.recommend_many(chunk, pad_to=batch)`` and waits for
each answer before it sends the next chunk.

Set-up builds the world from the seed, the program's vocabularies from it
(``Preprocessor`` on the noise-filtered reviews), seeded weights on the
device, the engine, and warms the one bucket the traffic uses with a fixed
number of batches. The window then times every batch on the host clock (a
call ends in its device→host copy). The answers of a sample of batches,
drawn from the seed, are copied into arrays allocated before the window,
and each batch's answers are dropped as soon as they are copied, so the
window grows no heap of the harness's own. The reference judges the sample
after the window, once the program's state is freed.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench import prep, serve_ref, spec, tracing, weights, world


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: torch.device, clock) -> dict:
    tr, cfg = cell.traffic, cell.config
    s_world, s_weights, s_traffic, s_sample = world.seeds(seed, 4)
    reviews, friendships = world.build(tr["world"], s_world)
    marks = [("world drawn", clock())]
    gc_clock = tracing.GcClock()

    from hhrs_tpu_torch.config import ModelConfig, RetrievalConfig
    from hhrs_tpu_torch.data.features import add_engineered_features
    from hhrs_tpu_torch.data.ingest import noise_filter
    from hhrs_tpu_torch.data.preprocess import Preprocessor
    from hhrs_tpu_torch.models.dcn import ModelDims
    from hhrs_tpu_torch.serve.engine import RecommendationEngine
    from hhrs_tpu_torch.train.artifacts import ArtifactBundle

    main = add_engineered_features(dict(reviews))
    _, art = Preprocessor().fit_transform(add_engineered_features(noise_filter(dict(reviews))))
    dims = ModelDims.from_artifacts(art)
    cat_dims = [n for _, n in dims.cat_dims]
    m = cfg["model"]
    flat = weights.make(m, dims.n_users, dims.n_items, cat_dims, dims.n_num_features, s_weights, device,
                        trained=True)
    params, state = weights.to_trees(flat, m["n_res_blocks"], len(cat_dims))
    bundle = ArtifactBundle(params, state, ModelConfig(**m), dims, art, params["item_embedding"], {})
    engine = RecommendationEngine(bundle, main, friendships, RetrievalConfig(), device=device)
    del main, params, state, bundle
    marks.append(("vocabularies, weights and engine", clock()))

    K = tr["batch"]
    homes = world.home_cities(reviews)
    users = np.array(sorted(homes), np.int64)
    order = np.random.default_rng(s_traffic).permutation(len(users))
    n_chunks = len(users) // K
    chunks = [[(int(users[r]), homes[int(users[r])], tr["mode"], tr["lambda"]) for r in order[i * K:(i + 1) * K]]
              for i in range(n_chunks)]
    city_size = {c: len(np.unique(reviews["item_id"][reviews["city"] == c])) for c in set(homes.values())}
    chunk_rows = [sum(city_size[c] for _, c, _, _ in ch) for ch in chunks]

    warm = tr["warm_batches"]
    for i in range(warm):
        engine.recommend_many(chunks[i % n_chunks], pad_to=K)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    marks.append(("warm batches", clock()))

    every, cap = tr["sample_every"], tr["judge_batches"]
    off = int(np.random.default_rng(s_sample).integers(every))
    max_batches = tr["max_batches"]
    lat = np.zeros(max_batches)
    served = serve_ref.empty_served(cap * K)
    sampled = np.full(cap, -1, np.int64)
    codes = {c: i for i, c in enumerate(sorted(set(np.asarray(reviews["city"]).astype(str).tolist())))}
    gc.collect()
    setup_s = clock()

    gc_clock.recording = True
    t_start = time.perf_counter()
    i = n_s = 0
    while True:
        c = (warm + i) % n_chunks
        t0 = time.perf_counter()
        out = engine.recommend_many(chunks[c], pad_to=K)
        t1 = time.perf_counter()
        lat[i] = t1 - t0
        if i % every == off and n_s < cap:
            serve_ref.copy_answers(served, n_s * K, out, codes)
            sampled[n_s] = c
            n_s += 1
        del out
        i += 1
        if t1 - t_start >= seconds or i == max_batches:
            break
    window_s = t1 - t_start
    gc_clock.recording = False
    n_batches = i
    rows = sum(chunk_rows[(warm + j) % n_chunks] for j in range(n_batches))

    trace_out = None
    traced_batches = traced_rows = 0
    if trace:
        win = tracing.Window(device)
        gc_clock.tracing = True
        win.start()
        t_trace = time.perf_counter()
        while time.perf_counter() - t_trace < tr["trace_seconds"]:
            c = (warm + n_batches + traced_batches) % n_chunks
            with record_function("recommend_many (a caller's call)"):
                engine.recommend_many(chunks[c], pad_to=K)
            traced_batches += 1
            traced_rows += chunk_rows[c]
        win.stop()
        gc_clock.tracing = False
        trace_out = win.reduce()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    engine.close()
    del engine
    gc_clock.close()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # --- the reference, after the window -------------------------------
    t_ref = time.perf_counter()
    ref = spec.reference(cfg)
    fit = prep.fit(prep.noise_filtered(reviews))
    refw = serve_ref.World(reviews, friendships, fit, flat["item_embedding"])
    requests, rows_kept = [], []
    for n, c in enumerate(sampled[:n_s].tolist()):
        for k, (u, city, _mode, lam) in enumerate(chunks[c]):
            requests.append((u, city, lam))
            rows_kept.append(n * K + k)
    kept = {k: v[rows_kept] for k, v in served.items()}
    numbers = serve_ref.judge(refw, fit, flat, m, ref, requests, kept)
    numbers["reference_s"] = time.perf_counter() - t_ref
    d = weights.input_dim(m, cat_dims, dims.n_num_features)
    return {
        "setup_s": setup_s, "window_s": window_s, "batches": n_batches, "users": n_batches * K,
        "batch_s": lat[:n_batches], "gc_pauses": list(gc_clock.pauses), "rows_scored": rows,
        "trace": trace_out, "traced_batches": traced_batches, "traced_rows": traced_rows,
        "widths": {"d": d, "H": m["hidden_dim"], "R": m["n_res_blocks"], "L": m["n_cross_layers"]},
        "dtype": m["compute_dtype"], "memory_peak_bytes": peak,
        "attempted": n_batches * K, "failed": 0, "numbers": numbers, "judged": len(requests),
        "judge_inputs": (refw, fit, flat, m, ref, requests, kept), "setup_marks": marks,
    }

