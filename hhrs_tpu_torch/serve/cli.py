"""Serving entry point: ``python -m hhrs_tpu_torch.serve.cli``.

Counterpart of ``hhrs_tpu/serve/cli.py``, with its flags plus
``--device``: load the artifacts and CSVs, build the engine on the card
(``--device cpu`` only when asked; no card and no ``--device`` raises),
capture the buckets it will serve, and serve the REST contract
(``serve/http.py``). The stack is built in the JAX CLI's order: engine →
dynamic batcher → swappable holder and hot-reload pollers → canary →
response cache → shadow. Exits non-zero on any startup failure; SIGTERM
drains in-flight requests and exits 0.

Configuration, as in the JAX CLI (``config.py::build_config``): the
defaults, then the preset named by ``HHRS_PRESET``, then
``HHRS_<SECTION>_<FIELD>`` environment variables (``HHRS_SERVE_PORT``, …),
then ``section.field=value`` overrides, then the flags.
``--retrieval-embeddings NPY`` (``retrieval/two_tower.py``'s export) reaches
every engine the stack builds: the primary, the canary and the shadow, and
each hot-reload rebuild.

``--mesh DATAxMODEL`` serves over a mesh of ``DATA·MODEL`` ranks
(``serve/engine.py``'s mesh mode): when the environment configures a
world (torchrun's ``MASTER_ADDR``…, or ``COORDINATOR_ADDRESS``…;
``parallel/distributed.py``) this process is one of its ranks; otherwise
it builds the kernels, launches the ranks on this node and waits for them.
Rank 0 parses the data, builds the stack and serves it; the other ranks
run the world's follower loop (``serve/lockstep.py``), which builds every
engine rank 0 builds (the primary, the canary, the shadow and each
hot-reload rebuild) from rank 0's parse and runs each device call rank 0
announces. The batcher, the cache, the pollers and the shadow's worker run
on rank 0 only. A rebuild that fails on any rank is discarded on every
rank, and rank 0 keeps serving the old stack. SIGTERM or Ctrl-C to the
launching process stops every rank: rank 0 drains, closes its stack, then
stops the followers. A device call that fails part way ends rank 0 (exit
code 1), and with it the world: the launch raises, or torchrun stops the
other ranks.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import signal
import sys
import threading

import torch

from hhrs_tpu_torch.config import build_config
from hhrs_tpu_torch.device import resolve_device
from hhrs_tpu_torch.utils.logging import LatencyHistogram, setup_logging

log = logging.getLogger("hhrs_tpu_torch.serve")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Serve the hybrid recommender with the PyTorch port")
    p.add_argument("--artifacts", default=None,
                   help="artifact dir, or 'registry:<db>' to use the active registered model")
    p.add_argument("--data", default=None)
    p.add_argument("--host", default=None)
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--no-warmup", action="store_true")
    p.add_argument("--bf16", action="store_true",
                   help="score at compute bfloat16 through DCNR.forward (f32 BatchNorm and "
                        "logits; near-tied rankings may differ from f32)")
    p.add_argument("--quantize-tables", action="store_true",
                   help="hold the model's embedding tables as per-row int8 on the card "
                        "(near-tied rankings may differ from f32)")
    p.add_argument("--retrieval-embeddings", default=None, metavar="NPY",
                   help="learned retrieval vectors (retrieval/two_tower.py's export) for the "
                        "similarity surfaces: kNN expansion, /similar_items and MMR")
    p.add_argument("--batch-window-ms", type=float, default=None,
                   help=">0: coalesce concurrent requests into one bucket replay within "
                        "this window (dynamic batching)")
    p.add_argument("--max-batch", type=int, default=None)
    p.add_argument("--warm-http-batch", action="store_true",
                   help="capture the POST /recommendations/batch bucket before serving")
    p.add_argument("--candidate-cap", type=int, default=None,
                   help=">0: a one-request program that ranks only the candidate rows when "
                        "they fit (exact; more candidates run the full program)")
    p.add_argument("--cache-entries", type=int, default=None,
                   help=">0: LRU response cache (identical requests skip the card; hot "
                        "reload invalidates; serve.cache_ttl_s adds expiry)")
    p.add_argument("--shadow", default=None, metavar="ARTIFACT_DIR",
                   help="mirror live traffic onto this candidate model off the request "
                        "path and report agreement in /healthz and /metrics")
    p.add_argument("--canary", default=None, metavar="ARTIFACT_DIR",
                   help="route a sticky user-hash slice of live traffic to this candidate "
                        "model on the request path (errors fall back to the primary)")
    p.add_argument("--canary-fraction", type=float, default=0.1,
                   help="fraction of users (by stable id hash) the --canary model answers "
                        "(default 0.1, range (0, 1])")
    p.add_argument("--canary-salt", default="",
                   help="salt folded into the canary routing hash: rotates which users "
                        "form the slice per rollout")
    p.add_argument("--reload-poll-s", type=float, default=0.0,
                   help="with --artifacts registry:<db>: poll the registry every N seconds "
                        "and hot-swap to a newly activated model (0 disables)")
    p.add_argument("--data-poll-s", type=float, default=None,
                   help=">0: poll the data CSVs every N seconds and rebuild and hot-swap "
                        "the serving stack when they change")
    p.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                   help="serve over a device mesh, e.g. 2 or 2x2: the item axis (catalog features, "
                        "masks, kNN table) shards over DATA*MODEL ranks; responses equal "
                        "single-device serving")
    p.add_argument("--device", default=None,
                   help="torch device to serve on (default cuda, which raises without a "
                        "card; cpu only when asked)")
    p.add_argument("overrides", nargs="*", help="section.field=value config overrides")
    return p


@dataclasses.dataclass
class ServeStack:
    """What :func:`build_stack` built: the outermost engine to serve, where
    to serve it, and the hot-reload pollers it started (None when off)."""

    engine: object
    host: str
    port: int
    reloader: object = None
    data_reloader: object = None


def build_stack(args: argparse.Namespace, parser: argparse.ArgumentParser | None = None,
                mesh=None) -> ServeStack:
    """Build the serving stack of parsed flags (:func:`build_parser`), every
    bucket it serves captured unless ``--no-warmup``; raises on a startup
    failure. With ``mesh`` (rank 0 of a ``--mesh`` world), every engine is
    a world build (``serve/lockstep.py``): the other ranks build it in
    their follower loop from this rank's parse."""
    parser = parser or build_parser()
    if mesh is not None and torch.distributed.get_rank() != 0:
        raise RuntimeError("rank 0 builds a mesh world's stack; the other ranks run its follower loop")
    bad = [t for t in args.overrides if "=" not in t]
    if bad:
        parser.error(f"invalid config override(s) {bad}: use section.field=value")
    cfg_all = build_config(args.overrides, log=log)

    from hhrs_tpu_torch.db.registry import resolve_artifacts_dir
    from hhrs_tpu_torch.serve.engine import RecommendationEngine, load_frames
    from hhrs_tpu_torch.serve.lockstep import world_of
    from hhrs_tpu_torch.serve.reload import data_fingerprint
    from hhrs_tpu_torch.serve.schemas import HTTP_BATCH_PAD

    device = resolve_device(args.device)
    cfg = cfg_all.serve
    artifacts = args.artifacts if args.artifacts is not None else cfg.artifacts_dir
    data_dir = args.data if args.data is not None else cfg.data_dir
    window_ms = args.batch_window_ms if args.batch_window_ms is not None else cfg.batch_window_ms
    max_batch = args.max_batch if args.max_batch is not None else cfg.max_batch
    cap = args.candidate_cap if args.candidate_cap is not None else cfg.candidate_cap
    world = world_of(mesh, device) if mesh is not None else None
    quantize = args.quantize_tables or cfg.quantize_tables
    stack = ServeStack(None, args.host if args.host is not None else cfg.host,
                       args.port if args.port is not None else cfg.port)

    artifacts_dir = resolve_artifacts_dir(artifacts)
    want_batching = window_ms > 0

    # Fingerprint before the parse: the data reloader's baseline must
    # describe the files this startup read. The tables are parsed once and
    # shared by the primary, canary and shadow engines (and, on a mesh, sent
    # to every rank).
    fp0 = data_fingerprint(data_dir)
    frames = load_frames(data_dir)

    def new_engine(adir: str, frames: tuple | None, batch_pad: int | None, http_batch: bool = True,
                   label: str = "primary"):
        """An engine with every bucket it will serve captured: 1, and
        ``batch_pad`` and (with ``--warm-http-batch``) ``HTTP_BATCH_PAD``
        where asked. On a mesh a world build from this rank's frames (a
        registry reload without a snapshot parses the live files here)."""
        options = dict(retrieval_cfg=cfg_all.retrieval, city_bounded=cfg.city_bounded, bf16=args.bf16,
                       quantize_tables=quantize, candidate_cap=cap, use_pallas=cfg.use_pallas,
                       retrieval_embeddings_path=args.retrieval_embeddings)
        if world is None:
            eng = RecommendationEngine.from_dirs(adir, data_dir, device=device, frames=frames, **options)
        else:
            eng = world.build(adir, frames if frames is not None else load_frames(data_dir), label=label,
                              **options)
        if not args.no_warmup:
            log.info("warming up: capturing the serving buckets...")
            eng.warmup(batch_pad=batch_pad)
            if args.warm_http_batch and http_batch:
                uni = eng.gen.universe
                if uni.n_users and uni.cities:
                    eng.recommend_many([(int(uni.user_ids[0]), uni.cities[0], "friends", 0.7)],
                                       pad_to=HTTP_BATCH_PAD)
                eng.latency = LatencyHistogram()
        return eng

    def build_primary(adir: str, frames: tuple | None = None):
        """The primary stack for one artifact dir, at startup and verbatim on
        every hot reload."""
        eng = new_engine(adir, frames, max_batch if want_batching else None)
        if want_batching:
            from hhrs_tpu_torch.serve.batcher import BatchingEngine

            eng = BatchingEngine(eng, max_batch=max_batch, window_ms=window_ms)
            log.info("dynamic batching on: window %.1fms, max %d", window_ms, max_batch)
        return eng

    engine = build_primary(artifacts_dir, frames=frames)
    data_poll_s = args.data_poll_s if args.data_poll_s is not None else cfg.data_poll_s
    registry_reload = args.reload_poll_s > 0
    if registry_reload and not artifacts.startswith("registry:"):
        log.warning("--reload-poll-s needs --artifacts registry:<db>; ignoring it")
        registry_reload = False
    if registry_reload or data_poll_s > 0:
        from hhrs_tpu_torch.serve.reload import DataReloader, FramesCache, RegistryReloader, SwappableEngine

        holder = SwappableEngine(engine)
        # One lock serializes both pollers' build and swap; the shared frames
        # cache lets a model-only promotion skip a re-parse.
        swap_lock = threading.Lock()
        frames_cache = FramesCache(fp0, frames)
        if registry_reload:
            stack.reloader = RegistryReloader(holder, artifacts, build_primary, args.reload_poll_s,
                                              artifacts_dir, swap_lock=swap_lock, data_dir=data_dir,
                                              frames_loader=load_frames, frames_cache=frames_cache)
            stack.reloader.start()
            log.info("registry hot reload on: polling every %.1fs", args.reload_poll_s)
        if data_poll_s > 0:
            reloader = stack.reloader
            current_dir_fn = (lambda: reloader.current_dir) if reloader is not None else (lambda: artifacts_dir)
            stack.data_reloader = DataReloader(holder, data_dir, build_primary, data_poll_s, current_dir_fn,
                                               swap_lock=swap_lock, frames_loader=load_frames,
                                               baseline_fp=fp0, frames_cache=frames_cache)
            if reloader is not None:
                reloader.data_reloader = stack.data_reloader
            stack.data_reloader.start()
            log.info("data hot reload on: polling %s every %.1fs (shadow/canary arms keep the "
                     "startup data)", data_dir, data_poll_s)
            if args.shadow or args.canary:
                log.warning("--data-poll-s with --shadow/--canary: after a data reload the candidate "
                            "arm keeps the startup data, so its comparison mixes data drift into the "
                            "model comparison")
        engine = holder
    if args.canary:
        from hhrs_tpu_torch.serve.canary import CanaryEngine

        canary_dir = resolve_artifacts_dir(args.canary)
        if canary_dir == artifacts_dir:
            parser.error("--canary is the same artifact dir as the primary")
        # a bare engine: it answers its slice one request at a time, and its
        # part of a /recommendations/batch call in bucket HTTP_BATCH_PAD
        canary_eng = new_engine(canary_dir, frames, None, label="canary")
        try:
            engine = CanaryEngine(engine, canary_eng, args.canary_fraction,
                                  canary_dir=canary_dir, salt=args.canary_salt)
        except ValueError as e:
            parser.error(str(e))
        log.info("canary serving on: %s answers %.1f%% of users", canary_dir, 100 * args.canary_fraction)
    cache_entries = args.cache_entries if args.cache_entries is not None else cfg.cache_entries
    if cache_entries > 0:
        from hhrs_tpu_torch.serve.cache import CachedEngine

        engine = CachedEngine(engine, cache_entries, cfg.cache_ttl_s)
        log.info("response cache on: %d entries, ttl %.1fs", cache_entries, cfg.cache_ttl_s)
    if args.shadow:
        from hhrs_tpu_torch.serve.shadow import ShadowEngine

        if args.canary:
            log.warning("--shadow with --canary: shadow agreement is computed against mixed "
                        "primary/canary responses")
        shadow_dir = resolve_artifacts_dir(args.shadow)
        if shadow_dir == artifacts_dir:
            parser.error("--shadow is the same artifact dir as the primary")
        # a bare engine that replays one request at a time on the shadow's worker
        shadow_eng = new_engine(shadow_dir, frames, None, http_batch=False, label="shadow")
        engine = ShadowEngine(engine, shadow_eng, shadow_dir=shadow_dir)
        log.info("shadow serving on: mirroring traffic to %s", shadow_dir)
    stack.engine = engine
    log.info("Artifacts loaded successfully. Server is ready on %s.", device)
    return stack


def _build_kernels() -> None:
    """Build the kernel libraries once, before ranks start (one nvcc each,
    started together), so that no two ranks compile the same source."""
    from concurrent.futures import ThreadPoolExecutor

    from hhrs_tpu_torch.ops import cross, cuda_build, tower

    libs = [(tower._LIB_NAME, tower._LIB_SOURCES), (cross._LIB_NAME, cross._LIB_SOURCES)]
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: cuda_build.build(*lib), libs))


def serve_rank(argv: list) -> int:
    """One rank of a ``--mesh`` world (joined already): rank 0 builds the
    stack over the mesh and serves it, the others run the world's follower
    loop, which builds every engine rank 0 builds and runs its device calls."""
    setup_logging()
    from hhrs_tpu_torch.parallel.mesh import mesh_from_spec
    from hhrs_tpu_torch.serve.http import serve_forever
    from hhrs_tpu_torch.serve.lockstep import world_of

    parser = build_parser()
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    mesh = mesh_from_spec(args.mesh, device)
    world = world_of(mesh, device)
    if torch.distributed.get_rank() != 0:
        # a launcher that signals every rank (torchrun) must not stop a
        # follower under rank 0: rank 0 drains, then stops the followers
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, signal.SIG_IGN)
        world.follow()
        return 0
    stack = None
    try:
        stack = build_stack(args, parser, mesh=mesh)
        serve_forever(stack.engine, stack.host, stack.port)
    finally:
        if stack is not None:
            for poller in (stack.reloader, stack.data_reloader):
                if poller is not None:
                    poller.stop()
            stack.engine.close()  # CLOSE of every engine (serve_forever closes the stack too once it has started)
        world.shutdown()  # STOP: the followers' loops end
    return 0


def serve_mesh(argv: list, args: argparse.Namespace) -> int:
    """``--mesh``: join the world the environment configures, or launch one
    of ``DATA·MODEL`` ranks on this node and wait for it."""
    from hhrs_tpu_torch.parallel.distributed import initialize_distributed, launch
    from hhrs_tpu_torch.parallel.mesh import parse_mesh_spec

    device = resolve_device(args.device)
    if initialize_distributed(device=device):
        return serve_rank(argv)
    data, model = parse_mesh_spec(args.mesh)
    if device.type == "cuda":
        _build_kernels()
    log.info("launching a mesh of %dx%d ranks on %s", data, model, device)
    return launch(serve_rank, data * model, (argv,), device=device, timeout_s=float("inf"))


def main(argv=None) -> int:
    setup_logging()
    parser = build_parser()
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser.parse_args(argv)
    resolve_device(args.device)  # no card and no --device: raises, never falls back to the CPU
    if args.mesh:
        from hhrs_tpu_torch.parallel.mesh import parse_mesh_spec

        try:
            parse_mesh_spec(args.mesh)
        except ValueError as e:
            parser.error(str(e))
        return serve_mesh(argv, args)
    try:
        stack = build_stack(args, parser)
    except Exception as e:
        log.critical("CRITICAL ERROR during startup: %s", e)
        import traceback

        traceback.print_exc()
        return 1

    from hhrs_tpu_torch.serve.http import serve_forever

    serve_forever(stack.engine, stack.host, stack.port)
    return 0


if __name__ == "__main__":
    sys.exit(main())
