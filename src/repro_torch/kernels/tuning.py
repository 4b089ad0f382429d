"""Shape-keyed tile autotuner with a persistent plan cache (the port of
``repro.kernels.tuning``).

Each tunable launch (the bf16 GEMMs of ``masked_matmul``'s forward, dX, dW
and dM, 2-D and expert-batched, ``nm_spmm``, and the bf16 attention
forward) has a small compiled set of tiles (``kernels.validation``). For
each *launch shape* this module enumerates the candidates through the same
plan builders the wrappers launch from (a candidate that builds is a
candidate that launches), measures them on the card, and persists the
winner in an on-disk JSON cache, so later processes start at the best plan
with no search.

Entries are keyed by ``(kernel, dims, dtypes, params, backend,
device_kind, code_rev)``; ``kernel`` is the route (``masked_matmul_dw``,
``masked_matmul_batched``, ... each a launch of its own), ``code_rev`` a
hash of this package's Python files and its ``csrc/*.cu`` and ``*.cuh``,
so an edited kernel or tuner makes its entries miss (the reference's
``tuning_cache`` pass, TUN001-004, which flags stale and malformed entries,
comes with the port's static checks, ROADMAP.md A.7). Writes are atomic
(a temporary file and ``os.replace``).

Three modes (``configure``; the launcher's ``--kernel-tune``)::

    off     never consult the cache; every launch runs the default tiles
    cache   a cached plan when there is one, the default on a miss
    search  on a miss, measure the candidates and persist the winner

The library default is ``off``. Environment overrides:
``REPRO_TORCH_KERNEL_TUNE`` (mode) and ``REPRO_TORCH_KERNEL_CACHE``
(path; default ``experiments/kernel_cache_torch.json``). The schema and
the names are the port's own, so the two packages never read each other's
cache. On the CPU the plain versions take no tiles: ``search`` stores the
default plan with ``measured_s`` None and one candidate, so a CPU run of
``search`` and then ``cache`` is warm. On the card the search times each
candidate by CUDA events on operands it makes from a seeded generator,
the default inside the same sweep; its launches are not counted by the
wrappers' launch counters (they are the tuner's, not the path's).

Observability: resolutions count into ``kernels/tuning/{hits,misses,
searches}`` and search wall time into ``kernels/tuning/search_s``;
:func:`stats` carries the same numbers for ``BENCH_ebft.json``'s
``kernel_tuning`` section whether obs is on or not.
"""
from __future__ import annotations

import hashlib
import json
import os
import statistics
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import validation as V
from repro_torch.kernels.validation import KernelPlan

SCHEMA = "repro_torch.kernels.tuning/v1"
MODES = ("off", "cache", "search")
DEFAULT_CACHE_PATH = os.path.join("experiments", "kernel_cache_torch.json")
ENV_MODE, ENV_PATH = "REPRO_TORCH_KERNEL_TUNE", "REPRO_TORCH_KERNEL_CACHE"
PACKAGE = Path(__file__).resolve().parent


class _State:
    __slots__ = ("mode", "path", "cache", "loaded", "stats", "checked")

    def __init__(self) -> None:
        self.mode = os.environ.get(ENV_MODE, "off")
        self.path = os.environ.get(ENV_PATH, DEFAULT_CACHE_PATH)
        self.cache: Dict[str, Dict[str, Any]] = {}
        self.loaded = False
        self.stats = _zero_stats()
        # a launch's cached tiles, checked through their plan once: the
        # launch's (kernel, dims, dtypes, params, device) -> tiles, or None
        # for a miss or an invalid entry
        self.checked: Dict[Tuple, Optional[Dict[str, int]]] = {}


def _zero_stats() -> Dict[str, float]:
    return {"hits": 0, "misses": 0, "searches": 0, "search_s": 0.0}


_STATE = _State()


def configure(mode: Optional[str] = None, path: Optional[str] = None) -> None:
    """Set the mode and/or the cache path (None keeps the current one); a
    new path drops the entries in memory, so the next resolve reads it."""
    if mode is not None:
        if mode not in MODES:
            raise ValueError(f"kernel-tune mode {mode!r} not one of {'/'.join(MODES)}")
        _STATE.mode = mode
    if path is not None and path != _STATE.path:
        _STATE.path = path
        _STATE.cache = {}
        _STATE.loaded = False
        _STATE.checked = {}


def state() -> Dict[str, Any]:
    """The mode, the cache path and the entries in memory."""
    return {"mode": _STATE.mode, "path": _STATE.path, "entries": len(_STATE.cache)}


def stats() -> Dict[str, float]:
    """Resolution counters since the last :func:`reset_stats`."""
    return dict(_STATE.stats)


def reset_stats() -> None:
    _STATE.stats = _zero_stats()


def _reset_for_tests(mode: str = "off") -> None:
    """Test hook: fresh state, no environment."""
    _STATE.mode = mode
    _STATE.path = DEFAULT_CACHE_PATH
    _STATE.cache = {}
    _STATE.loaded = False
    _STATE.stats = _zero_stats()
    _STATE.checked = {}


# ---------------------------------------------------------------------------
# cache key and persistence
# ---------------------------------------------------------------------------
_CODE_REV: Dict[Path, str] = {}


def code_rev(root: Optional[os.PathLike] = None) -> str:
    """Hash of the package's sources under ``root`` (this package by
    default): every ``.py`` file and ``csrc``'s ``.cu`` and ``.cuh``. An
    edited kernel, plan builder or tuner makes the old entries miss."""
    root = Path(root) if root is not None else PACKAGE
    if root not in _CODE_REV:
        h = hashlib.sha1()
        files = sorted(p for p in root.rglob("*")
                       if p.suffix == ".py" or (p.parent.name == "csrc"
                                                and p.suffix in (".cu", ".cuh")))
        for p in files:
            h.update(p.relative_to(root).as_posix().encode())
            h.update(p.read_bytes())
        _CODE_REV[root] = h.hexdigest()[:12]
    return _CODE_REV[root]


_DEVICE_KIND: Dict[int, str] = {}


def _backend_tag(device: torch.device) -> str:
    return "cuda" if device.type == "cuda" else "cpu"


def _device_kind(device: torch.device) -> str:
    if device.type != "cuda":
        return "cpu"
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _DEVICE_KIND:
        _DEVICE_KIND[idx] = torch.cuda.get_device_name(idx)
    return _DEVICE_KIND[idx]


def _fmt(d: Dict[str, Any]) -> str:
    return ",".join(f"{k}={d[k]}" for k in sorted(d))


def cache_key(kernel: str, dims: Dict[str, int], dtypes: Dict[str, str],
              params: Dict[str, Any], backend: str, device_kind: str, rev: str) -> str:
    return "|".join([kernel, _fmt(dims), _fmt(dtypes), _fmt(params), backend, device_kind,
                     rev])


def _load() -> None:
    if _STATE.loaded:
        return
    _STATE.loaded = True
    try:
        with open(_STATE.path) as f:
            payload = json.load(f)
    except (OSError, json.JSONDecodeError, UnicodeDecodeError):
        return
    if not isinstance(payload, dict) or payload.get("schema") != SCHEMA:
        return  # an unknown schema: start fresh, never stop a run
    entries = payload.get("entries")
    if isinstance(entries, dict):
        _STATE.cache = entries


def _save() -> None:
    """Atomic rewrite: the file is the old cache or the new one, never a
    torn write."""
    path = _STATE.path
    parent = os.path.dirname(path) or "."
    os.makedirs(parent, exist_ok=True)
    payload = {"schema": SCHEMA, "code_rev": code_rev(), "entries": _STATE.cache}
    fd, tmp = tempfile.mkstemp(dir=parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


# ---------------------------------------------------------------------------
# plans and candidates (through the validated builders)
# ---------------------------------------------------------------------------
def _masked(route: str):
    return lambda dims, dtypes, params, tiles: V.plan_masked_matmul(
        route, dims["M"], dims["K"], dims["N"], dims.get("E", 1), **tiles,
        dtype=dtypes.get("x", "bfloat16"))


_GEMM_KNOBS = ("bm", "bn", "bk")
_PLANNERS: Dict[str, Tuple[Tuple[str, ...], Callable[..., KernelPlan]]] = {
    **{route: (_GEMM_KNOBS, _masked(route)) for route in V.MASKED_ROUTES},
    "nm_spmm": (_GEMM_KNOBS, lambda dims, dtypes, params, tiles: V.plan_nm_spmm(
        dims["M"], dims["K"], dims["N"], n=params["n"], m=params["m"], **tiles,
        dtype=dtypes.get("x", "bfloat16"))),
    "flash_attention": (("bq", "bk"), lambda dims, dtypes, params, tiles: V.plan_flash_attention(
        dims["BH"], dims["Sq"], dims["Sk"], dims["d"], **tiles,
        dtype=dtypes.get("q", "bfloat16"), causal=bool(params.get("causal", True)))),
}


def build_plan(kernel: str, dims: Dict[str, int], dtypes: Dict[str, str],
               params: Dict[str, Any], tiles: Dict[str, int]) -> KernelPlan:
    """The plan a launch with these tiles would run (raises ``ValueError``
    exactly where the wrapper would)."""
    if kernel not in _PLANNERS:
        raise ValueError(f"unknown kernel {kernel!r}; tunable: {', '.join(_PLANNERS)}")
    names, builder = _PLANNERS[kernel]
    bad = set(tiles) - set(names)
    if bad:
        raise ValueError(f"{kernel}: unknown tile knobs {sorted(bad)}")
    return builder(dims, dtypes, params, tiles)


def _compiled(kernel: str, dims: Dict[str, int]) -> List[Dict[str, int]]:
    if kernel == "flash_attention":
        return [dict(bq=bq, bk=bk) for bq, bk in V.ATTN_TILES.get(dims.get("d"), ())]
    return [dict(bm=bm, bn=bn) for bm, bn in V.GEMM_TILES]


def candidate_tiles(kernel: str, dims: Dict[str, int], dtypes: Dict[str, str],
                    params: Optional[Dict[str, Any]] = None, *,
                    max_candidates: int = 8) -> List[Dict[str, int]]:
    """The launch's valid plans, the default's tiles first, each once (two
    requests that build the same plan are one candidate). An f32 launch
    (a SIMT kernel) has the one."""
    params = params or {}
    out: List[Dict[str, int]] = []
    seen: set = set()
    for tiles in [{}] + _compiled(kernel, dims):
        if len(out) >= max_candidates:
            break
        try:
            plan = build_plan(kernel, dims, dtypes, params, tiles)
        except ValueError:
            continue
        eff = tuple(sorted(plan.tiles.items()))
        if eff not in seen:
            seen.add(eff)
            out.append(dict(plan.tiles))
    return out


# ---------------------------------------------------------------------------
# the measured search
# ---------------------------------------------------------------------------
def _make_runner(kernel: str, dims: Dict[str, int], dtypes: Dict[str, str],
                 params: Dict[str, Any], device: torch.device) -> Callable:
    """A ``tiles -> output`` closure over operands made from a seeded
    generator on ``device``, shaped from ``dims``: the search measures the
    kernel, not the caller's data, and can run from anywhere. It launches
    through the wrappers' uncounted entries."""
    g = torch.Generator(device=device).manual_seed(0)

    def normal(*shape, dt="bfloat16"):
        return torch.randn(*shape, generator=g, device=device, dtype=getattr(torch, dt))

    if kernel in V.MASKED_ROUTES:
        from repro_torch.kernels.masked_matmul import ops as MM

        base = kernel.replace("masked_matmul_batched", "masked_matmul")
        lead = (dims["E"],) if base != kernel else ()
        M, K, N, dt = dims["M"], dims["K"], dims["N"], dtypes.get("x", "bfloat16")
        shapes = {"MK": (M, K), "MN": (M, N), "KN": (K, N)}
        ops = []
        for name, d in MM._OPERANDS[base][:3]:
            if name == "m":
                ops.append(torch.rand(*lead, K, N, generator=g, device=device) < 0.5)
            else:
                ops.append(normal(*lead, *shapes[d], dt=dt))
        return lambda tiles: MM.launch_uncounted(base, *ops, tiles)

    if kernel == "nm_spmm":
        from repro_torch.kernels.nm_spmm import ops as NM

        M, K, N, n, m = dims["M"], dims["K"], dims["N"], params["n"], params["m"]
        dt = dtypes.get("x", "bfloat16")
        rows = K // m * n
        # n distinct offsets in [0, m) for each (group, column)
        keys = torch.rand(K // m, N, m, generator=g, device=device)
        idx = keys.argsort(dim=-1)[..., :n].sort(dim=-1).values
        idx = idx.permute(0, 2, 1).reshape(rows, N).to(torch.int8)
        x, vals = normal(M, K, dt=dt), normal(rows, N, dt=dt)
        return lambda tiles: NM.launch_uncounted(x, vals, idx, n, m, tiles)

    if kernel == "flash_attention":
        from repro_torch.kernels.flash_attention import ops as FA

        dt = dtypes.get("q", "bfloat16")
        q = normal(dims["BH"], dims["Sq"], dims["d"], dt=dt)
        k = normal(dims["BH"], dims["Sk"], dims["d"], dt=dt)
        v = normal(dims["BH"], dims["Sk"], dims["d"], dt=dt)
        causal = bool(params.get("causal", True))
        return lambda tiles: FA.launch_uncounted(q, k, v, causal, 0, tiles)

    raise ValueError(f"unknown kernel {kernel!r}")


def _timed(run: Callable[[], Any], reps: int) -> float:
    """Median seconds of ``reps`` launches on the card, each between a CUDA
    event pair, after one untimed warm-up. The stream is held first (a spin
    kernel of about 20 ms) so the host queues every launch before the card
    reaches the first: the pairs time the kernel, not the host."""
    run()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(int(20e-3 * 1.98e9))
    for i in range(reps):
        ev[i].record()
        run()
    ev[reps].record()
    ev[reps].synchronize()
    # consecutive pairs share an event: each launch is one interval
    return statistics.median(ev[i].elapsed_time(ev[i + 1]) / 1e3 for i in range(reps))


def search(kernel: str, dims: Dict[str, int], dtypes: Dict[str, str],
           params: Optional[Dict[str, Any]] = None, *, device=None, reps: int = 5,
           max_candidates: int = 8) -> Dict[str, Any]:
    """Measure every candidate; the cache entry of the best. The default is
    measured inside the same sweep, so ``measured_s["best"] <=
    measured_s["default"]`` (an exact tie keeps the default). On the CPU
    the plain versions take no tiles: the entry is the default's, with
    ``measured_s`` None and one candidate."""
    params = params or {}
    device = torch.device(device if device is not None else "cuda")
    cands = candidate_tiles(kernel, dims, dtypes, params, max_candidates=max_candidates)
    if not cands:
        raise ValueError(f"{kernel}: no valid tile plan for dims {dims} (params {params})")
    entry = {"kernel": kernel, "dims": dict(dims), "dtypes": dict(dtypes),
             "params": dict(params), "backend": _backend_tag(device),
             "device_kind": _device_kind(device), "code_rev": code_rev()}
    if device.type != "cuda":
        return {**entry, "tiles": dict(cands[0]), "measured_s": None, "candidates": 1}
    runner = _make_runner(kernel, dims, dtypes, params, device)
    measured = [(_timed(lambda t=tiles: runner(t), reps), tiles) for tiles in cands]
    best_s, best_tiles = min(measured, key=lambda r: r[0])
    return {**entry, "tiles": dict(best_tiles),
            "measured_s": {"default": measured[0][0], "best": best_s,
                           "all": [[t, s] for s, t in measured]},
            "candidates": len(cands)}


def store(entry: Dict[str, Any]) -> str:
    """Put a :func:`search` entry into the persistent cache; its key."""
    _load()
    key = cache_key(entry["kernel"], entry["dims"], entry["dtypes"], entry["params"],
                    entry["backend"], entry["device_kind"], entry["code_rev"])
    _STATE.cache[key] = entry
    _STATE.checked = {}
    _save()
    return key


# ---------------------------------------------------------------------------
# resolution (the wrappers' entry point)
# ---------------------------------------------------------------------------
def mode() -> str:
    return _STATE.mode


def resolve(kernel: str, dims: Dict[str, int], dtypes: Dict[str, str],
            params: Optional[Dict[str, Any]] = None, *, device=None
            ) -> Tuple[Dict[str, int], Optional[str]]:
    """Tiles for this launch in the current mode: ``(tiles, source)``,
    source ``"cache"``, ``"search"``, ``"default"`` (a cache-mode miss) or
    None (mode off: the empty tiles are the kernel's default). A cached
    entry is built through its plan before its first use: an invalid one
    counts as a miss and is never launched. Each launch shape is looked up
    and checked once; later launches of it read the result."""
    from repro_torch.obs import metrics as OM

    if _STATE.mode == "off":
        return {}, None
    params = params or {}
    device = torch.device(device if device is not None else "cuda")
    shape = (kernel, tuple(dims.items()), tuple(dtypes.items()), tuple(params.items()), device)
    if shape in _STATE.checked:
        tiles = _STATE.checked[shape]
    else:
        tiles = _STATE.checked[shape] = _cached_tiles(kernel, dims, dtypes, params, device)
    if tiles is not None:
        _STATE.stats["hits"] += 1
        OM.counter("kernels/tuning/hits").inc()
        return dict(tiles), "cache"
    _STATE.stats["misses"] += 1
    OM.counter("kernels/tuning/misses").inc()
    if _STATE.mode != "search":
        return {}, "default"
    t0 = time.perf_counter()
    entry = search(kernel, dims, dtypes, params, device=device)
    dt = time.perf_counter() - t0
    _STATE.stats["searches"] += 1
    _STATE.stats["search_s"] += dt
    OM.counter("kernels/tuning/searches").inc()
    OM.histogram("kernels/tuning/search_s").observe(dt)
    _STATE.cache[_key(kernel, dims, dtypes, params, device)] = entry
    _STATE.checked[shape] = dict(entry["tiles"])
    _save()
    return dict(entry["tiles"]), "search"


def _key(kernel, dims, dtypes, params, device: torch.device) -> str:
    return cache_key(kernel, dims, dtypes, params, _backend_tag(device), _device_kind(device),
                     code_rev())


def _cached_tiles(kernel, dims, dtypes, params, device) -> Optional[Dict[str, int]]:
    """The cached entry's tiles for this launch, if it has a valid plan."""
    _load()
    entry = _STATE.cache.get(_key(kernel, dims, dtypes, params, device))
    tiles = entry.get("tiles") if isinstance(entry, dict) else None
    if not isinstance(tiles, dict):
        return None
    try:
        tiles = {k: int(v) for k, v in tiles.items()}
        build_plan(kernel, dims, dtypes, params, tiles)
    except (ValueError, TypeError):
        return None  # an invalid entry: a miss
    return tiles


# ---------------------------------------------------------------------------
# the launches of an EBFT walk, and pre-tuning them
# ---------------------------------------------------------------------------
def matmul_workloads(cfg, tokens: int) -> List[Tuple[str, int, int, int]]:
    """(label, M, K, N) of every distinct 2-D masked product a block of
    ``cfg`` launches on ``tokens`` rows (the port's copy of the reference's
    ``analysis/kernel_check.matmul_workloads``, with the port's own leaves:
    w_gate beside w_up, the Mamba projections in_B, in_C and in_dt, the
    MoE's shared experts and the encoder-decoder's memory)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    M = tokens
    out: List[Tuple[str, int, int, int]] = []
    if cfg.family != "ssm":
        out += [("wq", M, d, H * hd), ("wk", M, d, KV * hd), ("wv", M, d, KV * hd),
                ("wo", M, H * hd, d)]
    mlp = [("w_gate", M, d, cfg.d_ff), ("w_up", M, d, cfg.d_ff), ("w_down", M, cfg.d_ff, d)]
    if cfg.family == "moe":
        if cfg.moe_first_dense > 0 and cfg.d_ff > 0:
            out += mlp
        if cfg.moe_num_shared > 0:
            ff = cfg.moe_d_ff * cfg.moe_num_shared
            out += [("shared_w_gate", M, d, ff), ("shared_w_up", M, d, ff),
                    ("shared_w_down", M, ff, d)]
    elif cfg.family in ("ssm", "hybrid"):
        di, N, Hs = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_num_heads
        out += [("in_z", M, d, di), ("in_x", M, d, di), ("in_B", M, d, N), ("in_C", M, d, N),
                ("in_dt", M, d, Hs), ("out", M, di, d)]
        if cfg.family == "hybrid" and cfg.d_ff > 0:
            out += mlp
    elif cfg.d_ff > 0:
        out += mlp
    return out


def expert_workloads(cfg, tokens: int) -> List[Tuple[str, int, int, int, int]]:
    """(label, E, C, K, N) of the routed experts' batched products on a
    group of ``tokens``, at the walk's capacity C."""
    if cfg.family != "moe":
        return []
    E, k, ff, d = cfg.moe_num_experts, cfg.moe_top_k, cfg.moe_d_ff, cfg.d_model
    group = tokens // max(1, cfg.moe_dispatch_groups)
    C = max(1, int(cfg.moe_capacity_factor * group * k / E))
    return [("expert_up", E, C, d, ff), ("expert_down", E, C, ff, d)]


def ebft_workloads(cfg, tokens: int, seq: int,
                   pattern: Optional[Tuple[int, int]] = None) -> List[Tuple]:
    """(kernel, dims, dtypes, params) of every tunable launch an EBFT walk
    over ``cfg`` makes on microbatches of ``tokens`` = rows x ``seq``, in
    the config's dtype: the forward, dX and dW of each distinct 2-D weight
    shape, the batched forward, dX and dW of the routed experts at the
    walk's capacity, ``nm_spmm`` where ``pattern`` divides K, and the
    attention forward at the calibration length (an encoder-decoder's
    encoder and cross-attention too)."""
    dt = cfg.dtype
    mm = {"x": dt, "w": dt}
    work: List[Tuple] = []
    seen: set = set()
    rows = max(tokens // max(seq, 1), 1)
    groups = [(tokens, seq)]
    if cfg.family == "encdec":  # the encoder and the memory run on F frames a row
        frames = max(cfg.frontend_len, seq // 8)
        groups.append((rows * frames, frames))
    for M_rows, _ in groups:
        for _label, M, K, N in matmul_workloads(cfg, M_rows):
            if (M, K, N) in seen:
                continue
            seen.add((M, K, N))
            for route in ("masked_matmul", "masked_matmul_dx", "masked_matmul_dw"):
                work.append((route, {"M": M, "K": K, "N": N}, dict(mm), {}))
            if pattern is not None and K % pattern[1] == 0:
                work.append(("nm_spmm", {"M": M, "K": K, "N": N}, {"x": dt, "v": dt},
                             {"n": pattern[0], "m": pattern[1]}))
    for _label, E, C, K, N in expert_workloads(cfg, tokens):
        if (E, C, K, N) in seen:
            continue
        seen.add((E, C, K, N))
        for route in ("masked_matmul_batched", "masked_matmul_batched_dx",
                      "masked_matmul_batched_dw"):
            work.append((route, {"E": E, "M": C, "K": K, "N": N}, dict(mm), {}))
    if cfg.family != "ssm":
        hd, H = cfg.resolved_head_dim, cfg.num_heads
        attn = [(seq, seq, True)]
        if cfg.family == "encdec":
            attn += [(frames, frames, False), (seq, frames, False)]
        for Sq, Sk, causal in attn:
            work.append(("flash_attention", {"BH": rows * H, "Sq": Sq, "Sk": Sk, "d": hd},
                         {"q": dt}, {"causal": causal}))
    return work


def pretune(workloads: Sequence[Tuple], *, device=None) -> List[Dict]:
    """Resolve each workload in the current mode (searching and persisting
    the misses in ``search``); one record per workload."""
    out = []
    for kernel, dims, dtypes, params in workloads:
        tiles, source = resolve(kernel, dims, dtypes, params, device=device)
        out.append({"kernel": kernel, "dims": dict(dims), "source": source, "tiles": tiles})
    return out
