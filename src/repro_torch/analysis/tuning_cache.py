"""Analysis pass ``tuning_cache``: validate the autotuner's plan cache (the
port of ``repro.analysis.tuning_cache``).

The kernel autotuner (:mod:`repro_torch.kernels.tuning`) persists winning
tiles in a JSON cache (schema ``repro_torch.kernels.tuning/v1``) keyed by
launch shape, dtype, backend, device and ``code_rev``. This pass replays
every entry through ``tuning.build_plan``, the same
:mod:`repro_torch.kernels.validation` builders the wrappers launch
through, so a cache that was hand-edited, written by other sources, or
torn by a partial copy fails before it can steer a launch.

Codes:

  * TUN001 (error) — the builder rejects the cached tiles for the entry's
    own dims (the launch would raise, or the cache was edited);
  * TUN002 (error) — the cached plan's dynamic shared memory is above a
    block's ``SMEM_MAX`` (the builder's own refusal of it counts here);
  * TUN003 (warn)  — the entry's ``code_rev`` no longer matches the current
    kernel sources: dead weight, re-tune or prune it;
  * TUN004 (error) — malformed file, schema, or entry (missing fields,
    wrong types, unknown kernel).

A missing cache file is not a finding — most checkouts never tune.
"""
from __future__ import annotations

import json
from typing import Any, List, Optional

from repro_torch.analysis.findings import Finding
from repro_torch.kernels import tuning
from repro_torch.kernels import validation as V

_PASS = "tuning_cache"
_ENTRY_FIELDS = ("kernel", "dims", "dtypes", "params", "tiles", "code_rev")


def _finding(code: str, severity: str, message: str,
             location: str = "") -> Finding:
    return Finding(code=code, severity=severity, pass_name=_PASS,
                   message=message, location=location)


def _check_entry(key: str, entry: Any, current_rev: str) -> List[Finding]:
    # keys are long ("kernel|dims|dtypes|params|backend|device|rev");
    # point findings at the readable kernel|dims prefix
    loc = "|".join(key.split("|")[:2])
    if not isinstance(entry, dict):
        return [_finding("TUN004", "error",
                         f"entry is {type(entry).__name__}, expected object",
                         loc)]
    missing = [f for f in _ENTRY_FIELDS if f not in entry]
    if missing:
        return [_finding("TUN004", "error",
                         f"entry missing field(s): {', '.join(missing)}",
                         loc)]

    out: List[Finding] = []
    rev = entry["code_rev"]
    if rev != current_rev:
        out.append(_finding(
            "TUN003", "warn",
            f"stale code_rev {rev!r} (current {current_rev!r}): entry can "
            "never hit — re-tune or prune it", loc,
        ))

    kernel, dims, dtypes = entry["kernel"], entry["dims"], entry["dtypes"]
    params, tiles = entry["params"], entry["tiles"]
    if kernel not in tuning.KERNELS:
        out.append(_finding("TUN004", "error",
                            f"unknown kernel {kernel!r}; tunable: "
                            f"{', '.join(tuning.KERNELS)}", loc))
        return out
    if not all(isinstance(x, dict) for x in (dims, dtypes, params, tiles)):
        out.append(_finding("TUN004", "error",
                            "dims/dtypes/params/tiles must be objects", loc))
        return out
    try:
        plan = tuning.build_plan(
            kernel,
            {k: int(v) for k, v in dims.items()},
            {k: str(v) for k, v in dtypes.items()},
            dict(params),
            {k: int(v) for k, v in tiles.items()},
        )
    except ValueError as e:
        code = "TUN002" if "shared memory" in str(e) else "TUN001"
        out.append(_finding(
            code, "error",
            f"cached tiles {tiles} rejected by the plan builder: {e}", loc,
        ))
        return out
    except (TypeError, KeyError) as e:
        out.append(_finding(
            "TUN004", "error",
            f"entry fields do not form a plannable launch: "
            f"{type(e).__name__}: {e}", loc,
        ))
        return out

    if plan.smem > V.SMEM_MAX:
        out.append(_finding(
            "TUN002", "error",
            f"cached plan needs {plan.smem} B of shared memory, a block has "
            f"{V.SMEM_MAX} B — the search never admits this; the entry was "
            "edited or produced by other constraints", loc,
        ))
    return out


def check_cache(path: Optional[str] = None) -> List[Finding]:
    """Validate the plan cache at ``path`` (default: the tuner's current
    cache path). Missing file → no findings; anything unreadable or
    inconsistent → TUN0xx findings."""
    path = path or tuning.state()["path"]
    try:
        with open(path) as f:
            payload = json.load(f)
    except FileNotFoundError:
        return []
    except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
        return [_finding("TUN004", "error",
                         f"cannot load cache: {type(e).__name__}: {e}", path)]

    if not isinstance(payload, dict):
        return [_finding("TUN004", "error",
                         f"cache is {type(payload).__name__}, "
                         "expected object", path)]
    if payload.get("schema") != tuning.SCHEMA:
        return [_finding(
            "TUN004", "error",
            f"cache schema {payload.get('schema')!r}, expected "
            f"{tuning.SCHEMA!r}", path,
        )]
    entries = payload.get("entries")
    if not isinstance(entries, dict):
        return [_finding("TUN004", "error",
                         "cache has no 'entries' object", path)]

    current_rev = tuning.code_rev()
    out: List[Finding] = []
    for key in sorted(entries):
        out.extend(_check_entry(key, entries[key], current_rev))
    return out
