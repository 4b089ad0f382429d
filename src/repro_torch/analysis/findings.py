"""Finding / Report types shared by every analysis pass (a copy of
``repro.analysis.findings``).

A :class:`Finding` is one violation (or observation) with a stable code —
codes are what ``--ignore`` silences (``repro_torch.analysis`` lists them).
Severities: ``error`` (would mis-compute or fail at runtime), ``warn``
(probably wrong or wasteful), ``info`` (worth knowing).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterable, List, Optional

SEVERITIES = ("info", "warn", "error")
_RANK = {s: i for i, s in enumerate(SEVERITIES)}


@dataclasses.dataclass(frozen=True)
class Finding:
    code: str          # stable id, e.g. "KER001"
    severity: str      # "error" | "warn" | "info"
    pass_name: str     # "kernels" | "masks" | "graph" | "sharding" | ...
    message: str
    config: str = ""   # config the finding applies to ("" = config-independent)
    location: str = "" # kernel/leaf/eqn the finding points at

    def __post_init__(self):
        if self.severity not in _RANK:
            raise ValueError(f"unknown severity {self.severity!r}")

    def asdict(self) -> Dict[str, str]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Report:
    findings: List[Finding] = dataclasses.field(default_factory=list)
    passes_run: List[str] = dataclasses.field(default_factory=list)
    configs_checked: List[str] = dataclasses.field(default_factory=list)

    def add(self, findings: Iterable[Finding]) -> None:
        self.findings.extend(findings)

    def without(self, ignored_codes: Iterable[str]) -> "Report":
        ignored = set(ignored_codes)
        return dataclasses.replace(
            self, findings=[f for f in self.findings if f.code not in ignored]
        )

    def count(self, severity: str) -> int:
        return sum(1 for f in self.findings if f.severity == severity)

    def max_severity(self) -> Optional[str]:
        if not self.findings:
            return None
        return max((f.severity for f in self.findings), key=_RANK.get)

    def exit_code(self, fail_on: str = "error") -> int:
        """0 when no finding reaches the ``fail_on`` severity."""
        if fail_on == "never":
            return 0
        threshold = _RANK[fail_on]
        return int(any(_RANK[f.severity] >= threshold for f in self.findings))

    # ------------------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(
            {
                "passes": self.passes_run,
                "configs": self.configs_checked,
                "counts": {s: self.count(s) for s in SEVERITIES},
                "findings": [f.asdict() for f in self.findings],
            },
            indent=2,
        )

    def to_text(self) -> str:
        lines: List[str] = []
        order = sorted(
            self.findings, key=lambda f: (-_RANK[f.severity], f.pass_name, f.code)
        )
        for f in order:
            where = " ".join(x for x in (f.config, f.location) if x)
            lines.append(
                f"{f.severity.upper():5s} {f.code} [{f.pass_name}]"
                + (f" {where}:" if where else "")
                + f" {f.message}"
            )
        counts = ", ".join(f"{self.count(s)} {s}" for s in reversed(SEVERITIES))
        lines.append(
            f"-- {len(self.findings)} finding(s) ({counts}) across "
            f"{len(self.configs_checked)} config(s), "
            f"passes: {', '.join(self.passes_run) or 'none'}"
        )
        return "\n".join(lines)
