"""Machine-readable code certificates — what the symbolic verifier emits
(the port's copy of `repro.analysis.certificate`; the same schema and the
same bytes).

A `Certificate` is the static-analysis counterpart of a benchmark JSON:
one record per (code, placement) stating *which invariants were proven,
by what method, over which inputs* — so `benchmarks/check_regression.py`
can gate CI on "every paper-grid code still certifies" and tests can pin
individual claims without re-running the algebra.

Claims are named facts with a `method` string recording how they were
established (`algebraic` = exact GF identity, `exhaustive` = every
pattern enumerated, `sampled(...)` = seeded deterministic battery), so a
downstream reader can tell a proof from a probabilistic check. The
verifier also records the kernel-launch delta observed while certifying:
the whole point of the symbolic pillar is that certification moves ZERO
bytes through the kernels, and the certificate carries the evidence.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any

# Schema history:
#   1 — initial; serialization was dict-ordered, so equal
#       certificates could emit different bytes.
#   2 — deterministic serialization: every json.dumps sorts keys, so
#       byte-equal JSON <=> equal certificate content and artifacts
#       diff cleanly in CI (golden-file test pins this).
CERTIFICATE_VERSION = 2


@dataclasses.dataclass(frozen=True)
class Claim:
    """One proven (or refuted) invariant.

    `ok` is the verdict, `method` how it was reached, `detail` a human
    sentence, and `data` small machine-readable evidence (counts, the
    offending pattern on failure, ...)."""

    name: str
    ok: bool
    method: str
    detail: str = ""
    data: dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Claim":
        return cls(name=str(d["name"]), ok=bool(d["ok"]),
                   method=str(d["method"]), detail=str(d.get("detail", "")),
                   data=dict(d.get("data", {})))


@dataclasses.dataclass(frozen=True)
class Certificate:
    """All claims proven for one (code, placement) pair."""

    code_name: str
    placement_name: str
    params: dict[str, Any]            # n, k, r, d, family, alpha/z/t ...
    claims: tuple[Claim, ...]
    kernel_launches: int              # launch delta during certification
    version: int = CERTIFICATE_VERSION

    @property
    def all_ok(self) -> bool:
        return all(c.ok for c in self.claims)

    def claim(self, name: str) -> Claim:
        for c in self.claims:
            if c.name == name:
                return c
        raise KeyError(f"{self.code_name}: no claim named {name!r}")

    def failures(self) -> list[Claim]:
        return [c for c in self.claims if not c.ok]

    def to_dict(self) -> dict[str, Any]:
        return {
            "version": self.version,
            "code": self.code_name,
            "placement": self.placement_name,
            "params": self.params,
            "kernel_launches": self.kernel_launches,
            "claims": [c.to_dict() for c in self.claims],
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Certificate":
        return cls(code_name=str(d["code"]),
                   placement_name=str(d["placement"]),
                   params=dict(d["params"]),
                   claims=tuple(Claim.from_dict(c) for c in d["claims"]),
                   kernel_launches=int(d["kernel_launches"]),
                   version=int(d.get("version", CERTIFICATE_VERSION)))

    def to_json(self, indent: int | None = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "Certificate":
        return cls.from_dict(json.loads(s))

    def summary(self) -> str:
        ok = sum(1 for c in self.claims if c.ok)
        verdict = "OK" if self.all_ok else "FAIL"
        return (f"{verdict} {self.code_name} [{self.placement_name}]: "
                f"{ok}/{len(self.claims)} claims, "
                f"{self.kernel_launches} kernel launches")


def dump_certificates(certs: list[Certificate],
                      indent: int | None = 2) -> str:
    """Serialize a certificate batch (the --grid CLI output) to JSON.
    Deterministic byte-for-byte: keys are sorted at every level, so two
    batches with equal content always serialize identically."""
    return json.dumps({"version": CERTIFICATE_VERSION,
                       "certificates": [c.to_dict() for c in certs]},
                      indent=indent, sort_keys=True)


def load_certificates(s: str) -> list[Certificate]:
    d = json.loads(s)
    return [Certificate.from_dict(c) for c in d["certificates"]]
