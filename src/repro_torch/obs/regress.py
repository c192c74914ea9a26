"""Perf-regression gate: committed ``BENCH_*.json`` baselines as contracts.

A copy of the JAX package's ``obs/regress.py`` (which the port may not
import); it imports no jax there either.  The port has no benchmark
artifacts of its own yet (``ROADMAP.md`` step A.12 adds them and
``tools/bench_gate_torch.py``), so today this module is the library those
will drive.

The benchmark harness writes three JSON artifacts per run
(``BENCH_query.json``, ``BENCH_mutation.json``, ``BENCH_serving.json``),
and a baseline of each is committed at the repo root.  The functions here
make them enforced contracts:

1. **Workload stamps** must match: a fresh report produced at a different
   dataset / codec / backend / size than its baseline is not comparable,
   and the gate refuses the comparison.
2. **Throughput ratios**: every ``*qps*`` leaf shared by fresh and baseline
   must satisfy ``fresh >= baseline * min_ratio``.  ``min_ratio`` comes from
   the committed ``BENCH_tolerances.json`` next to the baselines (default
   0.55: a true 2x regression lands at ratio 0.5 and fails).
3. **Hard invariants** on the fresh report, never subject to tolerance:
   the resident paths' zero per-round host syncs (``cand_syncs == 0`` /
   ``score_syncs == 0``), block-max pruning armed under 1% tombstones
   (``blocks_pruned > 0``), per-batch decode dedup
   (``decodes_per_hot_block <= 1``), zero cross-shard round syncs, zero
   Poisson shed, and bitwise serving parity.

Timings vary between runs; the workload does not (fixed RNG seeds), which is
what makes 2 and 3 sound.
"""

from __future__ import annotations

import copy
import dataclasses
import fnmatch
import json
import os

# the artifacts under contract: (kind, filename, workload-stamp keys)
ARTIFACTS = (
    ("query", "BENCH_query.json",
     ("dataset", "codec", "backend", "n_queries")),
    ("mutation", "BENCH_mutation.json",
     ("dataset", "codec", "backend", "n_queries", "n_docs", "n_delta_docs")),
    ("serving", "BENCH_serving.json",
     ("dataset", "codec", "backend", "n_requests", "rate_qps",
      "deadline_ms")),
)

DEFAULT_MIN_RATIO = 0.55
TOLERANCES_FILE = "BENCH_tolerances.json"


@dataclasses.dataclass(frozen=True)
class Violation:
    artifact: str
    kind: str           # "workload" | "ratio" | "invariant"
    path: str
    detail: str

    def __str__(self):
        return f"[{self.artifact}:{self.kind}] {self.path}: {self.detail}"


@dataclasses.dataclass
class GateResult:
    violations: list
    checked_ratios: int = 0
    checked_invariants: int = 0

    @property
    def passed(self) -> bool:
        return not self.violations

    def summary(self) -> str:
        head = (f"bench gate: {self.checked_ratios} ratio(s) + "
                f"{self.checked_invariants} invariant(s) checked, "
                f"{len(self.violations)} violation(s)")
        return "\n".join([head] + [f"  FAIL {v}" for v in self.violations])


# --------------------------------------------------------------------------- #
# qps-leaf discovery + tolerances
# --------------------------------------------------------------------------- #

def iter_qps_leaves(report, _path=()):
    """Yield ``(dotted_path, value)`` for every numeric leaf whose path
    names a throughput metric (a component containing ``qps``) — the set of
    ratio-gated metrics.  Latency percentiles are deliberately not gated by
    default (tail latencies on shared CI runners are too noisy for a hard
    floor); add explicit patterns to the tolerances file to gate more."""
    if isinstance(report, dict):
        for k in sorted(report):
            yield from iter_qps_leaves(report[k], _path + (str(k),))
    elif isinstance(report, (int, float)) and not isinstance(report, bool):
        if any("qps" in comp for comp in _path):
            yield ".".join(_path), float(report)


def load_tolerances(path: str) -> dict:
    """``BENCH_tolerances.json``: ``{"defaults": {"min_ratio": ...},
    "overrides": [{"artifact": ..., "pattern": ..., "min_ratio": ...}]}``.
    Missing file -> library defaults."""
    if path is None or not os.path.exists(path):
        return {"defaults": {"min_ratio": DEFAULT_MIN_RATIO}, "overrides": []}
    with open(path) as f:
        tol = json.load(f)
    tol.setdefault("defaults", {}).setdefault("min_ratio", DEFAULT_MIN_RATIO)
    tol.setdefault("overrides", [])
    return tol


def min_ratio_for(tol: dict, artifact: str, path: str) -> float:
    """The floor for one metric: the last matching override wins, else the
    default.  ``min_ratio: 0`` disables the metric's ratio check."""
    r = float(tol["defaults"]["min_ratio"])
    for ov in tol["overrides"]:
        if ov.get("artifact") not in (None, artifact):
            continue
        if fnmatch.fnmatchcase(path, ov.get("pattern", "*")):
            r = float(ov.get("min_ratio", r))
    return r


# --------------------------------------------------------------------------- #
# the three checks
# --------------------------------------------------------------------------- #

def check_workload(artifact: str, keys: tuple, fresh: dict,
                   baseline: dict) -> list:
    out = []
    for k in keys:
        fv, bv = fresh.get(k), baseline.get(k)
        if fv != bv:
            out.append(Violation(
                artifact, "workload", k,
                f"fresh={fv!r} baseline={bv!r} — reports are not comparable "
                f"(regenerate the committed baseline at the CI workload)"))
    return out


def compare_reports(artifact: str, fresh: dict, baseline: dict,
                    tol: dict) -> tuple:
    """Ratio-gate every qps leaf present in BOTH reports.  Returns
    (violations, n_checked).  Leaves only one side has (a new benchmark
    section mid-PR) are skipped — the next baseline refresh picks them up."""
    base = dict(iter_qps_leaves(baseline))
    out, n = [], 0
    for path, fv in iter_qps_leaves(fresh):
        bv = base.get(path)
        if bv is None or bv <= 0.0:
            continue
        floor = min_ratio_for(tol, artifact, path)
        if floor <= 0.0:
            continue
        n += 1
        ratio = fv / bv
        if ratio < floor:
            out.append(Violation(
                artifact, "ratio", path,
                f"fresh {fv:.1f} / baseline {bv:.1f} = {ratio:.3f}x "
                f"< min_ratio {floor}"))
    return out, n


def _get(d: dict, *path):
    for p in path:
        if not isinstance(d, dict) or p not in d:
            return None
        d = d[p]
    return d


def check_invariants(artifact: str, fresh: dict) -> tuple:
    """The deterministic structural guarantees on a fresh report (never
    subject to tolerance).  Returns (violations, n_checked)."""
    out, n = [], 0

    def req(cond, path, detail):
        nonlocal n
        n += 1
        if not cond:
            out.append(Violation(artifact, "invariant", path, detail))

    if artifact == "query":
        d = _get(fresh, "decodes_per_hot_block")
        if d is not None:
            req(d <= 1.0 + 1e-9, "decodes_per_hot_block",
                f"{d} > 1: a hot (term, block) decoded more than once per "
                f"batch (work-list dedup regressed)")
        for pl in ("device", "fused"):
            s = _get(fresh, "placements", pl, "host_syncs_per_query")
            if s is not None:
                req(s == 0, f"placements.{pl}.host_syncs_per_query",
                    f"{s} != 0: resident AND rounds synced candidates")
        for mode in ("or", "and_scored"):
            s = _get(fresh, "ranked", mode, "host_syncs_per_query")
            if s is not None:
                req(s == 0, f"ranked.{mode}.host_syncs_per_query",
                    f"{s} != 0: resident ranked rounds synced scores")
        p = _get(fresh, "ranked", "or", "blocks_pruned")
        if p is not None:
            req(p > 0, "ranked.or.blocks_pruned",
                "0: block-max pruning disarmed on the OR path")
        for nsh, cell in (fresh.get("sharded") or {}).items():
            s = _get(cell, "cross_shard_round_syncs")
            if s is not None:
                req(s == 0, f"sharded.{nsh}.cross_shard_round_syncs",
                    f"{s} != 0: shard rounds crossed the doc partition")
    elif artifact == "mutation":
        for dens, cell in (fresh.get("tombstone_qps") or {}).items():
            req(_get(cell, "cand_syncs") == 0,
                f"tombstone_qps.{dens}.cand_syncs",
                f"{_get(cell, 'cand_syncs')} != 0: tombstone gating left "
                f"the device")
        r = fresh.get("ranked_tomb_1pct") or {}
        req(_get(r, "score_syncs") == 0, "ranked_tomb_1pct.score_syncs",
            f"{_get(r, 'score_syncs')} != 0")
        req((_get(r, "blocks_pruned") or 0) > 0,
            "ranked_tomb_1pct.blocks_pruned",
            "0: block-max pruning disarmed under the 1% tombstone epoch "
            "(the idf-ratio re-arm regressed)")
    elif artifact == "serving":
        for arrival, cells in (fresh.get("arrivals") or {}).items():
            for pl, cell in cells.items():
                if arrival == "poisson":
                    req(_get(cell, "shed_rate") == 0.0,
                        f"arrivals.poisson.{pl}.shed_rate",
                        f"{_get(cell, 'shed_rate')} != 0: the Poisson smoke "
                        f"load shed requests the engine had budget for")
                req(_get(cell, "parity_ok") is True,
                    f"arrivals.{arrival}.{pl}.parity_ok",
                    "served results diverged from the offline "
                    "plan/execute oracle")
    return out, n


# --------------------------------------------------------------------------- #
# the gate + the self-test synthesizer
# --------------------------------------------------------------------------- #

def load_report(path: str):
    with open(path) as f:
        return json.load(f)


def run_gate(fresh_dir: str, baseline_dir: str,
             tolerances_path: str = None, artifacts=None) -> GateResult:
    """Gate every artifact present in ``baseline_dir`` against its fresh
    counterpart in ``fresh_dir``.  A committed baseline whose fresh file is
    missing is a violation (the benchmark that produces it stopped
    running); a fresh file with no baseline is skipped."""
    if tolerances_path is None:
        tolerances_path = os.path.join(baseline_dir, TOLERANCES_FILE)
    tol = load_tolerances(tolerances_path)
    res = GateResult(violations=[])
    for kind, fname, stamp_keys in (artifacts or ARTIFACTS):
        bpath = os.path.join(baseline_dir, fname)
        fpath = os.path.join(fresh_dir, fname)
        if not os.path.exists(bpath):
            continue
        if not os.path.exists(fpath):
            res.violations.append(Violation(
                kind, "workload", fname,
                f"baseline committed but no fresh report at {fpath}"))
            continue
        fresh, baseline = load_report(fpath), load_report(bpath)
        res.violations += check_workload(kind, stamp_keys, fresh, baseline)
        v, n = compare_reports(kind, fresh, baseline, tol)
        res.violations += v
        res.checked_ratios += n
        v, n = check_invariants(kind, fresh)
        res.violations += v
        res.checked_invariants += n
    return res


def synthesize_regression(report: dict, factor: float = 0.5) -> dict:
    """A deep copy of ``report`` with every ratio-gated qps leaf (exactly
    the :func:`iter_qps_leaves` set) scaled by ``factor`` — the gate
    self-test's synthetic 2x regression (``factor=0.5``).  Workload stamps
    and invariant fields are untouched, so only ratio checks should fire.
    Operates on JSON-loaded reports (string keys throughout)."""
    out = copy.deepcopy(report)
    for path, _ in iter_qps_leaves(report):
        comps = path.split(".")
        node = out
        for c in comps[:-1]:
            node = node[c]
        node[comps[-1]] = node[comps[-1]] * factor
    return out
