"""Contract diffing: golden vs current, with a drift report that names the
rank, scope and class (counterpart of ``mpi4dl_tpu/analysis/contracts/
diff.py``).

Drift records are dicts with a ``kind`` discriminator, the JAX gate's:

- ``collective``: per (scope, class) count/byte delta;
- ``axis-collective``: per (mesh dimension, class) delta;
- ``scope-coverage``: a scope path appeared or disappeared;
- ``overlap``: per (scope, class) async/sync counts, bytes, exposed bytes;
- ``ircheck``: the cross-rank verifier's per-kind finding count moved;
- ``inputs``: a rank's batch shapes or state leaves/bytes changed (the
  counterpart of ``sharding``);
- ``kernels``: a Hopper kernel symbol's resources moved (``kernels.json``);
- ``meta``: schema/engine mismatch, or the ranks differ (golden unusable).

:func:`diff_rank` diffs one rank's section exactly as the JAX
``diff_contracts`` diffs a whole contract's ``collectives``,
``axis_collectives``, ``scopes`` and ``overlap`` (same records, same
order); :func:`diff_contracts` runs it over every rank and tags each record
with ``rank``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple


def _counted(d: dict, *path) -> dict:
    for key in path:
        d = d.get(key, {}) if isinstance(d, dict) else {}
    return d if isinstance(d, dict) else {}


def _diff_counted_tree(kind: str, golden: dict, current: dict, label: str) -> List[dict]:
    """Diff two {outer: {op: {count, bytes}}} trees into drift records."""
    out: List[dict] = []
    for outer in sorted(set(golden) | set(current)):
        g_ops, c_ops = golden.get(outer, {}), current.get(outer, {})
        for op in sorted(set(g_ops) | set(c_ops)):
            g = g_ops.get(op, {"count": 0, "bytes": 0})
            c = c_ops.get(op, {"count": 0, "bytes": 0})
            if g == c:
                continue
            out.append({
                "kind": kind, label: outer, "op": op,
                "count_golden": g.get("count", 0), "count_current": c.get("count", 0),
                "bytes_golden": g.get("bytes", 0), "bytes_current": c.get("bytes", 0),
            })
    return out


_OVERLAP_FIELDS = ("async_pairs", "sync", "bytes", "exposed_bytes")
_OVERLAP_ZERO = {f: 0 for f in _OVERLAP_FIELDS}


def _diff_overlap(golden: dict, current: dict) -> List[dict]:
    out: List[dict] = []
    for scope in sorted(set(golden) | set(current)):
        g_ops, c_ops = golden.get(scope, {}), current.get(scope, {})
        for op in sorted(set(g_ops) | set(c_ops)):
            g = {**_OVERLAP_ZERO, **g_ops.get(op, {})}
            c = {**_OVERLAP_ZERO, **c_ops.get(op, {})}
            if g == c:
                continue
            rec = {"kind": "overlap", "scope": scope, "op": op}
            for f in _OVERLAP_FIELDS:
                rec[f"{f}_golden"] = g[f]
                rec[f"{f}_current"] = c[f]
            out.append(rec)
    return out


def diff_rank(golden: dict, current: dict) -> List[dict]:
    """Drift records between two rank sections (module docstring)."""
    drifts = _diff_counted_tree("collective", _counted(golden, "collectives"),
                                _counted(current, "collectives"), "scope")
    drifts += _diff_counted_tree("axis-collective", _counted(golden, "axis_collectives"),
                                 _counted(current, "axis_collectives"), "axis")
    g_scopes = set(golden.get("scopes", ()))
    c_scopes = set(current.get("scopes", ()))
    drifts += [{"kind": "scope-coverage", "scope": n, "change": "lost"}
               for n in sorted(g_scopes - c_scopes)]
    drifts += [{"kind": "scope-coverage", "scope": n, "change": "gained"}
               for n in sorted(c_scopes - g_scopes)]
    drifts += _diff_overlap(_counted(golden, "overlap", "per_scope"),
                            _counted(current, "overlap", "per_scope"))
    return drifts


def _meta(golden: dict, current: dict, fields) -> List[dict]:
    return [{"kind": "meta", "field": f, "golden": golden.get(f), "current": current.get(f)}
            for f in fields if golden.get(f) != current.get(f)]


def diff_contracts(golden: dict, current: dict) -> List[dict]:
    """All drift records between a golden and a current family contract.
    Empty list = the step still honors the contract."""
    drifts = _meta(golden, current, ("schema", "engine"))
    g_ranks, c_ranks = golden.get("ranks", {}), current.get("ranks", {})
    if sorted(g_ranks) != sorted(c_ranks):
        drifts.append({"kind": "meta", "field": "ranks",
                       "golden": sorted(g_ranks), "current": sorted(c_ranks)})
    if drifts:
        return drifts  # mismatched contracts: field diffs are meaningless
    for rank in sorted(g_ranks, key=int):
        drifts += [{**d, "rank": int(rank)} for d in diff_rank(g_ranks[rank], c_ranks[rank])]
    g_in, c_in = golden.get("inputs", {}), current.get("inputs", {})
    for rank in sorted(set(g_in) | set(c_in), key=int):
        for field in sorted(set(g_in.get(rank, {})) | set(c_in.get(rank, {}))):
            g, c = g_in.get(rank, {}).get(field), c_in.get(rank, {}).get(field)
            if g != c:
                drifts.append({"kind": "inputs", "rank": int(rank), "field": field,
                               "golden": g, "current": c})
    g_irc, c_irc = _counted(golden, "ircheck"), _counted(current, "ircheck")
    for name in sorted(set(g_irc) | set(c_irc)):
        if g_irc.get(name, 0) != c_irc.get(name, 0):
            drifts.append({"kind": "ircheck", "finding": name,
                           "count_golden": g_irc.get(name, 0),
                           "count_current": c_irc.get(name, 0)})
    return drifts


# ---------------------------------------------------------------------------
# The Hopper kernels' contract (kernels.json; analysis/pallascheck)
# ---------------------------------------------------------------------------

def diff_kernels_contract(golden: dict, current: dict) -> List[dict]:
    """Drift records between two ``kernels`` contracts
    (``pallascheck.kernels_contract``): per kernel symbol, each resource;
    per registry kernel, the symbols its rows launch."""
    drifts = _meta(golden, current, ("schema", "smem_frac"))
    if drifts:
        return drifts
    g_s, c_s = golden.get("symbols", {}), current.get("symbols", {})
    for sym in sorted(set(g_s) | set(c_s)):
        if sym not in g_s or sym not in c_s:
            drifts.append({"kind": "kernels", "kernel": sym, "field": "presence",
                           "golden": sym in g_s, "current": sym in c_s})
            continue
        for field in sorted(set(g_s[sym]) | set(c_s[sym])):
            if g_s[sym].get(field) != c_s[sym].get(field):
                drifts.append({"kind": "kernels", "kernel": sym, "field": field,
                               "golden": g_s[sym].get(field), "current": c_s[sym].get(field)})
    for table in ("kernels", "cases"):
        g_k, c_k = golden.get(table, {}), current.get(table, {})
        for name in sorted(set(g_k) | set(c_k)):
            if g_k.get(name) != c_k.get(name):
                drifts.append({"kind": "kernels", "kernel": name, "field": table,
                               "golden": g_k.get(name), "current": c_k.get(name)})
    return drifts


# ---------------------------------------------------------------------------
# Quantized-contract byte-ratio gate
# ---------------------------------------------------------------------------

# The wire classes the --quant ratio gate enforces (the JAX gate's); the
# handoff is reported, not gated.  The frozen families run one spatial
# level, so respatial is vacuous here.
QUANT_GATED_CLASSES = ("junction", "respatial", "grad")


def quant_class_bytes(contract: dict) -> Dict[str, int]:
    """Per-quant-class byte sums over every rank's per-scope collectives
    (classes from ``quant.policy.scope_quant_class``)."""
    from mpi4dl_tpu_torch.quant.policy import scope_quant_class

    out: Dict[str, int] = {}
    for section in (contract.get("ranks") or {}).values():
        for scope, ops in (section.get("collectives") or {}).items():
            cls = scope_quant_class(scope)
            if cls is None:
                continue
            out[cls] = out.get(cls, 0) + sum(v.get("bytes", 0) for v in ops.values())
    return out


def quant_byte_ratios(raw: dict, quant: dict, max_ratio: float
                      ) -> Tuple[List[dict], List[str]]:
    """A quantized contract's hot-class bytes against the raw golden's:
    ``(rows, breach_lines)``; a class the family does not exercise (raw 0)
    passes vacuously."""
    rb, qb = quant_class_bytes(raw), quant_class_bytes(quant)
    rows: List[dict] = []
    breaches: List[str] = []
    for cls in sorted(set(rb) | set(qb)):
        r, q = rb.get(cls, 0), qb.get(cls, 0)
        ratio = (q / r) if r else None
        gated = cls in QUANT_GATED_CLASSES
        rows.append({"class": cls, "raw_bytes": r, "quant_bytes": q,
                     "ratio": None if ratio is None else round(ratio, 4), "gated": gated})
        if gated and ratio is not None and ratio > max_ratio:
            breaches.append(f"class {cls}: quantized bytes {q} > {max_ratio:g} x raw "
                            f"{r} (ratio {ratio:.3f})")
    return rows, breaches


def render_ratio_report(engine: str, rows: List[dict], breaches: List[str],
                        max_ratio: float) -> str:
    lines = [f"quant byte ratio: engine {engine} (gate <= {max_ratio:g}x on "
             f"{'/'.join(QUANT_GATED_CLASSES)})"]
    for r in rows:
        ratio = "n/a" if r["ratio"] is None else f"{r['ratio']:.3f}x"
        mark = "" if r["gated"] else "  (reported, not gated)"
        lines.append(f"  {r['class']:<10} raw {r['raw_bytes']:>12} -> quant "
                     f"{r['quant_bytes']:>12}  {ratio}{mark}")
    lines += [f"  BREACH: {b}" for b in breaches]
    return "\n".join(lines)


def _fmt_delta(golden: int, current: int) -> str:
    delta = current - golden
    return f"{golden} -> {current} ({'+' if delta >= 0 else ''}{delta})"


def _where(d: dict) -> str:
    return f"rank {d['rank']} " if "rank" in d else ""


def render_drift_report(engine: str, drifts: List[dict]) -> str:
    """Human-readable drift report for one family (or ``kernels``)."""
    if not drifts:
        return f"contract ok: engine {engine}"
    lines = [f"contract DRIFT: engine {engine} ({len(drifts)} finding(s))"]
    for d in drifts:
        kind = d["kind"]
        if kind == "meta":
            lines.append(f"  {d['field']} mismatch: golden {d['golden']!r} vs current "
                         f"{d['current']!r} — regenerate with --update")
        elif kind in ("collective", "axis-collective"):
            where = ("scope " + d["scope"]) if kind == "collective" else (
                "mesh dimension " + d["axis"])
            g_n, c_n = d["count_golden"], d["count_current"]
            if g_n == 0:
                verb = f"{d['op']} APPEARED (count {c_n}, {d['bytes_current']} bytes)"
            elif c_n == 0:
                verb = f"{d['op']} DISAPPEARED (was count {g_n}, {d['bytes_golden']} bytes)"
            else:
                verb = (f"{d['op']} count {_fmt_delta(g_n, c_n)}, bytes "
                        f"{_fmt_delta(d['bytes_golden'], d['bytes_current'])}")
            lines.append(f"  {_where(d)}{where}: {verb}")
        elif kind == "scope-coverage":
            lines.append(f"  {_where(d)}scope coverage {d['change']}: {d['scope']}")
        elif kind == "overlap":
            bits = [f"{f} {_fmt_delta(d[f'{f}_golden'], d[f'{f}_current'])}"
                    for f in _OVERLAP_FIELDS if d[f"{f}_golden"] != d[f"{f}_current"]]
            lines.append(f"  {_where(d)}overlap scope {d['scope']}: {d['op']} "
                         + ", ".join(bits))
        elif kind == "ircheck":
            lines.append(f"  ircheck finding {d['finding']}: count "
                         f"{_fmt_delta(d['count_golden'], d['count_current'])} — run "
                         "`python -m mpi4dl_tpu_torch.analysis ircheck` for details")
        elif kind == "inputs":
            lines.append(f"  {_where(d)}inputs.{d['field']}: golden {d['golden']} vs "
                         f"current {d['current']}")
        elif kind == "kernels":
            lines.append(f"  kernel {d['kernel']}: {d['field']} golden {d['golden']} vs "
                         f"current {d['current']}")
        else:
            lines.append(f"  {d}")
    return "\n".join(lines)
