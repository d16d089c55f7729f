"""SARIF 2.1.0 output for the analyzer's findings (counterpart of
``mpi4dl_tpu/analysis/sarif.py``): the source gate's violations at their
lines, and the artifact gates' findings (``ircheck``, ``pallascheck``)
anchored at the file that owns them, rule ids ``<gate>/<kind>``.

Dependency-free and minimal: tool driver, rule index and results, the
subset GitHub code scanning ingests.  Schema:
https://json.schemastore.org/sarif-2.1.0.
"""

from __future__ import annotations

import json
from typing import Callable, Dict, List, Optional, Sequence, Tuple

_SCHEMA = "https://json.schemastore.org/sarif-2.1.0.json"


def _result(rule_id: str, message: str, uri: str, line: int,
            rule_index: Dict[str, int]) -> dict:
    if rule_id not in rule_index:
        rule_index[rule_id] = len(rule_index)
    return {
        "ruleId": rule_id,
        "ruleIndex": rule_index[rule_id],
        "level": "error",
        "message": {"text": message},
        "locations": [{
            "physicalLocation": {
                "artifactLocation": {"uri": uri, "uriBaseId": "%SRCROOT%"},
                "region": {"startLine": max(1, line)},
            },
        }],
    }


def finding_results(findings: Sequence, gate: str,
                    uri_of: Callable[[object], str]) -> List[Tuple[str, str, str, int]]:
    """``(rule id, message, uri, line)`` of artifact-gate findings (objects
    with ``kind`` and ``render()``), for :func:`sarif_log`'s ``extra``."""
    return [(f"{gate}/{f.kind}", f.render(), uri_of(f), 1) for f in findings]


def sarif_log(violations: Sequence = (),
              rule_descriptions: Optional[Dict[str, str]] = None,
              extra: Sequence[Tuple[str, str, str, int]] = ()) -> dict:
    """One SARIF log dict from analyzer ``Violation``s and ``extra``
    results (:func:`finding_results`)."""
    rule_index: Dict[str, int] = {}
    results: List[dict] = [_result(v.rule, v.message, v.path, v.line, rule_index)
                           for v in violations]
    results += [_result(rule, msg, uri, line, rule_index) for rule, msg, uri, line in extra]
    descriptions = rule_descriptions or {}
    rules = [
        {"id": rid, **({"shortDescription": {"text": descriptions[rid]}}
                       if rid in descriptions else {})}
        for rid, _ in sorted(rule_index.items(), key=lambda kv: kv[1])
    ]
    return {
        "$schema": _SCHEMA,
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "mpi4dl-tpu-torch-analysis",
                "informationUri": "https://github.com/OSU-Nowlab/MPI4DL",
                "rules": rules,
            }},
            "results": results,
        }],
    }


def write_sarif(path: str, log: dict) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(log, fh, indent=2, sort_keys=True)
        fh.write("\n")
