"""SARIF 2.1.0 output for the analyzer's findings (counterpart of
``mpi4dl_tpu/analysis/sarif.py``, without the artifact gates' anchors,
which come with the port's artifact checks).

Dependency-free and minimal: tool driver, rule index and results, the
subset GitHub code scanning ingests.  Schema:
https://json.schemastore.org/sarif-2.1.0.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

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


def sarif_log(violations: Sequence = (),
              rule_descriptions: Optional[Dict[str, str]] = None) -> dict:
    """One SARIF log dict from analyzer ``Violation``s."""
    rule_index: Dict[str, int] = {}
    results: List[dict] = [_result(v.rule, v.message, v.path, v.line, rule_index)
                           for v in violations]
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
