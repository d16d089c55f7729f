"""Rule ``swallow-except``: no silent exception swallowing in the port's
library modules (answers the JAX rule of the same name,
``mpi4dl_tpu/analysis/rules_swallow.py``; unchanged).

A resilience layer is only as honest as its error paths: a bare ``except:``
or an ``except Exception: pass`` hides the failures the guard, the watchdog
and the RunLog exist to surface, and a bare ``except:`` also eats
``KeyboardInterrupt``/``SystemExit`` (the preemption handler's clean exit).
Flagged:

- ``except:`` with no exception type, whatever its body;
- ``except Exception:`` / ``except BaseException:`` (alone or in a tuple)
  whose body is only ``pass`` / ``...``: a handler that logs, falls back or
  re-raises is deliberate and allowed.

Scope: package files.  A justified swallow carries ``# analysis:
ok(swallow-except)`` on the handler line.
"""

from __future__ import annotations

import ast
from typing import List

from mpi4dl_tpu_torch.analysis.core import Project, Rule, Violation

_BROAD = {"Exception", "BaseException"}


def _names_broad(src, node: ast.expr) -> bool:
    if isinstance(node, ast.Tuple):
        return any(_names_broad(src, elt) for elt in node.elts)
    resolved = src.resolve(node)
    return resolved in _BROAD or resolved in {f"builtins.{n}" for n in _BROAD}


def _body_only_swallows(body: List[ast.stmt]) -> bool:
    for stmt in body:
        if isinstance(stmt, ast.Pass):
            continue
        if (isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Constant)
                and stmt.value.value is Ellipsis):
            continue
        return False
    return True


class SwallowExceptRule(Rule):
    name = "swallow-except"
    description = (
        "bare `except:` or `except (Base)Exception: pass` in a mpi4dl_tpu_torch/ "
        "library module — name the exception types, or log/handle/re-raise "
        "(pragma: # analysis: ok(swallow-except))."
    )

    def check(self, project: Project) -> List[Violation]:
        out: List[Violation] = []
        for src in project.package_files():
            for node in src.nodes(ast.ExceptHandler):
                if node.type is None:
                    out.append(Violation(
                        self.name, src.rel, node.lineno,
                        "bare `except:` swallows KeyboardInterrupt/SystemExit too "
                        "— name the exception types",
                    ))
                elif _names_broad(src, node.type) and _body_only_swallows(node.body):
                    out.append(Violation(
                        self.name, src.rel, node.lineno,
                        "`except (Base)Exception` whose body only passes — silent "
                        "swallow; log, handle, or narrow the exception type",
                    ))
        return out


RULE = SwallowExceptRule()
