"""Minimal liquid-style template rendering.

The reference renders its user prompts with ``python-liquid``
(``ragroute/llm_message.py:5,25-27``). The templates only use simple
substitutions (``{{context}}``, ``{{question}}``, ``{{options}}``,
``{{options[0]}}``), so a dependency-free renderer suffices and keeps the
rendered output byte-identical for those forms.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

_VAR_RE = re.compile(r"\{\{\s*([A-Za-z_][A-Za-z_0-9]*)(\[(\d+)\])?\s*\}\}")


def render(template: str, variables: Mapping[str, Any]) -> str:
    """Render ``{{name}}`` and ``{{name[i]}}`` placeholders."""

    def sub(m: re.Match) -> str:
        name, _, idx = m.groups()
        if name not in variables:
            return m.group(0)
        val = variables[name]
        if idx is not None:
            try:
                val = val[int(idx)]
            except (IndexError, KeyError, TypeError):
                return ""
        return str(val)

    return _VAR_RE.sub(sub, template)
