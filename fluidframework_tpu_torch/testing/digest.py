"""Canonical document-state digests for cross-implementation identity.

Copied from fluidframework_tpu/testing/digest.py, with `char_spans`
from fluidframework_tpu/testing/farm.py (:148). `normalize_spans`
reduces a (content, props) span list to maximal runs of identical
props; `state_digest` hashes that form, so the port's digests compare
directly with GOLDEN.json and the JAX engines. `char_spans` is the
character-wise form the summary service's `state_digest` hashes.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, List, Optional, Tuple


def normalize_spans(
    spans: List[Tuple[Any, Optional[dict]]]
) -> List[Tuple[str, Optional[dict]]]:
    """Merge adjacent spans with identical props; empty props == None.

    Content may be str or a list of items; everything is rendered to
    its text form (items joined) so engines that store codepoints and
    engines that store strings normalize identically.
    """
    out: List[Tuple[str, Optional[dict]]] = []
    for content, props in spans:
        if not isinstance(content, str):
            content = "".join(
                c if isinstance(c, str) else chr(c) for c in content
            )
        if not content:
            continue
        p = props or None
        if out and out[-1][1] == p:
            out[-1] = (out[-1][0] + content, p)
        else:
            out.append((content, p))
    return out


def state_digest(spans: List[Tuple[Any, Optional[dict]]]) -> str:
    """SHA-256 over the canonical span form."""
    norm = normalize_spans(spans)
    payload = json.dumps(
        [[t, p] for t, p in norm], sort_keys=True, ensure_ascii=True
    )
    return hashlib.sha256(payload.encode()).hexdigest()


def char_spans(annotated_spans):
    """Character-wise (char, props) stream from (content, props) spans:
    segment boundaries may legitimately differ across replicas;
    per-character state may not."""
    out = []
    for content, props in annotated_spans:
        norm = tuple(sorted(props.items())) if props else ()
        for ch in content:
            out.append((ch, norm))
    return out
