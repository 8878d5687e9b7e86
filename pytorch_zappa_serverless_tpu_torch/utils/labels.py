"""Class-label mapping: the JAX package's ``utils/labels.py``.

The reference ships an ImageNet class-index → name JSON and does
``labels[idx]`` after top-k.  Offline there is no canonical 1000-name list,
so: load a user-provided file when configured, else synthesize stable
placeholder names (``class_0007`` style), as transformers' random-init
configs fall back to ``LABEL_i``.
"""

from __future__ import annotations

import json
from pathlib import Path


def load_labels(path: str | Path | None, num_classes: int = 1000) -> list[str]:
    if path is not None:
        data = json.loads(Path(path).expanduser().read_text())
        if isinstance(data, dict):  # {"0": ["n01440764", "tench"], ...} or {"0": "tench"}
            out = []
            for i in range(len(data)):
                if str(i) not in data:
                    raise ValueError(f"labels file {path}: missing class index {i}")
                v = data[str(i)]
                out.append(v[-1] if isinstance(v, list) else str(v))
            return out
        return [str(v) for v in data]
    return [f"class_{i:04d}" for i in range(num_classes)]

